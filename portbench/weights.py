"""Seeded weights and data, drawn on the device from the run's seed.

Weights come in the published Hugging Face layout: one draw a model, in the
type the model is served in, cut into views by a fixed layout. The program
gets them through its own loaders; the reference draws them again after the
window from the same seed, so it never reads what the program holds.

Index rows and token rows come in blocks, each from a generator of its own,
so the reference can draw any block again without the rest.
"""

from __future__ import annotations

import hashlib

import torch

STD = 0.02  # weights, embeddings and biases ~ N(0, STD); norm scales 1 + N(0, STD)


def sub_seed(seed: int, *labels) -> int:
    """A 63-bit seed for one use of the run's seed (weights, a block of rows)."""
    h = hashlib.blake2b(repr((int(seed),) + labels).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") >> 1


def generator(device, seed: int, *labels) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *labels))


def xlmr_layout(cfg: dict, classifier: bool) -> list[tuple[str, tuple, bool]]:
    """``(name, shape, is_norm_scale)`` of an XLM-RoBERTa trunk (BGE-m3,
    bge-reranker-v2-m3), with the sequence-classification head when
    ``classifier``."""
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    out = [
        ("embeddings.word_embeddings.weight", (cfg["vocab_size"], h), False),
        ("embeddings.position_embeddings.weight", (cfg["max_position_embeddings"], h), False),
        ("embeddings.token_type_embeddings.weight", (cfg["type_vocab_size"], h), False),
        ("embeddings.LayerNorm.weight", (h,), True),
        ("embeddings.LayerNorm.bias", (h,), False),
    ]
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name, shape in (("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)), ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (f, h)), ("output.dense", (h, f))):
            out += [(p + name + ".weight", shape, False), (p + name + ".bias", shape[:1], False)]
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            out += [(p + name + ".weight", (h,), True), (p + name + ".bias", (h,), False)]
    if classifier:
        out += [("classifier.dense.weight", (h, h), False), ("classifier.dense.bias", (h,), False),
                ("classifier.out_proj.weight", (1, h), False),
                ("classifier.out_proj.bias", (1,), False)]
    return out


def draw(layout, device, dtype: torch.dtype, seed: int, label: str) -> dict[str, torch.Tensor]:
    """A state dict of views into one ``dtype`` buffer drawn at once: every
    leaf ~ N(0, STD), norm scales then moved to 1 + N(0, STD) in one more
    call (they sit together at the end of the buffer)."""
    leaves = [x for x in layout if not x[2]] + [x for x in layout if x[2]]
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in leaves]
    buf = torch.randn(sum(sizes), generator=generator(device, seed, "weights", label),
                      device=device, dtype=dtype)
    buf.mul_(STD)
    n_plain = sum(s for (_, _, norm), s in zip(leaves, sizes) if not norm)
    buf[n_plain:].add_(1.0)
    out, at = {}, 0
    for (name, shape, _), n in zip(leaves, sizes):
        out[name] = buf[at : at + n].view(shape)
        at += n
    return out


def common_direction(sd: dict, cfg: dict, seed: int, device, width: int) -> torch.Tensor:
    """The direction a seeded, untrained encoder gives every question: the
    mean of the reference's unit embeddings of 32 questions drawn from the
    seed, unit length, f32 [hidden]. Such an encoder puts ~95% of every
    query's length along it (a trained one does not), so without taking it
    out of the index's rows every ask would retrieve from the same few dozen
    rows."""
    import numpy as np

    from portbench.reference import xlmr
    from portbench.words import draw_words

    rng = np.random.default_rng(sub_seed(seed, "probe"))
    probes = [draw_words(rng, int(rng.integers(6, 31)), 0, 250_000) for _ in range(32)]
    with torch.inference_mode():
        e = xlmr.embed(sd, cfg, xlmr.query_rows(probes, cfg["vocab_size"], width, device))
        c = e.mean(dim=0)
        return c / c.norm()


def block_rows(device, seed: int, block: int, n: int, dim: int, token_width: int,
               vocab: int, away: torch.Tensor | None = None, cls_id: int = 0, pad_id: int = 1):
    """Block ``block`` of the index: ``n`` Gaussian f32 vectors [n, dim] (the
    index normalizes them), with their component along the unit vector
    ``away`` taken out, and CLS-first token rows of 8 to ``token_width`` ids,
    padded with ``pad_id`` ([n, token_width] int32 ids and mask)."""
    g = generator(device, seed, "rows", block)
    vecs = torch.randn((n, dim), generator=g, device=device, dtype=torch.float32)
    if away is not None:
        vecs -= (vecs @ away)[:, None] * away[None, :]
    lengths = torch.randint(8, token_width + 1, (n, 1), generator=g, device=device)
    mask = torch.arange(token_width, device=device)[None, :] < lengths
    ids = torch.randint(3, vocab, (n, token_width), generator=g, device=device, dtype=torch.int32)
    ids = torch.where(mask, ids, torch.full_like(ids, pad_id))
    ids[:, 0] = cls_id
    return vecs, ids, mask.to(torch.int32)
