"""XLM-RoBERTa in plain PyTorch, float32 with TF32 off: BGE-m3's dense
embedding and bge-reranker-v2-m3's relevance score.

Written from the published architecture (``XLMRobertaModel`` and
``XLMRobertaForSequenceClassification``), over a state dict in the Hugging
Face layout. Departures: no dropout (inference), no pooler (BGE-m3 pools the
CLS hidden state itself), masked positions get -1e9 before the softmax, and
the position ids come from the attention mask (``cumsum(mask) * mask +
pad``), which equals the published rule on these inputs since padding is the
only place the pad id appears.

It also holds the query tokenization the benchmark's index was queried with:
a copy of the stand-in hash tokenizer's rule (sha1 of each word, CLS first,
EOS last, padded to the query width), written out again so the reference
reads no tokens the program made.
"""

from __future__ import annotations

import hashlib
import math

import torch
import torch.nn.functional as F

CLS, PAD, EOS = 0, 1, 2


def hash_tokens(text: str, vocab: int, width: int) -> list[int]:
    """CLS, one id a word (3 + the first four bytes of its sha1, big-endian,
    modulo ``vocab - 3``) up to ``width - 2`` words, EOS."""
    ids = [CLS]
    for w in text.split()[: width - 2]:
        h = int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "big")
        ids.append(3 + h % (vocab - 3))
    return ids + [EOS]


def query_rows(texts: list[str], vocab: int, width: int, device) -> torch.Tensor:
    """``[B, width]`` query token rows, padded with PAD."""
    out = torch.full((len(texts), width), PAD, dtype=torch.long)
    for i, t in enumerate(texts):
        ids = hash_tokens(t, vocab, width)
        out[i, : len(ids)] = torch.tensor(ids)
    return out.to(device)


def _f32(sd, name):
    return sd[name].float()


def _ln(x, sd, name, eps):
    return F.layer_norm(x, x.shape[-1:], _f32(sd, name + ".weight"), _f32(sd, name + ".bias"), eps)


def _dense(x, sd, name):
    return F.linear(x, _f32(sd, name + ".weight"), _f32(sd, name + ".bias"))


def hidden_states(sd: dict, cfg: dict, ids: torch.Tensor, prefix: str = "") -> torch.Tensor:
    """The last hidden states ``[B, S, H]`` f32 of ``ids`` ``[B, S]``."""
    with _no_tf32():
        eps = cfg["layer_norm_eps"]
        heads = cfg["num_attention_heads"]
        b, s = ids.shape
        mask = ids != PAD
        pos = torch.cumsum(mask, dim=1) * mask + PAD
        p = prefix + "embeddings."
        x = (_f32(sd, p + "word_embeddings.weight")[ids]
             + _f32(sd, p + "position_embeddings.weight")[pos]
             + _f32(sd, p + "token_type_embeddings.weight")[0])
        x = _ln(x, sd, p + "LayerNorm", eps)
        bias = torch.where(mask, 0.0, -1e9)[:, None, None, :]
        hd = x.shape[-1] // heads
        for i in range(cfg["num_hidden_layers"]):
            p = f"{prefix}encoder.layer.{i}."

            def split(t):
                return t.reshape(b, s, heads, hd).transpose(1, 2)

            q = split(_dense(x, sd, p + "attention.self.query"))
            k = split(_dense(x, sd, p + "attention.self.key"))
            v = split(_dense(x, sd, p + "attention.self.value"))
            att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd) + bias, dim=-1)
            ctx = (att @ v).transpose(1, 2).reshape(b, s, -1)
            x = _ln(x + _dense(ctx, sd, p + "attention.output.dense"), sd,
                    p + "attention.output.LayerNorm", eps)
            mid = F.gelu(_dense(x, sd, p + "intermediate.dense"))
            x = _ln(x + _dense(mid, sd, p + "output.dense"), sd, p + "output.LayerNorm", eps)
        return x


class _no_tf32:
    """TF32 off for the reference's matrix products, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def embed(sd: dict, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    """BGE-m3's dense embedding: the CLS hidden state, unit length, f32."""
    cls = hidden_states(sd, cfg, ids)[:, 0]
    return cls / cls.norm(dim=-1, keepdim=True).clamp_min(1e-9)


def rerank(sd: dict, cfg: dict, ids: torch.Tensor, block: int = 64) -> torch.Tensor:
    """bge-reranker-v2-m3's relevance logit of each pair row ``[B, S]``, in
    blocks of ``block`` rows."""
    out = []
    for s in range(0, ids.shape[0], block):
        cls = hidden_states(sd, cfg, ids[s : s + block])[:, 0]
        with _no_tf32():
            h = torch.tanh(_dense(cls, sd, "classifier.dense"))
            out.append(_dense(h, sd, "classifier.out_proj")[:, 0])
    return torch.cat(out) if out else torch.zeros(0, device=ids.device)
