"""Multi-device dry run of the port's parallel paths, end to end at tiny widths.

The port's counterpart of the JAX package's ``dryrun_multichip``: over a mesh
that names one device ``n`` times (the card, ``cuda``, by default;
``--device cpu`` for the counterpart of the JAX package's virtual CPU
devices) it runs

- (a) the data-parallel contrastive step in two ``gloo`` processes, its loss
  held to the single-device step's (rtol 1e-5);
- (b) the row-sharded scan, every query finding its own row first;
- (b2-b4) the served mesh path: ``FusedEngine`` over a row-sharded f32x2
  index, with bf16 and int8 encoder trunks, and over a row-sharded int8r
  index (both planes sharded);
- (c) the 2-way tensor-parallel decoder forward, and (c2, e, f) the served
  TP decode: ``LocalChatProvider(tp_devices=2)`` through the batcher, with
  the paged pool and w8a8 weights, and with int4 weights.

Run: ``python -m outline_rag_tpu_torch.tools.dryrun_multichip --devices 4`` on the card,
``... --device cpu --devices 8`` on the CPU.

The process side is reusable: :func:`start_ranks` starts ``world`` processes
of this module, each running one :data:`RANK_TASKS` entry as a rank of a
``torch.distributed`` group over the backend it is given, and
:meth:`RankGroup.wait` returns what each printed as its last line (JSON).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

# --- the rank side: one process of a torch.distributed group ----------------


def contrastive_setup(cfg_name: str, batch: int, seq: int, seed: int, device):
    """The seeded encoder, optimizer and global batch of the data-parallel
    step (the same on every process and in the single-device reference)."""
    from outline_rag_tpu_torch.models import train as tt  # noqa: PLC0415
    from outline_rag_tpu_torch.models.convert import init_encoder  # noqa: PLC0415
    from outline_rag_tpu_torch.models.encoder import EncoderConfig  # noqa: PLC0415

    cfg = EncoderConfig.bge_m3(dtype=torch.float32) if cfg_name == "bge_m3" else EncoderConfig.tiny()
    dev = torch.device(device)
    model = init_encoder(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    g = torch.Generator().manual_seed(seed + 1)
    ids = {k: torch.randint(3, cfg.vocab_size, (batch, seq), generator=g) for k in ("q", "p")}
    data = {"q_ids": ids["q"], "p_ids": ids["p"],
            "q_mask": torch.ones(batch, seq, dtype=torch.int64),
            "p_mask": torch.ones(batch, seq, dtype=torch.int64)}
    data["p_mask"][1, seq // 2:] = 0  # one padded passage
    opt = tt.make_optimizer(lr=1e-5)
    return cfg, tt.init_train_state(model, opt), opt, {k: v.to(dev) for k, v in data.items()}


def dp_gradient_error(state, opt, want: dict) -> dict:
    """The gradient a first AdamW step applied, read back from its first
    moment (``(1 - b1) * g``), against the gradients ``want`` by name: the
    relative L2 error over all leaves, and the largest a leaf with its name.
    A gradient counted once per process, or averaged, is off by the world
    size here, where the step's update itself (``g / |g|`` at step 1) is
    blind to a scale. Leaves whose gradient is under 1e-6 of the whole's are
    listed apart (``grad_null_leaves``): the attention key biases, whose
    gradient is zero in exact arithmetic (softmax ignores a shift common to
    a query's logits), so what remains of it is rounding."""
    got = {n: m / (1.0 - opt.b1) for n, m in state.opt_state.mu.items()}
    err = sum(float((got[n].double() - want[n].double()).square().sum()) for n in want)
    ref = sum(float(want[n].double().square().sum()) for n in want)
    null = [n for n in want if float(want[n].double().norm()) < 1e-6 * ref ** 0.5]
    leaf = {n: float((got[n] - want[n]).norm() / want[n].norm()) for n in want if n not in null}
    worst = max(leaf, key=leaf.get)
    return {"grad_rel_err": (err / ref) ** 0.5, "grad_leaf_rel_err_max": leaf[worst],
            "grad_leaf_worst": worst, "grad_null_leaves": null}


def _task_dp(rank: int, world: int, args: dict) -> dict:
    """One rank's data-parallel contrastive step on its slice of the batch,
    its gradient held to the single-device gradient of the global batch."""
    from outline_rag_tpu_torch.models import train as tt  # noqa: PLC0415

    cfg, state, opt, batch = contrastive_setup(args["cfg"], args["batch"], args["seq"],
                                               args["seed"], args["device"])
    _, want = tt.value_and_grad(lambda m: tt.contrastive_loss(
        m, batch["q_ids"], batch["q_mask"], batch["p_ids"], batch["p_mask"]), state.params)
    per = args["batch"] // world
    local = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
    state, metrics = tt.make_dp_train_step(cfg, opt)(state, local)
    first = next(iter(state.params.parameters()))
    return {"loss": float(metrics["loss"]),
            "param_sum": float(first.detach().double().abs().sum()),
            **dp_gradient_error(state, opt, want)}


def demo_queries(n: int, dim: int, seed: int) -> np.ndarray:
    q = np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _task_demo(rank: int, world: int, args: dict) -> dict:
    """One rank's part of ``build_and_query_demo``."""
    from outline_rag_tpu_torch.parallel.multihost import build_and_query_demo  # noqa: PLC0415

    q = demo_queries(args["queries"], args["dim"], args["seed"] + 99)
    vals, idx = build_and_query_demo(args["rows"], args["dim"], q, args["k"], seed=args["seed"],
                                     devices=[args["device"]])
    return {"vals": vals.tolist(), "idx": idx.tolist()}


def _task_allreduce(rank: int, world: int, args: dict) -> dict:
    """An all-reduce of a tensor on ``device``: shows the backend starts."""
    import torch.distributed as dist  # noqa: PLC0415

    t = torch.full((4,), float(rank + 1), device=args["device"])
    dist.all_reduce(t)
    return {"sum": t.tolist(), "backend": dist.get_backend()}


RANK_TASKS = {"dp": _task_dp, "demo": _task_demo, "allreduce": _task_allreduce}


def _rank_main(argv: list[str]) -> int:
    from outline_rag_tpu_torch.parallel.multihost import init_multihost  # noqa: PLC0415

    task, coord, rank, world, backend, args = argv
    rank, world = int(rank), int(world)
    init_multihost(coord, world, rank, backend=backend)
    try:
        out = RANK_TASKS[task](rank, world, json.loads(args))
    finally:
        import torch.distributed as dist  # noqa: PLC0415

        dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class RankGroup:
    """``world`` processes of this module running one rank task each, as a
    ``torch.distributed`` group (see :func:`start_ranks`)."""

    def __init__(self, task: str, world: int, backend: str, args: dict):
        coord = f"127.0.0.1:{_free_port()}"
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.task = task
        self.procs = [
            subprocess.Popen(
                [sys.executable, "-m", "outline_rag_tpu_torch.tools.dryrun_multichip",
                 "--rank-task", task, coord, str(r), str(world), backend, json.dumps(args)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
            for r in range(world)
        ]

    def wait(self, timeout: float) -> list[dict]:
        """Each rank's result. Every process is waited for, and killed once
        ``timeout`` seconds have passed; a rank that fails raises
        ``RuntimeError`` with the output of all."""
        logs = []
        try:
            for p in self.procs:
                out, _ = p.communicate(timeout=timeout)
                logs.append(out.decode(errors="replace"))
        finally:
            self.kill()
        if any(p.returncode != 0 for p in self.procs):
            raise RuntimeError(f"{self.task} ranks failed:\n" + "\n---\n".join(logs))
        return [json.loads(log.strip().splitlines()[-1]) for log in logs]

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def start_ranks(task: str, world: int, backend: str, args: dict) -> RankGroup:
    """Start ``task`` as ``world`` processes of one group over ``backend``
    on this machine; :meth:`RankGroup.wait` collects them."""
    return RankGroup(task, world, backend, args)


# --- the dry run ---------------------------------------------------------------


class _Tok:
    eos_token_id = 0

    def encode(self, text):
        return [1 + (b % 250) for b in text.encode()][:32]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def _complete(provider, text: str) -> str:
    return asyncio.run(provider.complete("m", [{"role": "user", "content": text}],
                                         temperature=0.0))


def dryrun_multichip(n_devices: int, device: str = "cuda") -> str:
    from outline_rag_tpu_torch.engine import CrossEncoderReranker, EncoderEmbedder  # noqa: PLC0415
    from outline_rag_tpu_torch.engine.fused import FusedEngine  # noqa: PLC0415
    from outline_rag_tpu_torch.index import VectorIndex  # noqa: PLC0415
    from outline_rag_tpu_torch.models import decoder as dec  # noqa: PLC0415
    from outline_rag_tpu_torch.models import train as tt  # noqa: PLC0415
    from outline_rag_tpu_torch.models.convert import (  # noqa: PLC0415
        init_colbert_head,
        init_encoder,
        init_reranker,
        init_sparse_head,
    )
    from outline_rag_tpu_torch.models.tokenizer import HashTokenizer  # noqa: PLC0415
    from outline_rag_tpu_torch.parallel import data_mesh, row_sharding  # noqa: PLC0415
    from outline_rag_tpu_torch.parallel.query import sharded_topk  # noqa: PLC0415
    from outline_rag_tpu_torch.parallel.tp import (  # noqa: PLC0415
        model_mesh,
        shard_decoder_cache,
        shard_decoder_params,
    )
    from outline_rag_tpu_torch.serve.llm import LocalChatProvider  # noqa: PLC0415

    dev = torch.device(device)
    mesh = data_mesh(devices=[dev] * n_devices)

    # (a) the data-parallel step in two processes against one device
    dp_args = dict(cfg="tiny", batch=2 * n_devices, seq=32, seed=0, device=device)
    ranks = start_ranks("dp", 2, "gloo", dp_args).wait(timeout=600)
    cfg, state, opt, batch = contrastive_setup("tiny", dp_args["batch"], 32, 0, device)
    _, single = tt.make_train_step(cfg, opt)(state, batch)
    loss = ranks[0]["loss"]
    assert ranks[0] == ranks[1], ranks
    assert abs(loss - float(single["loss"])) <= 1e-5 * abs(float(single["loss"])), (ranks, single)
    assert ranks[0]["grad_rel_err"] <= 1e-5, ranks  # the one loss's gradient, counted once

    # (b) the row-sharded scan
    g = torch.Generator(device=dev).manual_seed(0)
    corpus = torch.randn((n_devices * 128, cfg.hidden), generator=g, device=dev)
    corpus = corpus / corpus.norm(dim=1, keepdim=True)
    _, idx = sharded_topk(corpus[:4], corpus, 8, mesh=mesh)
    assert idx[:, 0].tolist() == [0, 1, 2, 3], "self-match failed"

    # (b2-b4) the served mesh path
    enc = init_encoder(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    init_colbert_head(init_sparse_head(enc, torch.Generator(device=dev).manual_seed(2)),
                      torch.Generator(device=dev).manual_seed(3))
    rr_model = init_reranker(cfg, torch.Generator(device=dev).manual_seed(4), dev)
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    emb = EncoderEmbedder(enc, tok, max_tokens=32, seq_buckets=(32,))
    rr = CrossEncoderReranker(rr_model, tok, max_tokens=64)
    texts = [f"document {i} about topic {i % 7}" for i in range(64)]
    tb = tok.batch(texts, 32, buckets=(32,))
    served = {}
    for dtype in ("f32x2", "int8r"):
        index = VectorIndex(dim=cfg.hidden, capacity=n_devices * 128, token_width=32,
                            dtype=dtype, sharding=row_sharding(mesh))
        index.add_chunks([f"c{i}" for i in range(64)], emb.embed(texts), source_id="dryrun",
                         token_ids=tb.input_ids, token_mask=tb.attention_mask)
        assert index.mesh is not None and index.mesh.size == n_devices
        rows = FusedEngine(emb, rr, index, top_k=8, rerank_k=3).query(
            ["topic 3 document", "topic 5 document"])
        assert len(rows) == 2 and all(rows), rows
        served[dtype] = index
    emb8 = EncoderEmbedder(init_encoder(cfg, torch.Generator(device=dev).manual_seed(1), dev),
                           tok, max_tokens=32, seq_buckets=(32,), int8=True)
    rr8 = CrossEncoderReranker(init_reranker(cfg, torch.Generator(device=dev).manual_seed(4), dev),
                               tok, max_tokens=64, int8=True)
    rows8 = FusedEngine(emb8, rr8, served["f32x2"], top_k=8, rerank_k=3).query(["topic 3"])
    assert len(rows8) == 1 and rows8[0], rows8

    # (c) the tensor-parallel decoder forward: the tiny decoder's widths but
    # a head of 64, which the paged kernels take on the card
    dcfg = dec.DecoderConfig(vocab_size=256, hidden=256, layers=2, heads=4, kv_heads=2,
                             intermediate=512, max_cache=64, dtype=torch.float32)
    tmesh = model_mesh(2, [dev, dev])
    dparams = dec.init_decoder(dcfg, torch.Generator(device=dev).manual_seed(7), dev)
    toks = torch.randint(0, dcfg.vocab_size, (1, 7), generator=torch.Generator().manual_seed(1))
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        logits, _ = dec.decoder_forward(
            shard_decoder_params(dparams, tmesh, dcfg), toks.to(dev),
            shard_decoder_cache(dec.init_cache(dcfg, 1, dev), tmesh), zero, dcfg)
    assert torch.isfinite(logits).all(), "TP decoder produced non-finite logits"

    # (c2, e, f) the served TP decode
    for label, kw in (("batched", dict(batch_slots=2)),
                      ("paged_int8", dict(batch_slots=2, int8_weights=True, kv_pages=12,
                                          page_size=16)),
                      ("int4", dict(int4_weights=True))):
        prov = LocalChatProvider(dparams, dcfg, _Tok(), chunk_tokens=4, max_new_tokens=6,
                                 tp_devices=2, device=dev, devices=[dev, dev], **kw)
        try:
            assert _complete(prov, f"tp {label}"), f"TP {label} served nothing"
        finally:
            prov.close()
    return (
        f"dryrun_multichip ok: {n_devices} entries of {dev}, dp train loss {loss:.4f} "
        f"(2 gloo processes, equal to one device's), sharded top-k verified, mesh fused query "
        f"served (f32 and int8 trunks, f32x2 and int8r indexes), 2-way TP decoder forward, "
        f"TP batched, TP x paged x w8a8 and TP x int4 served"
    )


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--rank-task":
        return _rank_main(argv[1:])
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, default=8, help="mesh entries")
    parser.add_argument("--device", default="cuda", help="the device the entries name")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(dryrun_multichip(args.devices, args.device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
