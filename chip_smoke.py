#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``outline_rag_tpu_torch``) once on an NVIDIA
GPU and check it.

    python3 chip_smoke.py [--seed N]

Run it from the root of a checkout, on a machine with one CUDA card and
``nvcc``. It imports no jax and nothing of the JAX package. Phases, each
printing one JSON line; any failure raises and the exit code is non-zero:

1. env     torch / CUDA versions, the card, its power limit, TF32 flags.
2. build   compile ``outline_rag_tpu_torch/csrc/*.cu`` with nvcc (sm_90a).
3. kernel  ``topk_int8`` (the CUDA kernel) against ``topk_int8_plain`` on
           the card over a seeded 1,048,576 x 1024 int8 corpus (1% rows
           tombstoned, duplicated rows to force ties) at B in {1, 32, 128}
           and K in {12, 64}, plus a case with fewer live rows than K.
           Indices must be equal and values within 1e-6 (bit-equal is the
           expectation). Median of 10 CUDA-event timings of both at
           B = 32 and 128, K = 64.
4. slice   the serving path at bge-m3 width: seeded random bge-m3 encoder
           and bge-reranker-v2-m3 cross-encoder in bf16, the hash
           tokenizer, an int8r VectorIndex of capacity 1,048,576 x 1024
           with a 64-wide token cache; 4,096 text chunks embedded by the
           port's encoder, seeded unit vectors up to 1,000,000 live rows,
           then one source deleted. 64 concurrent requests go through
           ``QueryBatcher(RetrievalService(...).retrieve_batch)``: every
           answer has 3 distinct live chunks, the fused path served them,
           and the kernel's launch count grew. For one batch, the fused
           query's retrieval top-12 equals the plain path's on the same
           query embeddings, and its recall@12 against an exact fp32 top-12
           over the f32 corpus (kept on the card) is at least 0.99.

The last lines are the kernel summary, the card's name and power limit as
``nvidia-smi`` prints them, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import subprocess
import sys
import time

N_ROWS, DIM, CAPACITY = 1_048_576, 1024, 1_048_576
LIVE_ROWS, TEXT_CHUNKS, BLOCK = 1_000_000, 4096, 4096
TOKEN_WIDTH, TOP_K, RERANK_K, CANDIDATES = 64, 12, 3, 64
REQUESTS, MAX_BATCH = 64, 32
VALUE_TOL, RECALL_MIN = 1e-6, 0.99


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_ms(torch, fn, runs: int = 10) -> float:
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event timings,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_phase(torch, dev, seed: int) -> dict:
    from outline_rag_tpu_torch.ops.topk import NEG, topk_int8, topk_int8_plain

    g = torch.Generator(device=dev).manual_seed(seed)
    corpus = torch.randint(-127, 128, (N_ROWS, DIM), generator=g, device=dev, dtype=torch.int8)
    cscale = (torch.rand(N_ROWS, generator=g, device=dev) + 0.5) / 127
    penalty = torch.where(torch.rand(N_ROWS, generator=g, device=dev) < 0.01, NEG, 0.0).float()
    # 12 copies of one row: query 0 is that row, so 13 rows tie at its top
    src = int(torch.randint(0, N_ROWS, (1,), generator=g, device=dev))
    dups = torch.randperm(N_ROWS, generator=g, device=dev)[:12]
    dups = dups[dups != src]
    corpus[dups] = corpus[src].clone()
    cscale[dups] = cscale[src].clone()
    penalty[dups] = 0.0
    penalty[src] = 0.0
    tied = sorted({src, *dups.tolist()})
    few_live = torch.full((N_ROWS,), NEG, device=dev)
    few_live[torch.randperm(N_ROWS, generator=g, device=dev)[:10]] = 0.0

    cases = [(b, k, penalty) for b in (1, 32, 128) for k in (12, 64)]
    cases.append((32, 64, few_live))
    results, max_err = [], 0.0
    for b, k, pen in cases:
        q = torch.randint(-127, 128, (b, DIM), generator=g, device=dev, dtype=torch.int8)
        q[0] = corpus[src].clone()
        qscale = (torch.rand(b, generator=g, device=dev) + 0.5) / 127
        args = (q, qscale, corpus, cscale, k, pen)
        vals, idx = topk_int8(*args)
        torch.cuda.synchronize()
        pv, pi = topk_int8_plain(*args)
        err = float((vals - pv).abs().max())
        max_err = max(max_err, err)
        row = {
            "B": b, "K": k, "live": int((pen == 0).sum()),
            "idx_equal": bool(torch.equal(idx, pi)),
            "bit_equal": bool(torch.equal(vals, pv)), "max_abs_err": err,
        }
        require(row["idx_equal"], f"kernel indices equal the plain version's at {row}")
        require(err <= VALUE_TOL, f"kernel values within {VALUE_TOL} at {row}")
        if pen is penalty:
            head = min(k, len(tied))
            require(idx[0, :head].tolist() == tied[:head], "tied rows come lowest first")
        else:
            require(bool((idx[:, 10:] == 0).all() and (vals[:, 10:] == NEG).all()),
                    "slots past the 10 live rows are (NEG, 0)")
        if k == 64 and b in (32, 128) and pen is penalty:
            row["ms"] = cuda_ms(torch, lambda: topk_int8(*args))
            row["plain_ms"] = cuda_ms(torch, lambda: topk_int8_plain(*args))
        results.append(row)
        emit("kernel", **row)
    timed = {r["B"]: r for r in results if "ms" in r}
    return {"max_abs_err": max_err, "ms": timed[32]["ms"], "plain_ms": timed[32]["plain_ms"]}


def make_texts(rng, n: int, vocab: list[str]) -> list[str]:
    return [" ".join(rng.choice(vocab, size=int(rng.integers(20, 60)))) for _ in range(n)]


def slice_phase(torch, dev, seed: int) -> int:
    import numpy as np

    from outline_rag_tpu_torch.engine import (
        CrossEncoderReranker,
        EncoderEmbedder,
        QueryBatcher,
        RetrievalService,
        fused_query,
    )
    from outline_rag_tpu_torch.index import VectorIndex
    from outline_rag_tpu_torch.index.store import normalize_rows
    from outline_rag_tpu_torch.models import (
        EncoderConfig,
        init_encoder,
        init_reranker,
        pooled_embeddings,
    )
    from outline_rag_tpu_torch.models.tokenizer import HashTokenizer
    from outline_rag_tpu_torch.ops.quant import quantize_rows_int8, rescore_candidates
    from outline_rag_tpu_torch.ops.topk import topk_int8, topk_int8_plain, topk_plain

    t0 = time.perf_counter()
    cfg = EncoderConfig.bge_m3()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    encoder = init_encoder(cfg, gen, dev)
    reranker = init_reranker(cfg, gen, dev)
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    embedder = EncoderEmbedder(encoder, tok)
    cross = CrossEncoderReranker(reranker, tok)
    index = VectorIndex(
        dim=DIM, capacity=CAPACITY, dtype="int8r", device=dev, token_width=TOKEN_WIDTH
    )
    oracle = torch.zeros((CAPACITY, DIM), dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # ingest 1: text chunks through the port's encoder, 64 per source
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in rng.permutation(20_000)[:5000]]
    texts = make_texts(rng, TEXT_CHUNKS, vocab)
    t0 = time.perf_counter()
    vecs = embedder.embed(texts)
    embed_s = time.perf_counter() - t0
    require(vecs.shape == (TEXT_CHUNKS, DIM) and bool(np.isfinite(vecs).all()), "finite embeddings")
    t0 = time.perf_counter()
    for s in range(0, TEXT_CHUNKS, 64):
        tb = tok.batch(texts[s : s + 64], TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
        rows = index.add_chunks(
            [f"text{s // 64}:{i}" for i in range(64)], vecs[s : s + 64], f"text{s // 64}",
            token_ids=tb.input_ids, token_mask=tb.attention_mask,
        )
        oracle[torch.as_tensor(rows, device=dev)] = normalize_rows(
            torch.as_tensor(vecs[s : s + 64], device=dev)
        )
    # ingest 2: seeded unit vectors with random token rows, in blocks
    positions = torch.arange(TOKEN_WIDTH, device=dev)
    n_src = 0
    while index.size < LIVE_ROWS:
        n = min(BLOCK, LIVE_ROWS - index.size)
        v = torch.randn((n, DIM), generator=gen, device=dev)
        lengths = torch.randint(8, TOKEN_WIDTH + 1, (n, 1), generator=gen, device=dev)
        mask = (positions[None, :] < lengths).to(torch.int32)
        ids = torch.randint(3, cfg.vocab_size, (n, TOKEN_WIDTH), generator=gen, device=dev,
                            dtype=torch.int32)
        ids = torch.where(mask.bool(), ids, tok.pad_id)
        ids[:, 0] = tok.cls_id
        rows = index.add_chunks(
            [f"rand{n_src}:{i}" for i in range(n)], v, f"rand{n_src}",
            token_ids=ids, token_mask=mask,
        )
        oracle[torch.as_tensor(rows, device=dev)] = normalize_rows(v)
        n_src += 1
    deleted_text = index.delete_source("text7")
    gone = n_src // 2  # a full block from the middle of the index
    deleted_rand = index.delete_source(f"rand{gone}")
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    require(deleted_text == 64 and deleted_rand == BLOCK, "delete_source removed whole sources")
    require(index.size == LIVE_ROWS - 64 - BLOCK, f"live rows {index.size}")
    emit("ingest", setup_s=setup_s, embed_s=embed_s, ingest_s=ingest_s, live_rows=index.size,
         capacity=CAPACITY, text_chunks=TEXT_CHUNKS, sources=n_src + TEXT_CHUNKS // 64,
         device_mem_gb=torch.cuda.memory_allocated(dev) / 1e9)

    # requests: phrases cut from text chunks (the deleted source's too)
    picks = rng.integers(0, TEXT_CHUNKS, REQUESTS)
    queries = [" ".join(texts[j].split()[3:15]) for j in picks]
    service = RetrievalService(index, embedder, cross, top_k=TOP_K, rerank_k=RERANK_K)
    require(service.fused, "the service runs the fused path")

    async def serve(batch: list[str]):
        batcher = QueryBatcher(service.retrieve_batch, max_batch=MAX_BATCH)

        async def one(q):
            t = time.perf_counter()
            res = await batcher.retrieve(q)
            return res, time.perf_counter() - t

        try:
            t = time.perf_counter()
            out = await asyncio.gather(*(one(q) for q in batch))
            return out, time.perf_counter() - t
        finally:
            await batcher.stop()

    asyncio.run(serve(queries[:MAX_BATCH]))  # warm-up: cuBLAS handles, allocator
    topk_int8.launches = 0
    answers, wall_s = asyncio.run(serve(queries))
    launches = topk_int8.launches
    require(launches > 0, "the main path launched the topk_int8 kernel")
    deleted = {f"text7:{i}" for i in range(64)} | {f"rand{gone}:{i}" for i in range(BLOCK)}
    for res, _ in answers:
        ids = [c.chunk_id for c in res]
        require(len(ids) == RERANK_K, f"{RERANK_K} chunks per answer, got {ids}")
        require(len(set(ids)) == len(ids), f"no duplicate ids in {ids}")
        require(not deleted & set(ids), f"no deleted ids in {ids}")
        require(all(np.isfinite([c.score, c.rerank_score]).all() for c in res), "finite scores")
    lat = sorted(t for _, t in answers)
    emit("serve", requests=REQUESTS, max_batch=MAX_BATCH, p50_ms=1e3 * lat[len(lat) // 2],
         p95_ms=1e3 * lat[min(len(lat) - 1, int(0.95 * len(lat)))],
         answers_per_s=REQUESTS / wall_s, wall_s=wall_s, topk_int8_launches=launches)

    # the retrieval stage of one batch, against the plain path and fp32
    tb = tok.batch(queries[:MAX_BATCH], TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
    q_ids = torch.as_tensor(tb.input_ids, device=dev)
    q_mask = torch.as_tensor(tb.attention_mask, device=dev)
    with torch.inference_mode():
        state, _ = index.snapshot()
        tokens = index.tokens.state
        _, _, _, idx, vals = fused_query(
            encoder, reranker, q_ids, q_mask, state.vectors, state.scales, state.penalty,
            tokens.ids, tokens.mask, state.residual, top_k=TOP_K, rerank_k=RERANK_K,
        )
        q_emb = pooled_embeddings(encoder, q_ids, q_mask)
        qq, qs = quantize_rows_int8(q_emb)
        cand = topk_int8_plain(qq, qs, state.vectors, state.scales, CANDIDATES, state.penalty)
        pv, pi = rescore_candidates(
            q_emb, *cand, state.vectors, state.scales, TOP_K, state.penalty, state.residual
        )
        # exact fp32 top-13: the top-12 and how far the 13th trails it
        ov, oi = topk_plain(q_emb, oracle, TOP_K + 1, state.penalty)
    require(torch.equal(idx, pi), "fused top-12 equals the plain path's")
    err = float((vals - pv).abs().max())
    require(err <= VALUE_TOL, f"fused top-12 values within {VALUE_TOL} of the plain path's")
    hits = [len(set(a) & set(b[:TOP_K])) for a, b in zip(idx.tolist(), oi.tolist())]
    recall = sum(hits) / (TOP_K * len(hits))
    emit("retrieval", batch=len(hits), recall_at_12=recall, max_abs_err_vs_plain=err,
         min_oracle_gap_12_13=float((ov[:, TOP_K - 1] - ov[:, TOP_K]).min()),
         min_oracle_gap_1_12=float((ov[:, :TOP_K - 1] - ov[:, 1:TOP_K]).min()))
    require(recall >= RECALL_MIN, f"recall@12 {recall} >= {RECALL_MIN}")
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from outline_rag_tpu_torch.device import resolve_device
    from outline_rag_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    smi = nvidia_smi()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(dev),
         device_count=torch.cuda.device_count(), nvidia_smi=smi,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    built = _build.build_library()
    ptxas = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]
    emit("build", seconds=built.seconds, library=built.path.name, ptxas=ptxas)

    kernel = kernel_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()
    launches = slice_phase(torch, dev, args.seed)

    print(json.dumps({"kernels": [{
        "name": "topk_int8", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/topk_int8.cu",
        "replaces": "outline_rag_tpu/ops/topk.py:346",
        "launches": launches, "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
