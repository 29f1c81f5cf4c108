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
           Values and indices must be bit-equal (the scan's contract).
           Median of 10 CUDA-event timings of both at B = 32 and 128,
           K = 64 (the kernel also over many launches, ``device_ms``), of
           the kernel at B = 32, K = 12, and at B = 32, K = 64 of
           a library pair as a yardstick: ``torch._int_mm`` of the codes
           against the corpus's transpose, then the scales, the penalty and
           ``torch.topk`` (no order among ties: not the same function).
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
           over the f32 corpus (kept on the card) is at least 0.99; and
           ``fused_query``'s stages for that batch (encode, scan: quantize,
           ``topk_int8`` at K = 64 and the rescore, gather + rerank).
4b. lifecycle  continues on the slice's index, service and models. Delta
           updates: whole seeded sources re-added under the same chunk ids
           (``replace=True``, 4,096 rows each) until an add finds no free row
           and the index compacts at 1,048,576 (generation higher, cursor ==
           live rows). Growth: new sources until an add does not fit; the
           index grows to 2,097,152, and the peak of
           ``torch.cuda.max_memory_allocated`` over that add must stay below
           what was allocated before it plus the new index's bytes (the old
           planes are freed first). Snapshot: ``save`` to a temporary
           directory, ``VectorIndex.load``, ``adopt`` into the served index,
           files deleted. After each step a burst of 64 concurrent requests
           through the same service: answers checked against the deleted
           chunks, ``topk_int8`` launched, one batch's fused top-12 equal to
           the plain path's (values within 1e-6) with every row its chunk's
           current row, and recall@12 >= 0.99 against an fp32 oracle keyed by
           chunk id. Seconds of each step, live rows, capacity, generation,
           the snapshot's bytes, and the scan's ``scan_ms`` / ``kernel_ms`` at
           2,097,152 rows.
4c. http   a whole local RAG turn through the port's HTTP app over a
           socket, after ``lifecycle``, with the slice's bge-m3 encoder and
           cross-encoder: a fresh int8r index of capacity 1,048,576 x 1024
           (64-wide token cache) holding 996,352 seeded rows in documents of
           1,024 chunks, every row resolving to a chunk and a document in a
           sqlite meta store on disk (written through ``upsert_document`` /
           ``replace_chunks``); ``build_app`` with the JAX defaults
           (``TOP_K`` 12, ``RERANK_K`` 3, ``QUERY_BATCH_MAX`` 32,
           ``CHUNK_SIZE`` 1024) and ``LocalChatProvider`` at TinyLlama-1.1B
           width (bf16, 64 slots, 1,025 pages of 128, chunks of 16, 64 new
           tokens, ``ByteTokenizer``) behind a stand-in that classifies every
           ask as Query (a random-weight decoder writes no JSON; the stand-in
           is the one part that is not the port's code); ``serve()`` on
           127.0.0.1 on a thread with its own event loop. 24 documents of
           1,100-8,000 words come in through Outline sync (a stdlib fake wiki
           on 127.0.0.1 that also lists the seeded documents; ``POST
           /chat/update/all``, the task worker): their chunks are indexed and
           stored, and /healthz's ``index_size`` grows by exactly their count.
           Then 64 clients on threads (stdlib ``http.client``) each log in,
           open a conversation, ``POST /chat/api/ask`` at once and read the
           SSE stream to ``[DONE]``; half the questions come from the new
           documents. Every stream parses and has a content frame; each
           answer's sources equal the app's own ``RetrievalService`` called
           directly on the batches the batcher formed, mapped to documents as
           ``retrieve_docs`` maps them; ``topk_int8`` launched at least once a
           batch, ``paged_attention`` and ``paged_kv_write`` launched;
           ``/chat/api/metrics`` has the stage timings and the decoder's
           stats. Printed: time to the first content frame and to ``[DONE]``
           (p50 / p95), asks/s, streamed tokens/s, batches and their mean
           size, each kernel's launches, prefix hits, backpressure waits, the
           index and meta-store fill times, peak device memory, and the slice
           phase's in-process burst p50.
5. kernel_float  ``topk_float`` (the CUDA kernel) against
           ``topk_float_plain`` for each of its modes (fp32, bf16, f32x2),
           each over a seeded 1,048,576 x 1024 corpus of unit rows in that
           mode's storage (4 GiB, 2 GiB, 4 GiB; one at a time), 1% rows
           tombstoned and 12 copies of one row, at B in {1, 32, 128} and K
           in {12, 64}, plus a case with fewer live rows than K. Values
           within 1e-5 and rows equal wherever the twin's neighbouring
           values are further apart (the sums run in another order); the
           copies tie exactly and come lowest row first. Median of 10
           CUDA-event timings of both at B = 32 and 128, K = 64, TF32 off,
           and at B = 32 (fp32, bf16) of a library pair as a yardstick:
           ``q @ corpus.T + penalty`` then ``torch.topk`` (two calls, and no
           order among ties: not the same function).
           Then a 65,536-row ``VectorIndex`` of the dtype that scans in the
           mode (float32, bfloat16, f32x2) answers a query through the
           kernel.
6. flash   ``flash_attention`` (the CUDA kernel) against
           ``flash_attention_plain`` in bf16 at H = 16, D = 64: S in
           {2048, 4096, 8192} at B = 1, and a B = 2 batch at S = 4096
           holding a 3,000-token document and an all-padding row (exactly
           zero). Every element within 2e-3 + 2 bf16 ulps of the twin's
           (P is rounded against a running max over key tiles in the
           kernel, the row max in the twin) and the error's norm within
           1e-2 of the output's; a dropped key tile or a missing rescale
           fails both. Also S = 2048 + 37 (no multiple of a tile), a bias
           that is no prefix (live keys 0-999 and 3,000-3,499 of 4,096) and a
           B = 3 batch with a row of no live key; two runs of every case are
           bit-equal. Median of 5 timings of both at each S, B = 1, beside
           one ``scaled_dot_product_attention`` call. The f32 instantiation at
           S = 2048, B = 1 within 1e-5.
7. long    whole-document ingest and f32x2 serving at bge-m3 width. The
           seeded encoder embeds one 8,192-token document with the kernel
           and with the twin for attention (pooled-vector cosine >= 0.999:
           a check that the kernel runs inside the encoder, not a test of
           attention, since random weights pull whole-document embeddings
           together; the flash phase tests the kernel).
           ``ingest_long``: 24 documents, one per
           ``EncoderEmbedder(max_tokens=8192).embed`` call, 8 in each of the
           2048, 4096 and 8192 buckets, with lengths away from the bucket
           edges (fully padded key tiles occur); every layer of every
           forward goes through the flash kernel (24 x 24 launches). They,
           and seeded unit vectors up to 1,000,000 live rows, fill an f32x2
           ``VectorIndex`` of capacity 1,048,576 x 1024 (bf16 pairs, 4 GiB,
           64-wide token cache); one document is deleted. ``serve_f32x2``:
           64 concurrent requests through ``QueryBatcher(max_batch=32)``,
           each answered with 3 distinct live chunks, with ``topk_float``
           f32x2 launches on the way (counted over the measured burst,
           after a warm-up one); one batch's fused top-12 equals the plain
           path's (tie-aware, 1e-5) and has recall@12 >= 0.99 against an
           exact fp32 top-12, also when rows within 1e-5 of the exact 12th
           score count as ties (random weights put whole-document
           embeddings within ~1e-6 of one another); 32 seeded unit queries
           through ``VectorIndex.query`` have recall@12 >= 0.99. The batch's
           ``fused_query`` is then timed by stage (median of 5): the encoder,
           the scan, and the rest (token gather, cross-encoder, final sort).

8. kernel_paged  ``paged_attention`` (the CUDA kernel) against
           ``paged_attention_plain`` at TinyLlama-1.1B's shape (H 32, KvH 4,
           Dh 64, page 128, MAXP 16, a pool of 1,025 pages): B in {1, 8, 64}
           at T = 1 with seeded row lengths from 1 to 2,047, scattered page
           ids and inactive rows (table all 0), and T = 256 prefill chunks at
           B = 1 from ``pos`` 0 and 512; bf16 and int8 pools. bf16: every
           element within 2e-3 + 2 bf16 ulps of the twin's and the error's
           norm within 1e-2 of the output's (the kernel rounds p against a
           running max over key tiles, the twin against the row max). int8
           pool (f32 products): 1e-4 + 1 bf16 ulp of the bf16 output, error
           norm within 1e-3. Two runs on the same inputs are bit-equal, and
           positions at the kernel's 256-slot split boundaries (255, 256,
           257, 511, 512, 2,047) are bit-equal inside a 64-token chunk, alone
           and beside other rows. Timed (``ms``, ``device_ms``, bound) at
           the three shapes the decoder launches: B = 64, T = 1 (the twin
           too); B = 8, T = 4 (a speculative window); B = 1, T = 256 from 512.
9. kernel_kv_write  ``paged_kv_write`` against ``paged_kv_write_plain``:
           every page but the scratch page 0 byte-equal, bf16 and int8, T = 1
           at B = 64, T = 256 at B = 1 straddling pages, and a chunk whose
           tail passes the row's capacity (it must land in page 0).
10. kernel_int8_linear  ``int8_linear`` against ``int8_linear_plain`` at the
           decoder's projections, (M, K, N) = (64, 2048, 2560),
           (64, 2048, 2048), (64, 2048, 11264), (64, 5632, 2048),
           (64, 2048, 32000), at M = 8, and at the M = 256 of a prefill chunk
           on all five widths: bf16 outputs within 1e-5 of the output's scale
           + 1 bf16 ulp (exact products in both, f32 sums in another order);
           at M = 256 the first 8 rows alone are bit-equal to the same rows of
           the whole. Times, the weight bytes a second, and one ``F.linear``
           on a weight dequantized beforehand (it reads twice the bytes) as
           the library yardstick; both summed over a decode step's 89
           projections (22 each of q/k/v, o, gate/up and down, and the
           ``lm_head``) at M = 64 and over a prefill chunk's at M = 256.
11. decoder  the local chat decoder at TinyLlama-1.1B width (22 layers, 32
           heads, 4 KV heads, vocab 32,000; seeded random bf16 weights)
           served by ``LocalChatProvider(batch_slots=64, kv_pages=1025,
           page_size=128, chunk_tokens=16, max_new_tokens=64)`` with the
           ``ByteTokenizer``: 64 concurrent chats through ``provider.stream``
           (asyncio), 48 of 600-1,500 tokens sharing a 512-token system
           prefix and 16 of 200-500 tokens without it, every third one
           sampled (temperature 0.8, top_p 0.9), the rest greedy. Every
           stream ends and yields text; ``paged_attention`` and
           ``paged_kv_write`` launch 22 times a forward; prefix hits > 0; a
           repeat of one greedy chat after the burst (warm prefix pages, other
           neighbours) equals its first answer, and a prompt submitted twice
           to the batcher gives the same tokens cold and warm; every page
           returns to the free list or the prefix cache. One prefill and one
           decode forward with the kernels against the same forwards with
           the plain twins patched in: the error's norm within 3e-2 of the
           logits' (22 bf16 layers). The burst's wall time, tokens a second
           and time to first token come from that burst as served; a second
           burst of new chats, read for nothing end to end, has the worker's
           step and prefill programs wrapped in synchronized timers for the
           ms a step and the prefill tokens a second. ``decode_profile``: decode steps with all
           64 rows live at lengths of 256-1,900 through ``generate_chunk``:
           ms a step, and under ``torch.profiler`` the device's busy share
           and its top kernels. Then the same with ``kv_int8=True``, and
           a shorter burst (16 chats, 32 new tokens) with ``int8_weights=True``
           in ``DECODER_INT8_MODE=kernel`` (``int8_linear`` launches
           4 x 22 + 1 times a forward). Then four more configurations:
           ``int4_weights`` (``int4_weights=True``, ``DECODER_INT4_MODE=w4a8``,
           32 slots so that a decode step has 32 rows and takes the kernel
           under the JAX package's rule, 32 chats of the same mix, 64 new
           tokens: ``w4a8_matmul`` and ``quantize_rows`` each launch
           4 x 22 + 1 times a decode forward (a projection is two launches)
           and never in a prefill chunk; the logits of one 32-row step with
           the int4 kernels equal to the same step with their twins bit for
           bit, and with every twin within 5e-2 of the logits' norm: both
           sides quantize the activations alike, and a flipped int8 rounding
           carries the paged kernel's bf16 noise); ``int4_kernel`` (the first 8
           of those chats in mode ``kernel``: ``w4a16_matmul`` counted alike,
           one launch a projection, its epilogue writing bf16,
           its logits within 3e-2 of its twin's like the other bf16 kernels');
           ``spec`` (bf16 weights, ``spec_k=3``, 8 slots, 8 chats, 64 new
           tokens: ``paged_attention`` and ``paged_kv_write`` run on windows of
           T = 4, ``spec_tokens_per_step >= 1``; printed without a gate: the
           share of greedy chats whose text equals the ``spec_k=0`` run's,
           since the dense products may take another algorithm at 32 rows
           than at 8, and one ``force_accept=True`` chunk as the all-accepted
           ceiling) and ``spec_int4`` (the same with int4 weights: the 8 x 4
           window rows take the w4a8 kernel).
12. kernel_int4  ``quantize_rows`` (the row quantizer of w4a8) against its
           twin, codes and scale bits byte-equal, for bf16 and f32 rows at
           every M and K below, with a row of zeros, a row whose maximum is
           negative and values at exact .5 ties. ``w4a8_matmul`` and
           ``w4a16_matmul`` (bf16 and f32) against
           their twins at TinyLlama's five (K, N), at (4096, 22016) and
           (11008, 4096), groups of 128, and at (2048, 2560) with groups of
           256 and 512; M in {1, 8, 32, 64, 256}: w4a8 bit-equal (exact
           integer group sums, one f32 order), also through its bf16 epilogue;
           w4a16 within 1e-5 of the output's scale + 1e-5 relative (the same
           decoded weights; f32 sums in another order), its bf16 epilogue
           the f32 result rounded once; two runs bit-equal, a
           row at M = 1 bit-equal to the same row inside M = 32. Times at
           M = 32 through the calls the decoder makes (bf16 out), each read
           twice: ``ms``, one launch through the wrapper
           between two events (the host's time to launch a kernel this
           short), and ``device_ms``, events around 100 back-to-back launches
           or a CUDA-graph replay of them, each launch on the next of a ring
           of weights that spans three times the L2 cache; ``F.linear`` on a
           weight dequantized to bf16 beforehand (four times the bytes) as
           the library yardstick, read the same two ways, and the grouped
           product of ``_mm_int4`` at M = 32, 64 and 128 beside them.
13. kernel_int4_floor  ``int4_stream_floor`` against its twin (exact), then
           the package's ``tools/bench_int4_kernel.py`` at those shapes:
           floor / w4a16 / w4a8 / int8 side by side at M = 32.
14. kernel_topk_floor  inside phase 5, on each mode's corpus: ``topk_floor``
           against its twin (1e-5), ``nomerge`` bit-equal to the first column
           of ``topk_float``'s values, then the package's
           ``tools/bench_topk_kernel.py``: full / nomerge / matmul at B = 32.
15. hybrid  BGE-m3's lexical and ColBERT terms at bge-m3 width: a seeded
           bge-m3 encoder with the sparse and ColBERT (1024 -> 1024) heads, an
           int8r index of capacity 131,072 with a 64-wide token cache and
           rank-128 ColBERT codes (the JAX package's defaults once
           COLBERT_WEIGHT > 0); 4,096 text chunks through ``embed``,
           ``token_weights`` and ``colbert_cache``, seeded rows up to 120,000
           live. 64 concurrent requests through ``RetrievalService(lex_weight=
           0.3, colbert_weight=0.2)`` and ``QueryBatcher``: valid answers and
           ``topk_int8`` launches; for one batch the cached form's retrieval
           rows and values equal a plain composition (``topk_int8_plain``,
           ``rescore_candidates``, ``lexical_overlap_scores``,
           ``late_interaction_scores``) within 1e-5, both terms non-zero for
           most live candidates, and the rerank top-3 equal. ``fused_query``
           timed with the terms off, cached and recomputed, and by stage.

16. entry   ``python -m outline_rag_tpu_torch`` in a subprocess with
           ``SECRET_KEY``, a temporary ``DATA_DIR`` and a free ``PORT``, all
           else the defaults (hash embedder, int8r index on the card,
           ``FakeChatProvider``): /healthz answers 200, a dev-login ask
           streams to ``[DONE]``, SIGTERM ends it with exit 0 within the
           drain timeout; then ``python -m outline_rag_tpu_torch status``
           prints dtype ``int8r``.

The last lines are the kernel summary (each kernel's time beside its bound:
the larger of its bytes over 3.35 TB/s and its operations over the card's
peak for their type), the card's name and power limit as ``nvidia-smi``
prints them, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import sys
import time

N_ROWS, DIM, CAPACITY = 1_048_576, 1024, 1_048_576
LIVE_ROWS, TEXT_CHUNKS, BLOCK = 1_000_000, 4096, 4096
TOKEN_WIDTH, TOP_K, RERANK_K, CANDIDATES = 64, 12, 3, 64
REQUESTS, MAX_BATCH = 64, 32
# lifecycle: oracle slots for the chunks added past the slice's rows
LIFE_EXTRA_SLOTS = 16 * 4096
# hybrid: the JAX package's default capacity (1 << 17), its ColBERT rank once
# COLBERT_WEIGHT > 0, the live rows, the weights of tests/test_mesh_serving.py
HYB_CAPACITY, HYB_RANK, HYB_LIVE = 1 << 17, 128, 120_000
HYB_LEX, HYB_COLBERT, HYB_TOL, HYB_VOCAB = 0.3, 0.2, 1e-5, 64
VALUE_TOL, RECALL_MIN = 1e-6, 0.99
FLOAT_TOL = 1e-5  # float scan: sums in another order than the twin's
N_DUPS = 12
FLASH_HEADS, COSINE_MIN = 16, 0.999
# flash kernel vs twin, per dtype: (atol, bf16 ulps, error norm / output norm)
FLASH_BOUNDS = {"bf16": (2e-3, 2.0, 1e-2), "f32": (1e-5, 0.0, 1e-5)}
LONG_DOCS_PER_BUCKET, LONG_MAX_TOKENS = 8, 8192
# the card's published peaks (NVIDIA H100 SXM, dense): bytes/s, and ops/s by type
HBM_RATE = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# TinyLlama-1.1B's attention shape and the pool the decoder phase serves from
DEC_HEADS, DEC_KV_HEADS, DEC_HD, PAGE, MAXP, KV_PAGES = 32, 4, 64, 128, 16, 1025
DEC_SLOTS, DEC_CHUNK, DEC_NEW = 64, 16, 64
# paged attention vs twin, per pool: (atol, bf16 ulps, error norm / output norm)
PAGED_BOUNDS = {"bf16": (2e-3, 2.0, 1e-2), "int8": (1e-4, 1.0, 1e-3)}
LOGITS_REL_RMS = 3e-2  # one forward, kernels vs twins, 22 bf16 layers
# the same with int4 weights: w4a8 rounds the activations to int8 on both
# sides, and a rounding flipped by the paged kernel's bf16 noise moves a logit
# by a quantization step
INT4_LOGITS_REL_RMS = 5e-2


def bound(bytes_moved: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate for their type."""
    by_bytes, by_ops = 1e3 * bytes_moved / HBM_RATE, 1e3 * ops / PEAK[kind]
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(torch, fn, runs: int = 10) -> float:
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event timings,
    after one warm-up call (the package's timer, shared with its tools)."""
    from outline_rag_tpu_torch.tools.timing import cuda_ms as timed

    return timed(fn, runs)


def cuda_ms_many(torch, fn, launches: int = 100, runs: int = 5) -> dict:
    """Milliseconds a call on the device for kernels of a few microseconds,
    where one launch between two events reads the host: events around
    ``launches`` back-to-back calls (``queued_ms``) and around a CUDA-graph
    replay of the same run (``graph_ms``), median of ``runs``;
    ``device_ms`` is the smaller (the package's timer, shared with its
    tools)."""
    from outline_rag_tpu_torch.tools.timing import cuda_ms_many as timed

    return timed(fn, launches, runs)


def both_ms(torch, fn, many=None, runs: int = 10) -> dict:
    """``ms``: one launch through the wrapper between two events, what an
    eager caller pays; ``device_ms`` and its two readings: many launches
    (``many``, by default ``fn`` itself; a caller passes one that walks a
    ring of cold operands)."""
    readings = cuda_ms_many(torch, many or fn)
    return {"ms": cuda_ms(torch, fn, runs), "device_ms": readings["device_ms"],
            "queued_ms": readings["queued_ms"], "graph_ms": readings["graph_ms"]}


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
            "bit_equal": bool(torch.equal(vals, pv) and torch.equal(idx, pi)), "max_abs_err": err,
        }
        require(row["bit_equal"], f"kernel values and indices bit-equal to the plain version's at {row}")
        if pen is penalty:
            head = min(k, len(tied))
            require(idx[0, :head].tolist() == tied[:head], "tied rows come lowest first")
        else:
            require(bool((idx[:, 10:] == 0).all() and (vals[:, 10:] == NEG).all()),
                    "slots past the 10 live rows are (NEG, 0)")
        if b == 32 and k == 12 and pen is penalty:
            row["ms"] = cuda_ms(torch, lambda: topk_int8(*args))
        if k == 64 and b in (32, 128) and pen is penalty:
            # ms: one launch through the wrapper; device_ms: many back to back
            row.update(both_ms(torch, lambda: topk_int8(*args)))
            row["plain_ms"] = cuda_ms(torch, lambda: topk_int8_plain(*args))
            if b == 32:
                row.update(int8_library_pair(torch, *args))
        results.append(row)
        emit("kernel", **row)
    timed = {(r["B"], r["K"]): r for r in results if "ms" in r}
    # the corpus, its scales and the penalty read once; the queries, their
    # scales and the lists; 2*B*N*D int8 ops
    def moved(b):
        return N_ROWS * (DIM + 8) + b * (DIM + 4) + b * 64 * 8
    return {"max_abs_err": max_err, "ms": timed[32, 64]["ms"], "plain_ms": timed[32, 64]["plain_ms"],
            "device_ms": timed[32, 64]["device_ms"], "ms_b128": timed[128, 64]["ms"],
            "device_ms_b128": timed[128, 64]["device_ms"],
            "plain_ms_b128": timed[128, 64]["plain_ms"],
            "ms_k12": timed[32, 12]["ms"], "library_pair_ms": timed[32, 64]["library_pair_ms"],
            **({"library_error": timed[32, 64]["library_error"]}
               if "library_error" in timed[32, 64] else {}),
            **bound(moved(32), 2 * 32 * N_ROWS * DIM, "int8"),
            **{key + "_b128": value
               for key, value in bound(moved(128), 2 * 128 * N_ROWS * DIM, "int8").items()}}


def int8_library_pair(torch, q, qscale, corpus, cscale, k, penalty) -> dict:
    """The int8 scan's yardstick of two library calls: ``torch._int_mm`` of
    the codes against the corpus's transpose (int32), then the scales and
    the penalty in the Pallas order and ``torch.topk`` (which keeps no order
    among ties). ``library_pair_ms`` is None and ``library_error`` says why
    where ``_int_mm`` refuses the layout or the shape."""
    def pair():
        raw = torch._int_mm(q, corpus.T)
        return torch.topk(raw.float() * cscale * qscale[:, None] + penalty, k, dim=1)

    try:
        pair()
    except RuntimeError as err:
        return {"library_pair_ms": None, "library_error": str(err).splitlines()[0][:300]}
    return {"library_pair_ms": cuda_ms(torch, pair)}


def serve_burst(service, queries: list[str]):
    """All ``queries`` at once through a ``QueryBatcher(max_batch=32)`` over
    ``service.retrieve_batch``: ([(answer, seconds)], wall seconds)."""
    from outline_rag_tpu_torch.engine import QueryBatcher

    async def serve():
        batcher = QueryBatcher(service.retrieve_batch, max_batch=MAX_BATCH)

        async def one(q):
            t = time.perf_counter()
            res = await batcher.retrieve(q)
            return res, time.perf_counter() - t

        try:
            t = time.perf_counter()
            out = await asyncio.gather(*(one(q) for q in queries))
            return out, time.perf_counter() - t
        finally:
            await batcher.stop()

    return asyncio.run(serve())


def check_answers(np, answers, deleted: set[str]) -> None:
    for res, _ in answers:
        ids = [c.chunk_id for c in res]
        require(len(ids) == RERANK_K, f"{RERANK_K} chunks per answer, got {ids}")
        require(len(set(ids)) == len(ids), f"no duplicate ids in {ids}")
        require(not deleted & set(ids), f"no deleted ids in {ids}")
        require(all(np.isfinite([c.score, c.rerank_score]).all() for c in res), "finite scores")


def latency_fields(answers, wall_s: float) -> dict:
    lat = sorted(t for _, t in answers)
    return {"requests": len(lat), "max_batch": MAX_BATCH, "p50_ms": 1e3 * lat[len(lat) // 2],
            "p95_ms": 1e3 * lat[min(len(lat) - 1, int(0.95 * len(lat)))],
            "answers_per_s": len(lat) / wall_s, "wall_s": wall_s}


def make_texts(rng, n: int, vocab: list[str]) -> list[str]:
    return [" ".join(rng.choice(vocab, size=int(rng.integers(20, 60)))) for _ in range(n)]


def random_chunks(torch, n: int, gen, dev, tok, vocab_size: int):
    """n seeded chunks: Gaussian vectors, and token rows of 8-64 random ids
    (CLS first, padded)."""
    v = torch.randn((n, DIM), generator=gen, device=dev)
    lengths = torch.randint(8, TOKEN_WIDTH + 1, (n, 1), generator=gen, device=dev)
    mask = (torch.arange(TOKEN_WIDTH, device=dev)[None, :] < lengths).to(torch.int32)
    ids = torch.randint(3, vocab_size, (n, TOKEN_WIDTH), generator=gen, device=dev,
                        dtype=torch.int32)
    ids = torch.where(mask.bool(), ids, tok.pad_id)
    ids[:, 0] = tok.cls_id
    return v, ids, mask


def slice_phase(torch, dev, seed: int) -> tuple[int, dict]:
    """Returns the kernel's launch count over the burst, and what the
    ``lifecycle`` phase continues on: the index, its service, the models,
    the oracle rows and the requests."""
    import numpy as np

    from outline_rag_tpu_torch.engine import (
        CrossEncoderReranker,
        EncoderEmbedder,
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
    from outline_rag_tpu_torch.ops.quant import int8_topk, quantize_rows_int8, rescore_candidates
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
    n_src = 0
    while index.size < LIVE_ROWS:
        n = min(BLOCK, LIVE_ROWS - index.size)
        v, ids, mask = random_chunks(torch, n, gen, dev, tok, cfg.vocab_size)
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

    serve_burst(service, queries[:MAX_BATCH])  # warm-up: cuBLAS handles, allocator
    topk_int8.launches = 0
    answers, wall_s = serve_burst(service, queries)
    launches = topk_int8.launches
    require(launches > 0, "the main path launched the topk_int8 kernel")
    deleted = {f"text7:{i}" for i in range(64)} | {f"rand{gone}:{i}" for i in range(BLOCK)}
    check_answers(np, answers, deleted)
    served = latency_fields(answers, wall_s)
    emit("serve", **served, topk_int8_launches=launches)

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
        # fused_query's stages for this batch, median of 5 each: the encoder,
        # the scan (quantize, the kernel at K = 64, the rescore), the kernel
        # alone, and the whole call (the rest is the token gather, the
        # cross-encoder and the final sort)
        stages = {
            "encode_ms": cuda_ms(torch, lambda: pooled_embeddings(encoder, q_ids, q_mask), runs=5),
            "scan_ms": cuda_ms(torch, lambda: int8_topk(
                *quantize_rows_int8(q_emb), state.vectors, state.scales, TOP_K, state.penalty,
                rescore_queries=q_emb, rescore_residual=state.residual), runs=5),
            "kernel_ms": cuda_ms(torch, lambda: topk_int8(
                qq, qs, state.vectors, state.scales, CANDIDATES, state.penalty), runs=5),
            "fused_ms": cuda_ms(torch, lambda: fused_query(
                encoder, reranker, q_ids, q_mask, state.vectors, state.scales, state.penalty,
                tokens.ids, tokens.mask, state.residual, top_k=TOP_K, rerank_k=RERANK_K), runs=5),
        }
        stages["gather_rerank_ms"] = stages["fused_ms"] - stages["encode_ms"] - stages["scan_ms"]
    require(torch.equal(idx, pi), "fused top-12 equals the plain path's")
    err = float((vals - pv).abs().max())
    require(err <= VALUE_TOL, f"fused top-12 values within {VALUE_TOL} of the plain path's")
    hits = [len(set(a) & set(b[:TOP_K])) for a, b in zip(idx.tolist(), oi.tolist())]
    recall = sum(hits) / (TOP_K * len(hits))
    emit("retrieval", batch=len(hits), recall_at_12=recall, max_abs_err_vs_plain=err,
         min_oracle_gap_12_13=float((ov[:, TOP_K - 1] - ov[:, TOP_K]).min()),
         min_oracle_gap_1_12=float((ov[:, :TOP_K - 1] - ov[:, 1:TOP_K]).min()), stages=stages)
    require(recall >= RECALL_MIN, f"recall@12 {recall} >= {RECALL_MIN}")
    handover = dict(index=index, service=service, encoder=encoder, reranker=reranker, tok=tok,
                    oracle=oracle, queries=queries, deleted=deleted, n_src=n_src, gone=gone,
                    serve_p50_ms=served["p50_ms"])
    return launches, handover


class ChunkOracle:
    """Exact fp32 copies of the index's vectors keyed by chunk id, so the
    recall check follows chunks through re-adds, compaction, growth and a
    snapshot whatever rows they land on. ``vec`` [slots, DIM] unit rows,
    ``pen`` [slots] 0 for a live chunk and NEG for a dead slot, ``ids``
    the chunk id of each slot."""

    def __init__(self, torch, rows, index, slots: int):
        import numpy as np

        from outline_rag_tpu_torch.ops.topk import NEG

        dev = rows.device
        n = rows.shape[0]
        self.vec = torch.zeros((slots, DIM), dtype=torch.float32, device=dev)
        self.vec[:n] = rows  # the slice phase's oracle, indexed by its rows
        self.pen = torch.full((slots,), NEG, dtype=torch.float32, device=dev)
        self.ids = np.full(slots, "", dtype=object)
        self.slot = {}
        for cid, row in index._by_chunk.items():
            self.slot[cid] = row
            self.ids[row] = cid
        live = torch.as_tensor(list(self.slot.values()), device=dev)
        self.pen[live] = 0.0
        self.used = n

    def put(self, torch, cids: list[str], unit):
        """Chunks ``cids`` now have the unit vectors ``unit`` [n, DIM]."""
        at = []
        for cid in cids:
            if cid not in self.slot:
                self.slot[cid] = self.used
                self.ids[self.used] = cid
                self.used += 1
            at.append(self.slot[cid])
        at = torch.as_tensor(at, device=self.vec.device)
        self.vec[at] = unit
        self.pen[at] = 0.0

    def top_ids(self, torch, q_emb, k: int) -> list[list[str]]:
        from outline_rag_tpu_torch.ops.topk import topk_plain

        _, slots = topk_plain(q_emb, self.vec[: self.used], k, self.pen[: self.used])
        return [[self.ids[j] for j in row] for row in slots.tolist()]


def lifecycle_phase(torch, dev, seed: int, handover: dict) -> dict:
    """The slice phase's 1,048,576-row int8r index through delta updates
    until it compacts at its capacity, a growth to 2,097,152 rows and a
    snapshot round trip (save, load, adopt), each step followed by a burst
    through the same service and the checks of ``lifecycle_checks``."""
    import shutil
    import tempfile

    from outline_rag_tpu_torch.index import VectorIndex
    from outline_rag_tpu_torch.index.store import normalize_rows

    t_phase = time.perf_counter()
    index, service, tok = handover["index"], handover["service"], handover["tok"]
    oracle = ChunkOracle(torch, handover["oracle"], index, CAPACITY + LIFE_EXTRA_SLOTS)
    del handover["oracle"]
    deleted = handover["deleted"]
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    vocab_size = handover["encoder"].cfg.vocab_size
    from outline_rag_tpu_torch.tools.timing import card

    smi = card()
    out = {"card": smi, "launches": {}}

    def add(source: str, n: int) -> float:
        v, ids, mask = random_chunks(torch, n, gen, dev, tok, vocab_size)
        cids = [f"{source}:{i}" for i in range(n)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        index.add_chunks(cids, v, source, token_ids=ids, token_mask=mask)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        oracle.put(torch, cids, normalize_rows(v))
        return seconds

    def step(name: str, **fields):
        checks = lifecycle_checks(torch, dev, handover, oracle, deleted)
        out["launches"][name] = checks.pop("topk_int8_launches")
        out[name] = {**fields, **checks, "live_rows": index.size, "capacity": index.capacity,
                     "generation": index.generation, "card": smi}
        emit("lifecycle", step=name, **out[name], topk_int8_launches=out["launches"][name])

    # 1. delta updates: whole rand sources re-added under the same ids
    # (replace=True) until an add finds no free row and compacts
    cap0, gen0 = index.capacity, index.generation
    rounds, add_s = 0, []
    while True:
        src = rounds if rounds < handover["gone"] else rounds + 1  # the deleted one stays so
        free_before = index._shard.free
        add_s.append(add(f"rand{src}", BLOCK))
        rounds += 1
        if free_before < BLOCK:
            break
        require(rounds <= 16, "delta updates reach a compaction within 16 rounds")
    require(index.capacity == cap0, "the churn compacted at the same capacity")
    require(index.generation > gen0, "the generation moved on")
    require(index._shard.cursor == index.size, "no tombstone left after compaction")
    step("compaction", rounds=rounds, compaction_s=add_s[-1],
         delta_add_s_median=statistics.median(add_s[:-1]))

    # 2. growth: new sources until an add does not fit
    grow_adds = 0
    while index._shard.free >= BLOCK:
        add(f"grow{grow_adds}", BLOCK)
        grow_adds += 1
    old_bytes = index._index_bytes(index.capacity)
    new_bytes = index._index_bytes(2 * index.capacity)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    growth_s = add(f"grow{grow_adds}", BLOCK)
    peak = torch.cuda.max_memory_allocated(dev)
    require(index.capacity == 2 * cap0, f"grew to {2 * cap0} rows, not {index.capacity}")
    require(peak < before + new_bytes,
            f"growth peak {peak} below allocated-before {before} + new index {new_bytes}")
    step("growth", adds_before=grow_adds, growth_s=growth_s, allocated_before_bytes=before,
         peak_allocated_bytes=peak, reserved_bytes=torch.cuda.memory_reserved(dev),
         old_index_bytes=old_bytes, new_index_bytes=new_bytes,
         stages_at_2m=scan_stages(torch, dev, handover))
    out["growth"]["peak_minus_before_bytes"] = peak - before

    # 3. snapshot round trip into the served index
    tmp = tempfile.mkdtemp(prefix="chip_smoke_snapshot_")
    try:
        path = os.path.join(tmp, "index")
        t = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t
        disk = {name: os.path.getsize(os.path.join(tmp, name)) for name in os.listdir(tmp)}
        t = time.perf_counter()
        loaded = VectorIndex.load(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp)
    require(loaded.size == index.size and loaded.capacity == index.capacity,
            "the snapshot holds every live row at the same capacity")
    t = time.perf_counter()
    index.adopt(loaded)
    adopt_s = time.perf_counter() - t
    del loaded
    step("snapshot", save_s=save_s, load_s=load_s, adopt_s=adopt_s, bytes_on_disk=disk,
         snapshot_bytes=sum(disk.values()))
    out["seconds"] = time.perf_counter() - t_phase
    emit("lifecycle_done", seconds=out["seconds"], card=smi)
    return out


def lifecycle_checks(torch, dev, handover: dict, oracle: ChunkOracle, deleted: set) -> dict:
    """A burst of REQUESTS through the service (answers checked, the
    kernel's launches counted), then one batch: the fused top-12 against
    the plain path (``topk_int8_plain`` + ``rescore_candidates``), every row
    the current row of its chunk, and recall@12 against the oracle."""
    import numpy as np

    from outline_rag_tpu_torch.engine import fused_query
    from outline_rag_tpu_torch.models import pooled_embeddings
    from outline_rag_tpu_torch.ops.quant import quantize_rows_int8, rescore_candidates
    from outline_rag_tpu_torch.ops.topk import topk_int8, topk_int8_plain

    index, service, tok = handover["index"], handover["service"], handover["tok"]
    encoder, reranker, queries = handover["encoder"], handover["reranker"], handover["queries"]
    topk_int8.launches = 0
    answers, wall_s = serve_burst(service, queries)
    launches = topk_int8.launches
    require(launches > 0, "the burst launched the topk_int8 kernel")
    check_answers(np, answers, deleted)
    tb = tok.batch(queries[:MAX_BATCH], TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
    q_ids = torch.as_tensor(tb.input_ids, device=dev)
    q_mask = torch.as_tensor(tb.attention_mask, device=dev)
    with torch.inference_mode(), index.read_section():
        state, row_ids = index.snapshot()
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
        fused_ids = [[str(row_ids[r]) for r in row] for row in idx.tolist()]
        current = all(index._by_chunk.get(row_ids[r]) == r for row in idx.tolist() for r in row)
        del state, tokens
    require(torch.equal(idx, pi), "fused top-12 equals the plain path's")
    err = float((vals - pv).abs().max())
    require(err <= VALUE_TOL, f"fused top-12 values within {VALUE_TOL} of the plain path's")
    require(current, "every returned row is its chunk's current row (no replaced row)")
    want = oracle.top_ids(torch, q_emb, TOP_K)
    hits = [len(set(a) & set(b)) for a, b in zip(fused_ids, want)]
    recall = sum(hits) / (TOP_K * len(hits))
    require(recall >= RECALL_MIN, f"recall@12 {recall} >= {RECALL_MIN}")
    return {"recall_at_12": recall, "max_abs_err_vs_plain": err, "topk_int8_launches": launches,
            **latency_fields(answers, wall_s)}


def scan_stages(torch, dev, handover: dict) -> dict:
    """``fused_query``'s scan (quantize, the kernel at K = 64, the rescore)
    and the kernel alone for the first batch of requests, median of 5."""
    from outline_rag_tpu_torch.models import pooled_embeddings
    from outline_rag_tpu_torch.ops.quant import int8_topk, quantize_rows_int8
    from outline_rag_tpu_torch.ops.topk import topk_int8

    index, tok, encoder = handover["index"], handover["tok"], handover["encoder"]
    tb = tok.batch(handover["queries"][:MAX_BATCH], TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
    q_ids = torch.as_tensor(tb.input_ids, device=dev)
    q_mask = torch.as_tensor(tb.attention_mask, device=dev)
    with torch.inference_mode(), index.read_section():
        state, _ = index.snapshot()
        q_emb = pooled_embeddings(encoder, q_ids, q_mask)
        qq, qs = quantize_rows_int8(q_emb)
        out = {
            "rows": state.capacity,
            "scan_ms": cuda_ms(torch, lambda: int8_topk(
                *quantize_rows_int8(q_emb), state.vectors, state.scales, TOP_K, state.penalty,
                rescore_queries=q_emb, rescore_residual=state.residual), runs=5),
            "kernel_ms": cuda_ms(torch, lambda: topk_int8(
                qq, qs, state.vectors, state.scales, CANDIDATES, state.penalty), runs=5),
        }
        del state
    return out


# -- the HTTP app: a whole local RAG turn over a socket ------------------------

HTTP_SOURCE_ROWS = 1024  # seeded rows per seeded document
HTTP_LIVE = LIVE_ROWS - 64 - BLOCK  # 995,840: the slice index's live rows
HTTP_DOCS = 24  # documents ingested through Outline sync during the phase
HTTP_CLIENTS = 64


class FakeWiki:
    """An Outline API on 127.0.0.1 (stdlib ``http.server`` on a thread of its
    own): ``collections.list``, paginated ``documents.list``,
    ``documents.info`` and ``documents.export`` over ``docs``
    ({id: {"id", "title", "text", "updatedAt", "url"}}), the replay the JAX
    package's tests serve through ``tests/fake_outline.py``."""

    def __init__(self, docs: dict):
        import http.server
        import threading

        wiki = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("content-length") or 0))
                status, out = wiki.answer(self.path.split("/api/")[-1], json.loads(body or b"{}"))
                data = json.dumps(out).encode()
                self.send_response(status)
                self.send_header("content-type", "application/json")
                self.send_header("content-length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.docs = docs
        self.calls: dict[str, int] = {}
        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def answer(self, endpoint: str, payload: dict):
        self.calls[endpoint] = self.calls.get(endpoint, 0) + 1
        if endpoint == "collections.list":
            return 200, {"data": [{"id": "col", "name": "col"}]}
        if endpoint == "documents.list":
            offset, limit = payload.get("offset", 0), payload.get("limit", 100)
            page = sorted(self.docs)[offset : offset + limit]
            return 200, {"data": [{k: self.docs[i][k] for k in ("id", "title", "updatedAt", "url")}
                                  for i in page]}
        doc = self.docs.get(payload.get("id"))
        if doc is None:
            return 404, {"error": "not found"}
        if endpoint == "documents.info":
            return 200, {"data": {k: doc[k] for k in ("id", "title", "updatedAt", "url")}}
        if endpoint == "documents.export":
            return 200, {"data": doc["text"]}
        return 404, {"error": "unknown endpoint"}

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10)


def http_call(port: int, method: str, path: str, body=None, cookie: str | None = None,
              form: bool = False):
    """One request to the app over a fresh connection: (status, headers
    (case-insensitive), body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    headers = {"Cookie": cookie} if cookie else {}
    if form:
        headers["Content-Type"] = "application/x-www-form-urlencoded"
    elif body is not None:
        body = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    try:
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.headers, resp.read()
    finally:
        conn.close()


def http_login(port: int, name: str) -> str:
    status, headers, _ = http_call(port, "POST", "/chat/login", f"name={name}".encode(), form=True)
    require(status == 302, f"dev login answered {status}")
    return headers["Set-Cookie"].split(";", 1)[0]


def sse_ask(port: int, cookie: str, conv_id: str, question: str) -> dict:
    """POST /chat/api/ask and read its SSE stream to the end: the parsed
    frames, the seconds to the first content frame and to ``[DONE]``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/chat/api/ask",
                     body=json.dumps({"question": question, "conversation_id": conv_id}).encode(),
                     headers={"Cookie": cookie, "Content-Type": "application/json"})
        resp = conn.getresponse()
        require(resp.status == 200, f"ask answered {resp.status}")
        frames, first, done = [], None, None
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode().strip()
            if not line.startswith("data:"):
                continue
            payload = line[5:].strip()
            if payload == "[DONE]":
                done = time.perf_counter() - t0
                frames.append(payload)
                continue
            frame = json.loads(payload)  # every frame must parse
            if first is None and frame["choices"][0]["delta"].get("content"):
                first = time.perf_counter() - t0
            frames.append(frame)
        return {"frames": frames, "first_s": first, "done_s": done}
    finally:
        conn.close()


def sources_of(frames) -> list[tuple[str, str]]:
    """The (title, url) pairs of an answer's SourcesMap, in citation order."""
    text = "".join(f["choices"][0]["delta"].get("content", "") for f in frames if f != "[DONE]")
    lines = [ln for ln in text.splitlines() if ln.startswith("[SourcesMap]:")]
    if not lines:
        return []
    smap = json.loads(lines[0][len("[SourcesMap]:"):])
    return [(smap[k]["title"], smap[k]["url"]) for k in sorted(smap, key=int)]


def percentiles(xs: list[float]) -> dict:
    xs = sorted(xs)
    return {"p50_ms": 1e3 * xs[len(xs) // 2], "p95_ms": 1e3 * xs[min(len(xs) - 1, int(0.95 * len(xs)))]}


def http_phase(torch, dev, seed: int, embedder, reranker, slice_p50_ms: float) -> dict:
    """A fully local RAG turn through the port's app, over a socket: Outline
    sync into a 1M-row int8r index whose every row resolves in an on-disk
    sqlite meta store, then 64 concurrent clients asking through
    ``POST /chat/api/ask`` and reading the SSE stream, answered by the local
    decoder at TinyLlama-1.1B width."""
    import asyncio as aio
    import shutil
    import tempfile
    import threading

    import numpy as np

    import outline_rag_tpu_torch.models.decoder as decoder
    from outline_rag_tpu_torch.config import load_settings
    from outline_rag_tpu_torch.index import VectorIndex
    from outline_rag_tpu_torch.ops.paged_attention import paged_attention, paged_kv_write
    from outline_rag_tpu_torch.ops.topk import topk_int8
    from outline_rag_tpu_torch.serve import LocalChatProvider, build_app
    from outline_rag_tpu_torch.serve.http import serve
    from outline_rag_tpu_torch.storage import SqliteMetaStore
    from outline_rag_tpu_torch.testing import ByteTokenizer
    from outline_rag_tpu_torch.tools.timing import card
    from outline_rag_tpu_torch.utils.profiling import metrics

    t_phase = time.perf_counter()
    out = {"card": card()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_http_")
    rng = np.random.default_rng(seed + 14)
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    vocab = [f"w{i}" for i in rng.permutation(20_000)[:5000]]

    def words(n: int) -> str:
        return " ".join(rng.choice(vocab, n))

    # the index: seeded rows in documents of HTTP_SOURCE_ROWS chunks
    tok = embedder.tokenizer
    index = VectorIndex(dim=DIM, capacity=CAPACITY, dtype="int8r", device=dev,
                        token_width=TOKEN_WIDTH)
    seeded, t0 = [], time.perf_counter()
    while index.size < HTTP_LIVE:
        sid = f"seed{len(seeded):04d}"
        v, ids, mask = random_chunks(torch, HTTP_SOURCE_ROWS, gen, dev, tok,
                                     embedder.cfg.vocab_size)
        index.add_chunks([f"{sid}:{i}" for i in range(HTTP_SOURCE_ROWS)], v, sid,
                         token_ids=ids, token_mask=mask)
        seeded.append(sid)
    torch.cuda.synchronize()
    out["index_fill_s"] = time.perf_counter() - t0
    # every one of those rows resolves in the meta store, written through its own API
    meta = SqliteMetaStore(os.path.join(tmp, "meta.sqlite3"))
    wiki_docs, t0 = {}, time.perf_counter()
    for n, sid in enumerate(seeded):
        title, text = f"Seeded document {n}", words(600)
        meta.upsert_document(sid, title, f"/doc/{sid}", "t0", text)
        meta.replace_chunks(sid, [(f"{sid}:{i}", i, f"{title}, part {i}", 0)
                                  for i in range(HTTP_SOURCE_ROWS)])
        wiki_docs[sid] = {"id": sid, "title": title, "text": text, "updatedAt": "t0",
                          "url": f"/doc/{sid}"}
    out["meta_fill_s"] = time.perf_counter() - t0
    require(meta.chunk_count() == index.size, "every live row has a chunk row")
    # the documents Outline sync brings in: 1,100-8,000 words in paragraphs
    new_docs = []
    for n in range(HTTP_DOCS):
        n_words = int(rng.integers(1100, 8001))
        paras = [words(int(rng.integers(40, 120))) for _ in range(n_words // 80 + 1)]
        text = "\n\n".join(paras)
        new_docs.append(f"doc{n:02d}")
        wiki_docs[new_docs[-1]] = {"id": new_docs[-1], "title": f"Wiki page {n}", "text": text,
                                   "updatedAt": "t1", "url": f"/doc/{new_docs[-1]}"}

    # the local decoder, behind the classifier stand-in
    cfg = decoder.DecoderConfig.tinyllama_1b()
    params = decoder.init_decoder(cfg, torch.Generator(device=dev).manual_seed(seed + 15), dev)

    class KeptTokenizer(ByteTokenizer):
        """Keeps each stream's id list, to count the tokens it decoded."""

        def __init__(self):
            self.lists = {}

        def decode(self, ids):
            self.lists[id(ids)] = ids
            return super().decode(ids)

    dtok = KeptTokenizer()
    local = LocalChatProvider(params, cfg, dtok, batch_slots=DEC_SLOTS, kv_pages=KV_PAGES,
                              page_size=PAGE, chunk_tokens=DEC_CHUNK, max_new_tokens=DEC_NEW,
                              device=dev)

    class ClassifiedAsQuery:
        """Stands in for a trained model's classification, the one part of
        this phase that is not the port's code: a random-weight decoder
        never writes the classifier's JSON, and the pipeline would route
        every ask to General and skip retrieval. Answers stream from the
        local decoder."""

        async def complete(self, model, messages, temperature=0.0, top_p=None,
                           json_mode=False, max_tokens=None):
            if json_mode:
                return json.dumps({"category": "Query"})
            return await local.complete(model, messages, temperature, top_p, json_mode, max_tokens)

        def stream(self, *args, **kwargs):
            return local.stream(*args, **kwargs)

        def stats(self):
            return local.stats()

    wiki = FakeWiki(wiki_docs)
    env = {"SECRET_KEY": "chip-smoke", "DATA_DIR": tmp, "VECTOR_DIM": str(DIM),
           "OUTLINE_API_TOKEN": "chip-smoke", "OUTLINE_WEBHOOK_SECRET": "whsec",
           "OUTLINE_API_URL": wiki.url}
    settings = load_settings(env)
    require((settings.top_k, settings.rerank_k, settings.query_batch_max, settings.chunk_size,
             settings.token_width) == (TOP_K, RERANK_K, MAX_BATCH, 1024, TOKEN_WIDTH),
            "the JAX defaults: TOP_K 12, RERANK_K 3, QUERY_BATCH_MAX 32, CHUNK_SIZE 1024")
    app = build_app(settings, device=str(dev), provider=ClassifiedAsQuery(), embedder=embedder,
                    reranker=reranker, index=index, meta=meta, start_workers=True)
    retrieval = app.state["retrieval"]
    require(retrieval.fused, "the app's retrieval runs the fused path")

    # the server on a thread with its own event loop (signal handlers are the
    # main thread's; serve() installs none)
    loop = aio.new_event_loop()
    booted, holder = threading.Event(), {}

    def run_server():
        aio.set_event_loop(loop)

        async def boot():
            holder["server"] = await serve(app, "127.0.0.1", 0)
            booted.set()

        loop.run_until_complete(boot())
        loop.run_forever()

    def fused_count():
        return metrics.snapshot().get("retrieve.fused", {}).get("count", 0)

    warm_before = fused_count()
    server_thread = threading.Thread(target=run_server, daemon=True)
    t0 = time.perf_counter()
    server_thread.start()
    require(booted.wait(120), "the server started")
    port = holder["server"].sockets[0].getsockname()[1]
    while fused_count() < warm_before + 2:  # the app's warm-up: a lone query, then 32
        require(time.perf_counter() - t0 < 120, "the app's warm-up finished")
        time.sleep(0.05)
    out["startup_and_warmup_s"] = time.perf_counter() - t0
    try:
        status, _, body = http_call(port, "GET", "/healthz")
        require(status == 200, "healthz answered 200")
        size_before = json.loads(body)["index_size"]
        require(size_before == index.size >= HTTP_LIVE, f"healthz index_size {size_before}")

        # ingest through Outline sync: the refresh route, then the task worker
        admin = http_login(port, "admin")
        t0 = time.perf_counter()
        status, _, _ = http_call(port, "POST", "/chat/update/all", cookie=admin)
        require(status == 202, f"update/all answered {status}")
        while True:
            _, _, body = http_call(port, "GET", "/chat/api/refresh/status", cookie=admin)
            state = json.loads(body)
            if state.get("state") == "done":
                break
            require(time.perf_counter() - t0 < 300, f"the refresh finished: {state}")
            time.sleep(0.1)
        require(state.get("success") == HTTP_DOCS, f"refresh ingested {HTTP_DOCS}: {state}")
        require(wiki.calls.get("documents.export") == HTTP_DOCS,
                f"only the new documents were fetched: {wiki.calls}")
        out["ingest_s"] = time.perf_counter() - t0
        new_chunks = [c["chunk_id"] for sid in new_docs for c in meta.chunks_of(sid)]
        require(all(meta.get_document(sid) for sid in new_docs), "the new documents are stored")
        require(all(cid in index._by_chunk for cid in new_chunks), "their chunks are indexed")
        _, _, body = http_call(port, "GET", "/healthz")
        grew = json.loads(body)["index_size"] - size_before
        require(grew == len(new_chunks) > 0,
                f"healthz index_size grew by their {len(new_chunks)} chunks, not {grew}")
        require(meta.chunk_count() == index.size, "every live row still resolves")
        out.update(ingested_docs=HTTP_DOCS, ingested_chunks=len(new_chunks),
                   index_size=index.size)

        # 64 clients: login and a conversation each, then the asks at once
        picks = rng.permutation(HTTP_DOCS * 4)[: HTTP_CLIENTS // 2]
        questions = []
        for p in picks:  # half from the ingested documents' text
            text = wiki_docs[new_docs[p % HTTP_DOCS]]["text"].split()
            at = int(rng.integers(0, len(text) - 12))
            questions.append(" ".join(text[at : at + 12]))
        while len(questions) < HTTP_CLIENTS:  # half from the seeded documents'
            text = wiki_docs[seeded[int(rng.integers(0, len(seeded)))]]["text"].split()
            at = int(rng.integers(0, len(text) - 12))
            questions.append(" ".join(text[at : at + 12]))
        require(len(set(questions)) == HTTP_CLIENTS, "distinct questions")
        clients = []
        for i in range(HTTP_CLIENTS):
            cookie = http_login(port, f"user{i}")
            _, _, body = http_call(port, "POST", "/chat/api/conversations", {"title": f"c{i}"},
                                   cookie=cookie)
            clients.append((cookie, json.loads(body)["id"]))

        batches = []  # (queries, seconds) of each batch the batcher formed
        batcher = app.state["batcher"]
        inner = batcher.retrieve_batch

        def recorded(queries):
            t = time.perf_counter()
            res = inner(queries)
            batches.append((list(queries), time.perf_counter() - t))
            return res

        batcher.retrieve_batch = recorded
        results = [None] * HTTP_CLIENTS
        start = threading.Barrier(HTTP_CLIENTS + 1)

        def client(i):
            start.wait()
            try:
                results[i] = sse_ask(port, *clients[i], questions[i])
            except Exception as exc:  # noqa: BLE001 — checked below
                results[i] = exc

        threads = [threading.Thread(target=client, args=(i,)) for i in range(HTTP_CLIENTS)]
        for t in threads:
            t.start()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        dtok.lists.clear()
        topk_int8.launches = paged_attention.launches = paged_kv_write.launches = 0
        with metrics._lock:  # the stage timings below are the burst's alone
            metrics._samples.clear()
            metrics._counts.clear()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join(600)
        wall_s = time.perf_counter() - t0
        burst_stages = metrics.snapshot()
        launches = {"topk_int8": topk_int8.launches, "paged_attention": paged_attention.launches,
                    "paged_kv_write": paged_kv_write.launches}
        generated = sum(len(ids) for ids in dtok.lists.values())
        peak = torch.cuda.max_memory_allocated(dev)
        batcher.retrieve_batch = inner

        errors = [r for r in results if not isinstance(r, dict)]
        require(not errors, f"every ask streamed: {errors[:3]}")
        for r in results:
            frames = r["frames"]
            require(frames and frames[-1] == "[DONE]" and r["done_s"] is not None,
                    "every stream ends with [DONE]")
            require(r["first_s"] is not None, "every stream has a content frame")
        require(sum(len(q) for q, _ in batches) == HTTP_CLIENTS, "each ask retrieved once")
        require(launches["topk_int8"] >= len(batches) > 0,
                f"topk_int8 launched at least once a batch: {launches}, {len(batches)} batches")
        require(launches["paged_attention"] > 0 and launches["paged_kv_write"] > 0,
                f"the local decoder's kernels launched: {launches}")

        # the sources of every answer against the app's own retrieval, called
        # directly on the batches the batcher formed
        def doc_sources(chunks):
            seen = []
            for c in chunks:
                row = meta.get_chunk(c.chunk_id)
                if row and row["source_id"] not in seen:
                    seen.append(row["source_id"])
            return [(meta.get_document(s)["title"], meta.get_document(s)["url"]) for s in seen]

        want = {}
        for queries, _ in batches:
            for q, chunks in zip(queries, retrieval.retrieve_batch(queries)):
                want[q] = doc_sources(chunks)
        for q, r in zip(questions, results):
            got = sources_of(r["frames"])
            require(got and got == want[q], f"the sources of {q!r}: {got} vs {want[q]}")
        from_new = sum(any(url.removeprefix("/doc/") in new_docs for _, url in want[q])
                       for q in questions[: HTTP_CLIENTS // 2])

        status, _, body = http_call(port, "GET", "/chat/api/metrics", cookie=admin)
        require(status == 200, f"metrics answered {status}")
        m = json.loads(body)
        require({"retrieve.fused", "llm.classify", "http.POST"} <= set(m["stages"]),
                f"the metrics carry the stage timings: {sorted(m['stages'])}")
        require({"prefix_hits", "backpressure_waits", "pages_total"} <= set(m.get("decoder", {})),
                f"the metrics carry the decoder's stats: {m.get('decoder')}")
        sizes = [len(q) for q, _ in batches]
        out.update(
            card=card(), asks=HTTP_CLIENTS, wall_s=wall_s, asks_per_s=HTTP_CLIENTS / wall_s,
            first_content=percentiles([r["first_s"] for r in results]),
            done=percentiles([r["done_s"] for r in results]),
            streamed_tokens=generated, streamed_tokens_per_s=generated / wall_s,
            batches=len(batches), mean_batch=sum(sizes) / len(sizes), batch_sizes=sizes,
            retrieval_batch=percentiles([s for _, s in batches]),
            launches=launches, decoder=m["decoder"],
            prefix_hits=m["decoder"]["prefix_hits"],
            backpressure_waits=m["decoder"]["backpressure_waits"],
            questions_from_new_docs_citing_one=from_new,
            peak_device_gb=peak / 1e9, slice_burst_p50_ms=slice_p50_ms,
            stages={k: burst_stages[k] for k in ("retrieve.fused", "llm.classify", "http.POST")},
        )
    finally:
        async def stop():
            holder["server"].close()
            await holder["server"].wait_closed()
            await app.shutdown()

        if "server" in holder:
            aio.run_coroutine_threadsafe(stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        server_thread.join(30)
        local.close()
        wiki.close()
        meta.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit("http", **out)
    return out


def entry_phase() -> dict:
    """``python -m outline_rag_tpu_torch`` on the card with the defaults (hash
    embedder, int8r index, fake provider): /healthz, one dev-login ask to
    ``[DONE]``, SIGTERM to exit 0 within the drain timeout; then the
    ``status`` command."""
    import shutil
    import signal
    import socket
    import subprocess
    import tempfile

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "SECRET_KEY": "chip-smoke", "DATA_DIR": tmp, "PORT": str(port)}
    log_path = os.path.join(tmp, "server.log")
    out = {}
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen([sys.executable, "-m", "outline_rag_tpu_torch"], cwd=root, env=env,
                                stdout=log_file, stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        while True:
            require(proc.poll() is None, "the server process is running")
            try:
                status, _, body = http_call(port, "GET", "/healthz")
                break
            except OSError:
                require(time.perf_counter() - t0 < 180, "the server answered within 180 s")
                time.sleep(0.2)
        out["boot_s"] = time.perf_counter() - t0
        require(status == 200, f"healthz answered {status}")
        out["healthz"] = json.loads(body)
        cookie = http_login(port, "entry")
        _, _, body = http_call(port, "POST", "/chat/api/conversations", {"title": "e"},
                               cookie=cookie)
        ask = sse_ask(port, cookie, json.loads(body)["id"], "what does the wiki say?")
        require(ask["frames"][-1] == "[DONE]" and ask["first_s"] is not None,
                "the ask streamed content to [DONE]")
        out["ask_ms"] = 1e3 * ask["done_s"]
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=10.0 + 20)  # DRAIN_TIMEOUT's default, and shutdown
        out.update(exit_code=rc, stop_s=time.perf_counter() - t0)
        require(rc == 0, f"SIGTERM ended the server with exit 0, not {rc}")
        require(out["stop_s"] <= 10.0, f"it stopped within the drain timeout: {out['stop_s']} s")
        status_run = subprocess.run([sys.executable, "-m", "outline_rag_tpu_torch", "status"],
                                    cwd=root, env=env, capture_output=True, text=True,
                                    timeout=300)
        require(status_run.returncode == 0, f"status exited {status_run.returncode}: "
                f"{status_run.stderr[-2000:]}")
        printed = status_run.stdout.strip().splitlines()[-1]
        require("'dtype': 'int8r'" in printed, f"status printed dtype int8r: {printed}")
        out["status"] = printed
    except Exception:
        with open(log_path) as f:
            print(f.read()[-4000:], file=sys.stderr)
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit("entry", **out)
    return out


def hybrid_phase(torch, dev, seed: int) -> dict:
    """BGE-m3's lexical and ColBERT terms in the fused query at bge-m3 width:
    a seeded encoder with both heads over an int8r index of 131,072 rows
    with a 64-wide token cache and rank-128 ColBERT codes, 120,000 live."""
    import numpy as np

    from outline_rag_tpu_torch.engine import (
        CrossEncoderReranker,
        EncoderEmbedder,
        RetrievalService,
        add_hybrid_terms,
        encode_queries,
        fused_query,
    )
    from outline_rag_tpu_torch.index import VectorIndex
    from outline_rag_tpu_torch.models import (
        EncoderConfig,
        colbert_vectors_from_hidden,
        init_colbert_head,
        init_encoder,
        init_reranker,
        init_sparse_head,
        late_interaction_scores,
        lexical_overlap_scores,
        sparse_weights_from_hidden,
    )
    from outline_rag_tpu_torch.models.tokenizer import HashTokenizer
    from outline_rag_tpu_torch.ops.quant import int8_topk, quantize_rows_int8, rescore_candidates
    from outline_rag_tpu_torch.ops.topk import NEG, topk_int8, topk_int8_plain
    from outline_rag_tpu_torch.tools.timing import card

    t_phase = time.perf_counter()
    cfg = EncoderConfig.bge_m3()
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    encoder = init_colbert_head(init_sparse_head(init_encoder(cfg, gen, dev), gen), gen)
    reranker = init_reranker(cfg, gen, dev)
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    embedder = EncoderEmbedder(encoder, tok)
    index = VectorIndex(dim=DIM, capacity=HYB_CAPACITY, dtype="int8r", device=dev,
                        token_width=TOKEN_WIDTH, colbert_rank=HYB_RANK)
    proj = index.colbert_projection_for(encoder.colbert.out_features)

    # 4,096 text chunks through the three heads, 64 per source; a small
    # vocabulary, so queries share tokens with the chunks they retrieve
    rng = np.random.default_rng(seed + 13)
    vocab = [f"w{i}" for i in rng.permutation(20_000)[:HYB_VOCAB]]
    texts = make_texts(rng, TEXT_CHUNKS, vocab)
    tb = tok.batch(texts, TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
    torch.cuda.synchronize()
    t = time.perf_counter()
    vecs = embedder.embed(texts)
    weights = embedder.token_weights(tb.input_ids, tb.attention_mask)
    codes, scales = embedder.colbert_cache(tb.input_ids, tb.attention_mask, HYB_RANK, proj)
    heads_s = time.perf_counter() - t
    require(np.isfinite(vecs).all() and np.isfinite(weights).all() and np.isfinite(scales).all(),
            "finite embeddings, weights and scales")
    for s in range(0, TEXT_CHUNKS, 64):
        part = slice(s, s + 64)
        index.add_chunks([f"text{s // 64}:{i}" for i in range(64)], vecs[part], f"text{s // 64}",
                         token_ids=tb.input_ids[part], token_mask=tb.attention_mask[part],
                         token_weights=weights[part], colbert_codes=codes[part],
                         colbert_scales=scales[part])
    # seeded rows up to HYB_LIVE: unit vectors, random token rows, non-negative
    # weights, codes and scales (0 at CLS and padding)
    n_src = 0
    while index.size < HYB_LIVE:
        n = min(BLOCK, HYB_LIVE - index.size)
        v, ids, mask = random_chunks(torch, n, gen, dev, tok, cfg.vocab_size)
        real = mask.float()
        real[:, 0] = 0.0
        w = torch.rand((n, TOKEN_WIDTH), generator=gen, device=dev) * real
        c = torch.randint(-127, 128, (n, TOKEN_WIDTH, HYB_RANK), generator=gen, device=dev,
                          dtype=torch.int8)
        sc = torch.rand((n, TOKEN_WIDTH), generator=gen, device=dev) * (0.02 / 127) * real
        index.add_chunks([f"rand{n_src}:{i}" for i in range(n)], v, f"rand{n_src}",
                         token_ids=ids, token_mask=mask, token_weights=w,
                         colbert_codes=c * real[..., None].to(torch.int8), colbert_scales=sc)
        n_src += 1
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t
    require(index.size == HYB_LIVE, f"live rows {index.size}")
    smi = card()
    emit("hybrid_ingest", heads_s=heads_s, ingest_s=ingest_s, live_rows=index.size,
         capacity=HYB_CAPACITY, colbert_rank=HYB_RANK,
         colbert_bytes=index.tokens.colbert.codes.numel() + 4 * index.tokens.colbert.scales.numel(),
         card=smi)

    picks = rng.integers(0, TEXT_CHUNKS, REQUESTS)
    queries = [" ".join(texts[j].split()[3:15]) for j in picks]
    service = RetrievalService(index, embedder, CrossEncoderReranker(reranker, tok), top_k=TOP_K,
                               rerank_k=RERANK_K, lex_weight=HYB_LEX, colbert_weight=HYB_COLBERT)
    require(service.fused, "the service runs the fused path")
    serve_burst(service, queries[:MAX_BATCH])  # warm-up
    topk_int8.launches = 0
    answers, wall_s = serve_burst(service, queries)
    launches = topk_int8.launches
    require(launches > 0, "the hybrid burst launched the topk_int8 kernel")
    check_answers(np, answers, set())

    # one batch: the cached form against its plain composition
    qb = tok.batch(queries[:MAX_BATCH], TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
    q_ids = torch.as_tensor(qb.input_ids, device=dev)
    q_mask = torch.as_tensor(qb.attention_mask, device=dev)
    proj_t = torch.as_tensor(proj, device=dev)
    with torch.inference_mode():
        state, _ = index.snapshot()
        t_, cb = index.tokens.state, index.tokens.colbert
        common = (encoder, reranker, q_ids, q_mask, state.vectors, state.scales, state.penalty,
                  t_.ids, t_.mask, state.residual)
        cached = dict(top_k=TOP_K, rerank_k=RERANK_K, tok_weights=t_.weights,
                      tok_cvecs=cb.codes, tok_cscale=cb.scales, colbert_proj=proj_t,
                      lex_weight=HYB_LEX, colbert_weight=HYB_COLBERT)
        recompute = {**cached, "tok_cvecs": None, "tok_cscale": None, "colbert_proj": None}
        off = dict(top_k=TOP_K, rerank_k=RERANK_K)
        r_rows, _, _, idx, vals = fused_query(*common, **cached)
        # the composition, from the port's parts
        q_hidden, q_emb = encode_queries(encoder, q_ids, q_mask)
        qq, qs = quantize_rows_int8(q_emb)
        cand = topk_int8_plain(qq, qs, state.vectors, state.scales, CANDIDATES, state.penalty)
        pv, pi = rescore_candidates(q_emb, *cand, state.vectors, state.scales, TOP_K,
                                    state.penalty, state.residual)
        rows = pi.long()
        lex = lexical_overlap_scores(
            q_ids, sparse_weights_from_hidden(encoder, q_hidden, q_ids, q_mask), t_.ids[rows],
            t_.weights[rows])
        q_cb = colbert_vectors_from_hidden(encoder, q_hidden, q_mask) @ proj_t
        late = late_interaction_scores(q_cb, q_mask, cb.codes[rows].float() * cb.scales[rows][..., None])
        composed = pv + HYB_LEX * lex + HYB_COLBERT * late
        pairs = t_.ids[rows]
        pairs[:, :, 0] = tok.eos_id
        b, k = rows.shape
        rr = reranker(
            torch.cat([q_ids[:, None, :].expand(b, k, -1).to(pairs.dtype), pairs], 2).reshape(b * k, -1),
            torch.cat([q_mask[:, None, :].expand(b, k, -1).to(pairs.dtype), t_.mask[rows]], 2)
            .reshape(b * k, -1),
        ).reshape(b, k).masked_fill(composed <= NEG / 2, NEG)
        want_top3 = torch.gather(pi, 1, torch.sort(rr, dim=1, descending=True, stable=True)[1][:, :RERANK_K])
        live = pv > NEG / 2
        lex_share = float(((lex != 0) & live).sum() / live.sum())
        late_share = float(((late != 0) & live).sum() / live.sum())

        # timings of the batch, median of 5: the path with the terms off, the
        # cached and the recompute forms, and the cached form's stages
        timing = {
            "off_ms": cuda_ms(torch, lambda: fused_query(*common, **off), runs=5),
            "cached_ms": cuda_ms(torch, lambda: fused_query(*common, **cached), runs=5),
            "recompute_ms": cuda_ms(torch, lambda: fused_query(*common, **recompute), runs=5),
            "encode_ms": cuda_ms(torch, lambda: encode_queries(encoder, q_ids, q_mask), runs=5),
            "terms_ms": cuda_ms(torch, lambda: add_hybrid_terms(
                pv, encoder, q_hidden, q_ids, q_mask, t_.ids[rows], t_.mask[rows],
                t_.weights[rows], cb.codes[rows], cb.scales[rows], proj_t,
                lex_weight=HYB_LEX, colbert_weight=HYB_COLBERT), runs=5),
        }
        timing["scan_ms"] = cuda_ms(torch, lambda: int8_topk(
            *quantize_rows_int8(q_emb), state.vectors, state.scales, TOP_K, state.penalty,
            rescore_queries=q_emb, rescore_residual=state.residual), runs=5)
        timing["gather_rerank_ms"] = (timing["cached_ms"] - timing["encode_ms"]
                                      - timing["scan_ms"] - timing["terms_ms"])
        del state, t_, cb, common, cached, recompute
    require(torch.equal(idx, pi), "the hybrid retrieval rows equal the composition's")
    err = float((vals - composed)[live].abs().max())
    require(err <= HYB_TOL, f"hybrid retrieval values within {HYB_TOL} of the composition's: {err}")
    require(lex_share > 0.5 and late_share > 0.5,
            f"both terms non-zero for most live candidates ({lex_share}, {late_share})")
    require(torch.equal(r_rows, want_top3), "the rerank top-3 equals the composition's")
    out = {"topk_int8_launches": launches, "max_abs_err_vs_composition": err,
           "lexical_nonzero_share": lex_share, "late_nonzero_share": late_share,
           "stages": timing, "seconds": time.perf_counter() - t_phase, "card": smi,
           **latency_fields(answers, wall_s)}
    emit("hybrid", **out)
    del service, index, encoder, reranker, embedder
    return out


def unit_rows(torch, n: int, gen, dev):
    x = torch.randn((n, DIM), generator=gen, device=dev)
    return x.div_(x.norm(dim=1, keepdim=True))


def float_storage(torch, x, mode: str):
    """f32 rows ``x`` as ``mode`` stores them (and takes its queries)."""
    from outline_rag_tpu_torch.ops.topk import split_f32_bf16x2

    if mode == "fp32":
        return x
    if mode == "bf16":
        return x.to(torch.bfloat16)
    return split_f32_bf16x2(x)


def kernel_float_phase(torch, dev, seed: int) -> dict:
    from outline_rag_tpu_torch.index import VectorIndex
    from outline_rag_tpu_torch.ops.topk import (
        FLOAT_MODES,
        NEG,
        topk_float,
        topk_float_plain,
    )
    from outline_rag_tpu_torch.testing import tie_aware_mismatches

    from outline_rag_tpu_torch.ops.topk import topk_floor, topk_floor_plain
    from outline_rag_tpu_torch.tools.bench_topk_kernel import bench_mode

    g = torch.Generator(device=dev).manual_seed(seed + 3)
    out = {}
    floor_launches = 0  # counted over the tool's runs only
    for mode in FLOAT_MODES:
        # the corpus: seeded unit rows, N_DUPS copies of row src, 1% tombstones
        corpus = unit_rows(torch, N_ROWS, g, dev)
        src = int(torch.randint(0, N_ROWS, (1,), generator=g, device=dev))
        dups = torch.randperm(N_ROWS, generator=g, device=dev)[: N_DUPS + 1]
        dups = dups[dups != src][:N_DUPS]
        corpus[dups] = corpus[src].clone()
        anchor = corpus[src].clone()
        corpus = float_storage(torch, corpus, mode)
        torch.cuda.empty_cache()
        penalty = torch.where(torch.rand(N_ROWS, generator=g, device=dev) < 0.01, NEG, 0.0).float()
        penalty[dups] = 0.0
        penalty[src] = 0.0
        tied = sorted({src, *dups.tolist()})
        few_live = torch.full((N_ROWS,), NEG, device=dev)
        few_live[torch.randperm(N_ROWS, generator=g, device=dev)[:10]] = 0.0

        cases = [(b, k, penalty) for b in (1, 32, 128) for k in (12, 64)]
        cases.append((32, 64, few_live))
        max_err, timed = 0.0, {}
        for b, k, pen in cases:
            qf = unit_rows(torch, b, g, dev)
            qf[0] = anchor  # query 0 is row src: its copies tie at the top
            q = float_storage(torch, qf, mode)
            args = (q, corpus, k, pen, mode)
            vals, idx = topk_float(*args)
            torch.cuda.synchronize()
            # K + 1 columns: the tie-aware check knows the K-th slot's neighbour
            pv, pi = topk_float_plain(q, corpus, k + 1, pen, mode)
            err = float((vals - pv[:, :k]).abs().max())
            max_err = max(max_err, err)
            row = {
                "mode": mode, "B": b, "K": k, "live": int((pen == 0).sum()),
                "mismatches": tie_aware_mismatches(vals, idx, pv, pi, FLOAT_TOL),
                "idx_equal": bool(torch.equal(idx, pi[:, :k])), "max_abs_err": err,
            }
            require(row["mismatches"] == 0 and err <= FLOAT_TOL,
                    f"float kernel agrees with the plain version within {FLOAT_TOL} at {row}")
            if pen is penalty:
                head = min(k, len(tied))
                require(idx[0, :head].tolist() == tied[:head]
                        and bool((vals[0, :head] == vals[0, 0]).all()),
                        f"{mode}: the copies tie exactly and come lowest row first")
            else:
                require(bool((idx[:, 10:] == 0).all() and (vals[:, 10:] == NEG).all()),
                        f"{mode}: slots past the 10 live rows are (NEG, 0)")
            if k == 64 and b in (32, 128) and pen is penalty:
                row["ms"] = cuda_ms(torch, lambda: topk_float(*args))
                row["plain_ms"] = cuda_ms(torch, lambda: topk_float_plain(*args))
                if b == 32 and mode != "f32x2":
                    # a yardstick of two library calls, not the same function:
                    # torch.topk keeps no order among ties
                    row["library_pair_ms"] = cuda_ms(
                        torch, lambda: torch.topk(q @ corpus.T + pen, k, dim=1))
                timed[b] = row
            emit("kernel_float", **row)
        # the floors on the same corpus: against their twins, nomerge against
        # the full scan's best score, then the tool's timings (its launches
        # are the ones counted)
        q = float_storage(torch, unit_rows(torch, 32, g, dev), mode)
        floor_err = 0.0
        for variant in ("nomerge",) if mode == "f32x2" else ("nomerge", "matmul"):
            got = topk_floor(q, corpus, mode, variant)
            torch.cuda.synchronize()
            floor_err = max(floor_err, float(
                (got - topk_floor_plain(q, corpus, mode, variant)).abs().max()))
        best, _ = topk_float(q, corpus, TOP_K, None, mode)
        nomerge = topk_floor(q, corpus, mode)
        floor_row = {"max_abs_err": floor_err,
                     "nomerge_equals_scan_top": bool(torch.equal(nomerge, best[:, 0])),
                     "plain_ms": cuda_ms(torch, lambda: topk_floor_plain(q, corpus, mode), runs=3)}
        require(floor_err <= FLOAT_TOL, f"{mode}: topk_floor within {FLOAT_TOL} of its twin")
        require(floor_row["nomerge_equals_scan_top"],
                f"{mode}: the nomerge floor is bit-equal to the scan's best score")
        topk_floor.launches = 0
        floor_row.update(bench_mode(q, corpus, mode))
        floor_launches += topk_floor.launches
        emit("kernel_topk_floor", **floor_row)
        del corpus, penalty, few_live
        torch.cuda.empty_cache()

        # the index dtype that scans in this mode, through VectorIndex.query
        dtype = {"fp32": "float32", "bf16": "bfloat16", "f32x2": "f32x2"}[mode]
        index = VectorIndex(dim=DIM, capacity=1 << 16, dtype=dtype, device=dev)
        vecs = unit_rows(torch, 1 << 16, g, dev)
        index.add_chunks([f"v{i}" for i in range(1 << 16)], vecs, "s")
        before = topk_float.launches[mode]
        ids, _ = index.query(vecs[:8], TOP_K)
        require(topk_float.launches[mode] == before + 1, f"{dtype} index query launched the kernel")
        require([r[0] for r in ids] == [f"v{i}" for i in range(8)],
                f"{dtype} index: each stored row is its own top match")
        del index, vecs
        torch.cuda.empty_cache()
        # B = 32: the stored rows and the penalty read once; the operands are
        # f32 in fp32 mode and bf16 (hi/lo pairs, three products a pair, in
        # f32x2) otherwise, so each mode is held to its own type's peak
        row_bytes = {"fp32": 4, "bf16": 2, "f32x2": 4}[mode] * DIM
        products = 3 if mode == "f32x2" else 1
        out[mode] = {"max_abs_err": max_err, "ms": timed[32]["ms"],
                     "plain_ms": timed[32]["plain_ms"], "ms_b128": timed[128]["ms"],
                     "library_pair_ms": timed[32].get("library_pair_ms"),
                     "plain_ms_b128": timed[128]["plain_ms"],
                     **bound(N_ROWS * (row_bytes + 4) + 32 * row_bytes + 32 * 64 * 8,
                             2 * products * 32 * N_ROWS * DIM,
                             "f32" if mode == "fp32" else "bf16"),
                     **{key + "_b128": value for key, value in bound(
                         N_ROWS * (row_bytes + 4) + 128 * row_bytes + 128 * 64 * 8,
                         2 * products * 128 * N_ROWS * DIM,
                         "f32" if mode == "fp32" else "bf16").items()},
                     # the floor reads the rows and the queries and writes B maxima
                     "floor": {**floor_row, **bound(N_ROWS * row_bytes + 32 * row_bytes + 32 * 4,
                                                    2 * products * 32 * N_ROWS * DIM,
                                                    "f32" if mode == "fp32" else "bf16")}}
    require(floor_launches > 0, "the scan tool launched the topk_floor kernel")
    return out, floor_launches


def flash_phase(torch, dev, seed: int) -> dict:
    from outline_rag_tpu_torch.ops.attention import (
        NEG_BIAS,
        flash_attention,
        flash_attention_plain,
    )
    from outline_rag_tpu_torch.testing import flash_errors

    g = torch.Generator(device=dev).manual_seed(seed + 4)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}

    def case(b, s, lengths, dtype):
        """A row's live keys: the first n for an int, else a list of (from, to)
        spans (a bias that is no prefix mask)."""
        q, k, v = (torch.randn((b, s, FLASH_HEADS, 64), generator=g, device=dev)
                   .to(dtypes[dtype]) for _ in range(3))
        bias = torch.full((b, s), NEG_BIAS, device=dev)
        for i, live in enumerate(lengths):
            for lo, hi in ([(0, live)] if isinstance(live, int) else live):
                bias[i, lo:hi] = 0.0
        return q, k, v, bias

    cases = [(1, s, [s], "bf16") for s in (2048, 4096, 8192)]
    cases += [(2, 4096, [3000, 0], "bf16"), (1, 2048, [2048], "f32"),
              (1, 2048 + 37, [2048 + 37], "bf16"),  # S no multiple of a tile
              (1, 4096, [[(0, 1000), (3000, 3500)]], "bf16"),  # all-padding tiles in between
              (3, 2048, [2048, 0, [(5, 700)]], "bf16")]
    max_err, times = 0.0, {}
    for b, s, lengths, dtype in cases:
        args = case(b, s, lengths, dtype)
        out = flash_attention(*args)
        torch.cuda.synchronize()
        require(bool(torch.equal(out, flash_attention(*args))),
                f"flash: two runs are bit-equal at B={b} S={s} {dtype}")
        plain = flash_attention_plain(*args)
        atol, ulps, rel_rms = FLASH_BOUNDS[dtype]
        row = {"dtype": dtype, "B": b, "S": s, "H": FLASH_HEADS, "lengths": lengths,
               **flash_errors(out, plain, atol, ulps), "max_abs_plain": float(plain.abs().max())}
        if dtype == "bf16":
            max_err = max(max_err, row["max_abs_err"])
        require(row["worst_vs_bound"] <= 1.0 and row["rel_rms_err"] <= rel_rms,
                f"flash kernel within {atol} + {ulps} ulps, error norm within {rel_rms}, at {row}")
        for i, n in enumerate(lengths):
            if n == 0:
                require(bool((out[i] == 0).all()), "a row with no live key is exactly zero")
        if b == 1 and lengths == [s]:
            # ms: one launch through the wrapper; device_ms: many launches (at
            # S = 2,048 the kernel is shorter than the host's way to it). The
            # operands (12-50 MB) are as warm as the projections leave them.
            row.update(both_ms(torch, lambda: flash_attention(*args), runs=5))
            row["plain_ms"] = cuda_ms(torch, lambda: flash_attention_plain(*args), runs=5)
            row["kernel_tflops"] = 4 * s * s * 64 * FLASH_HEADS / row["device_ms"] / 1e9
            if dtype == "bf16":
                # the library yardstick, used nowhere in the port: one fused
                # attention call with the bias as an additive mask
                qh, kh, vh = (x.transpose(1, 2) for x in args[:3])
                mask = args[3].to(torch.bfloat16)[:, None, None, :]
                library = both_ms(
                    torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=mask), runs=5)
                row["library_ms"] = library["ms"]
                row["library_device_ms"] = library["device_ms"]
                if s in (2048, 4096, 8192):
                    times[s] = row
        emit("flash", **row)
        del args, out, plain
    top = 8192  # q, k, v read and the output written once; 4*S*S*D*H flops
    return {"max_abs_err": max_err, "ms": times[top]["ms"], "plain_ms": times[top]["plain_ms"],
            "library_ms": times[top]["library_ms"], "device_ms": times[top]["device_ms"],
            "library_device_ms": times[top]["library_device_ms"],
            **bound(4 * top * FLASH_HEADS * 64 * 2 + top * 4, 4 * top * top * 64 * FLASH_HEADS,
                    "bf16"),
            "by_S": {s: {key: r[key] for key in (
                "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms")}
                for s, r in times.items()}}


def long_lengths(rng) -> list[int]:
    """Words per document, LONG_DOCS_PER_BUCKET in each of the 2048, 4096
    and 8192 buckets, at least one 64-key tile clear of either bucket edge
    (so fully padded key tiles occur); the tokenizer adds CLS and EOS."""
    lengths = []
    for lo, hi in ((1024, 2048), (2048, 4096), (4096, 8192)):
        lengths += [int(n) for n in rng.integers(lo + 64, hi - 66, LONG_DOCS_PER_BUCKET)]
    return lengths


def long_phase(torch, dev, seed: int) -> dict:
    """Whole-document ingest through the flash kernel, then f32x2 serving."""
    import numpy as np

    import outline_rag_tpu_torch.models.encoder as encoder_module
    from outline_rag_tpu_torch.engine import (
        CrossEncoderReranker,
        EncoderEmbedder,
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
    from outline_rag_tpu_torch.ops.attention import flash_attention, flash_attention_plain
    from outline_rag_tpu_torch.ops.topk import (
        cosine_topk,
        split_f32_bf16x2,
        topk_float,
        topk_float_plain,
        topk_plain,
    )
    from outline_rag_tpu_torch.testing import tie_aware_mismatches

    cfg = EncoderConfig.bge_m3()
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    encoder = init_encoder(cfg, gen, dev)
    reranker = init_reranker(cfg, gen, dev)
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    embedder = EncoderEmbedder(encoder, tok, max_tokens=LONG_MAX_TOKENS)
    require(embedder.seq_buckets[-3:] == (2048, 4096, 8192), "whole-document bucket ladder")
    cross = CrossEncoderReranker(reranker, tok)
    rng = np.random.default_rng(seed + 5)
    vocab = [f"w{i}" for i in rng.permutation(50_000)[:20_000]]

    # one 8,192-token document through the encoder, kernel against twin: a
    # check that the kernel runs inside the encoder, not a test of attention
    # (random weights pull whole-document embeddings together; the flash
    # phase holds the kernel to the twin)
    doc = " ".join(rng.choice(vocab, LONG_MAX_TOKENS - 2))
    tb = tok.batch([doc], LONG_MAX_TOKENS, embedder.seq_buckets)
    require(tb.input_ids.shape == (1, LONG_MAX_TOKENS), "an 8,192-token document")
    ids = torch.as_tensor(tb.input_ids, device=dev)
    mask = torch.as_tensor(tb.attention_mask, device=dev)
    with torch.inference_mode():
        got = pooled_embeddings(encoder, ids, mask)
        encoder_module.flash_attention = flash_attention_plain
        try:
            want = pooled_embeddings(encoder, ids, mask)
        finally:
            encoder_module.flash_attention = flash_attention
        forward_ms = cuda_ms(torch, lambda: pooled_embeddings(encoder, ids, mask), runs=3)
    cosine = float((got * want).sum())
    emit("encoder_8192", cosine_kernel_vs_plain=cosine, forward_ms=forward_ms)
    require(cosine >= COSINE_MIN, f"pooled cosine {cosine} >= {COSINE_MIN}")

    index = VectorIndex(dim=DIM, capacity=CAPACITY, dtype="f32x2", device=dev,
                        token_width=TOKEN_WIDTH)
    oracle = torch.zeros((CAPACITY, DIM), dtype=torch.float32, device=dev)
    lengths = long_lengths(rng)
    docs = [" ".join(rng.choice(vocab, n)) for n in lengths]

    # the main path, counted from here: ingest, one document per embed call
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embed_s, tokens, padded = 0.0, 0, 0
    for i, text in enumerate(docs):
        t1 = time.perf_counter()
        vec = embedder.embed([text])
        embed_s += time.perf_counter() - t1
        width = tok.batch([text], LONG_MAX_TOKENS, embedder.seq_buckets).input_ids.shape[1]
        tokens += lengths[i] + 2
        padded += width
        tb = tok.batch([text], TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
        rows = index.add_chunks([f"long{i}:0"], vec, f"long{i}",
                                token_ids=tb.input_ids, token_mask=tb.attention_mask)
        oracle[torch.as_tensor(rows, device=dev)] = normalize_rows(torch.as_tensor(vec, device=dev))
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    flash_launches = flash_attention.launches
    require(flash_launches == len(docs) * cfg.layers,
            f"every layer of every document ran the flash kernel: {flash_launches}")
    emit("ingest_long", docs=len(docs), buckets=sorted(set(embedder.seq_buckets[-3:])),
         tokens=tokens, padded_tokens=padded, embed_s=embed_s, ingest_s=ingest_s,
         docs_per_s=len(docs) / ingest_s, tokens_per_s=tokens / embed_s,
         flash_launches=flash_launches)

    # seeded unit vectors with random token rows up to LIVE_ROWS
    positions = torch.arange(TOKEN_WIDTH, device=dev)
    n_src = 0
    t0 = time.perf_counter()
    while index.size < LIVE_ROWS:
        n = min(BLOCK, LIVE_ROWS - index.size)
        v = torch.randn((n, DIM), generator=gen, device=dev)
        lens = torch.randint(8, TOKEN_WIDTH + 1, (n, 1), generator=gen, device=dev)
        tmask = (positions[None, :] < lens).to(torch.int32)
        tids = torch.randint(3, cfg.vocab_size, (n, TOKEN_WIDTH), generator=gen, device=dev,
                             dtype=torch.int32)
        tids = torch.where(tmask.bool(), tids, tok.pad_id)
        tids[:, 0] = tok.cls_id
        rows = index.add_chunks([f"rand{n_src}:{i}" for i in range(n)], v, f"rand{n_src}",
                                token_ids=tids, token_mask=tmask)
        oracle[torch.as_tensor(rows, device=dev)] = normalize_rows(v)
        n_src += 1
    gone = len(docs) // 2
    require(index.delete_source(f"long{gone}") == 1, "delete_source removed the document")
    torch.cuda.synchronize()
    require(index.size == LIVE_ROWS - 1, f"live rows {index.size}")
    emit("ingest_vectors", seconds=time.perf_counter() - t0, live_rows=index.size,
         capacity=CAPACITY, dtype=index.dtype,
         device_mem_gb=torch.cuda.memory_allocated(dev) / 1e9)

    # serve_f32x2: phrases cut from the documents (the deleted one's too)
    picks = rng.integers(0, len(docs), REQUESTS)
    queries = []
    for j in picks:
        words = docs[j].split()
        at = int(rng.integers(0, len(words) - 12))
        queries.append(" ".join(words[at : at + 12]))
    service = RetrievalService(index, embedder, cross, top_k=TOP_K, rerank_k=RERANK_K)
    require(service.fused, "the service runs the fused path")
    serve_burst(service, queries[:MAX_BATCH])  # warm-up: cuBLAS handles, allocator
    topk_float.launches = dict.fromkeys(topk_float.launches, 0)
    answers, wall_s = serve_burst(service, queries)
    scan_launches = topk_float.launches["f32x2"]
    require(scan_launches > 0, "the main path launched the f32x2 topk_float kernel")
    require(flash_attention.launches == flash_launches, "queries (64 tokens) ran einsum attention")
    check_answers(np, answers, {f"long{gone}:0"})
    emit("serve_f32x2", **latency_fields(answers, wall_s), topk_float_f32x2_launches=scan_launches)

    # the retrieval stage of one batch, against the plain path and fp32
    tb = tok.batch(queries[:MAX_BATCH], TOKEN_WIDTH, buckets=(TOKEN_WIDTH,))
    q_ids = torch.as_tensor(tb.input_ids, device=dev)
    q_mask = torch.as_tensor(tb.attention_mask, device=dev)
    with torch.inference_mode():
        state, _ = index.snapshot()
        tokens_state = index.tokens.state
        _, _, _, idx, vals = fused_query(
            encoder, reranker, q_ids, q_mask, state.vectors, state.scales, state.penalty,
            tokens_state.ids, tokens_state.mask, top_k=TOP_K, rerank_k=RERANK_K,
        )
        q_emb = pooled_embeddings(encoder, q_ids, q_mask)
        pv, pi = topk_float_plain(split_f32_bf16x2(q_emb), state.vectors, TOP_K + 1,
                                  state.penalty, "f32x2")
        ov, oi = topk_plain(q_emb, oracle, TOP_K + 1, state.penalty)
        exact = torch.einsum("bkd,bd->bk", oracle[idx.long()], q_emb)  # fp32 scores of idx
        # the scan through VectorIndex.query for seeded unit queries, whose
        # exact top-12 is well separated, against fp32
        probe = unit_rows(torch, MAX_BATCH, gen, dev)
        probe_ids, _ = index.query(probe, TOP_K)
        _, probe_oi = topk_plain(probe, oracle, TOP_K, state.penalty)
        # fused_query's stages for this batch, median of 5 each: the encoder,
        # the scan, and the whole call (the rest is the token gather, the
        # cross-encoder and the final sort)
        stages = {
            "encode_ms": cuda_ms(torch, lambda: pooled_embeddings(encoder, q_ids, q_mask), runs=5),
            "scan_ms": cuda_ms(torch, lambda: cosine_topk(q_emb, state.vectors, TOP_K,
                                                          state.penalty), runs=5),
            "fused_ms": cuda_ms(torch, lambda: fused_query(
                encoder, reranker, q_ids, q_mask, state.vectors, state.scales, state.penalty,
                tokens_state.ids, tokens_state.mask, top_k=TOP_K, rerank_k=RERANK_K), runs=5),
        }
        stages["gather_rerank_ms"] = stages["fused_ms"] - stages["encode_ms"] - stages["scan_ms"]
    mismatches = tie_aware_mismatches(vals, idx, pv, pi, FLOAT_TOL)
    err = float((vals - pv[:, :TOP_K]).abs().max())
    hits = [len(set(a) & set(b[:TOP_K])) for a, b in zip(idx.tolist(), oi.tolist())]
    recall = sum(hits) / (TOP_K * len(hits))
    # random weights pull whole-document embeddings to within ~1e-6 of one
    # another, below f32x2's rounding: a row within FLOAT_TOL of the exact
    # 12th score is a tie there, and counts as a hit
    tie_recall = float((exact >= ov[:, TOP_K - 1 : TOP_K] - FLOAT_TOL).float().mean())
    row_of = index.snapshot()[1]
    probe_hits = [len(set(a) & {str(row_of[r]) for r in b})
                  for a, b in zip(probe_ids, probe_oi.tolist())]
    probe_recall = sum(probe_hits) / (TOP_K * len(probe_hits))
    emit("retrieval_f32x2", batch=len(hits), recall_at_12=recall,
         tie_aware_recall_at_12=tie_recall, vector_query_recall_at_12=probe_recall,
         mismatches_vs_plain=mismatches, max_abs_err_vs_plain=err,
         min_oracle_gap_12_13=float((ov[:, TOP_K - 1] - ov[:, TOP_K]).min()),
         stages=stages)
    require(mismatches == 0, "fused top-12 equals the plain path's (tie-aware)")
    require(recall >= RECALL_MIN, f"recall@12 {recall} >= {RECALL_MIN}")
    require(tie_recall >= RECALL_MIN, f"tie-aware recall@12 {tie_recall} >= {RECALL_MIN}")
    require(probe_recall >= RECALL_MIN, f"vector-query recall@12 {probe_recall} >= {RECALL_MIN}")
    return {"flash_launches": flash_attention.launches, "scan_launches": scan_launches}


def paged_case(torch, dev, g, b: int, t: int, kv: str, pos=None):
    """Seeded inputs of ``paged_attention`` at the decoder's shape: scattered
    page ids from a pool of KV_PAGES pages, row lengths from 1 to 2,047, and
    (at b > 2) inactive rows whose table is all 0."""
    from outline_rag_tpu_torch.testing import paged_attention_case

    return paged_attention_case(
        dev, g, b, t, kv, heads=DEC_HEADS, kv_heads=DEC_KV_HEADS, hd=DEC_HD, page=PAGE,
        maxp=MAXP, pages=KV_PAGES, pos=pos, inactive_every=7 if b > 2 else 0)


def paged_bound(b, t, kv, pos) -> dict:
    """What this run's rows need: each live K and V slot (and its scales)
    read once, q read and the output written once; 4 * H * Dh flops a slot
    a query position (slots past a position are masked but computed only up
    to the horizon: count the causal triangle)."""
    slots = [min(int(p) + t, MAXP * PAGE) for p in pos.tolist()]
    elem = 1 if kv == "int8" else 2
    moved = sum(slots) * DEC_KV_HEADS * 2 * (DEC_HD * elem + (4 if kv == "int8" else 0))
    moved += 2 * b * t * DEC_HEADS * DEC_HD * 2 + b * (MAXP + 1) * 4
    seen = sum(sum(min(int(p) + i + 1, MAXP * PAGE) for i in range(t)) for p in pos.tolist())
    return bound(moved, 4 * DEC_HEADS * DEC_HD * seen, "bf16")


def kernel_paged_phase(torch, dev, seed: int) -> dict:
    from outline_rag_tpu_torch.ops.paged_attention import paged_attention, paged_attention_plain
    from outline_rag_tpu_torch.testing import (
        SPLIT_BOUNDARY_POSITIONS,
        flash_errors,
        split_boundary_mismatches,
    )

    g = torch.Generator(device=dev).manual_seed(seed + 6)
    out = {}
    for kv in ("bf16", "int8"):
        atol, ulps, rel_rms = PAGED_BOUNDS[kv]
        # (8, 4): the verify window of speculative decoding at spec_k = 3
        cases = [(1, 1, None), (8, 1, None), (64, 1, None), (8, 4, None), (1, 256, [0]),
                 (1, 256, [512])]
        max_err = 0.0
        for b, t, pos in cases:
            args = paged_case(torch, dev, g, b, t, kv, pos)
            got = paged_attention(*args)
            torch.cuda.synchronize()
            again = paged_attention(*args)
            plain = paged_attention_plain(*args)
            row = {"pool": kv, "B": b, "T": t, "mean_len": float(args[4].float().mean()) + t,
                   **flash_errors(got, plain, atol, ulps),
                   "bit_equal_rerun": bool(torch.equal(got, again))}
            max_err = max(max_err, row["max_abs_err"])
            require(row["worst_vs_bound"] <= 1.0 and row["rel_rms_err"] <= rel_rms,
                    f"paged kernel within {atol} + {ulps} ulps, error norm within {rel_rms}: {row}")
            require(row["bit_equal_rerun"], f"two runs on the same inputs are bit-equal: {row}")
            require(bool(torch.isfinite(got.float()).all()), "inactive rows give finite numbers")
            emit("kernel_paged", **row)
        mismatches = split_boundary_mismatches(paged_attention, dev, g, kv)
        emit("kernel_paged", pool=kv, split_boundary_positions=list(SPLIT_BOUNDARY_POSITIONS),
             split_boundary_mismatches=mismatches)
        require(not mismatches, f"split-boundary positions are bit-equal across T and batch: "
                                f"{mismatches}")
        # timed at the shapes the main path launches: a decode step of B = 64
        # rows of lengths 1-2,047, a speculative window (B = 8, T = 4) and a
        # prefill chunk (B = 1, T = 256 from 512)
        lens = torch.randint(1, MAXP * PAGE, (DEC_SLOTS,), generator=g, device=dev)
        args = paged_case(torch, dev, g, DEC_SLOTS, 1, kv, lens - 1)
        spec = paged_case(torch, dev, g, 8, 4, kv)
        pre = paged_case(torch, dev, g, 1, 256, kv, [512])
        for a in (args, spec):  # every row active
            rows = a[3].shape[0]
            a[3][:] = (torch.randperm(KV_PAGES - 1, generator=g, device=dev)[: rows * MAXP]
                       + 1).reshape(rows, MAXP)
        # the pool is 268 MB and a step's live slots some 65 MB: past the L2 cache as it is
        row = {"pool": kv, "B": DEC_SLOTS, "T": 1, "mean_len": float(lens.float().mean()),
               **both_ms(torch, lambda: paged_attention(*args)),
               "plain_ms": cuda_ms(torch, lambda: paged_attention_plain(*args)),
               **paged_bound(DEC_SLOTS, 1, kv, args[4])}
        for label, (b, t, a) in (("spec_window", (8, 4, spec)), ("prefill_256", (1, 256, pre))):
            timed = both_ms(torch, lambda: paged_attention(*a))
            bnd = paged_bound(b, t, kv, a[4])
            row.update({f"{label}_ms": timed["ms"], f"{label}_device_ms": timed["device_ms"],
                        f"{label}_bound_ms": bnd["bound_ms"], f"{label}_bound_by": bnd["bound_by"]})
        emit("kernel_paged", **row)
        out[kv] = {"max_abs_err": max_err, **row}
        del args, spec, pre
        torch.cuda.empty_cache()
    return out


def kernel_kv_write_phase(torch, dev, seed: int) -> dict:
    from outline_rag_tpu_torch.ops.paged_attention import paged_kv_write, paged_kv_write_plain

    g = torch.Generator(device=dev).manual_seed(seed + 7)
    out = {}
    for kv in ("bf16", "int8"):
        dt = torch.int8 if kv == "int8" else torch.bfloat16
        shape = (KV_PAGES, DEC_KV_HEADS, PAGE, DEC_HD)

        def draw(*sh):
            return torch.randint(-127, 128, sh, generator=g, device=dev).to(dt)

        # (B, T, start): decode at 64 rows; a prefill chunk straddling pages; a
        # chunk whose tail passes the row's capacity (2,048) by 100 tokens
        for b, t, start in ((DEC_SLOTS, 1, None), (8, 4, None), (1, 256, 100),
                            (2, 256, MAXP * PAGE - 156)):
            pools = [draw(*shape), draw(*shape)]
            new = [draw(b, t, DEC_KV_HEADS, DEC_HD), draw(b, t, DEC_KV_HEADS, DEC_HD)]
            table = (torch.randperm(KV_PAGES - 1, generator=g, device=dev)[: b * MAXP] + 1)
            table = table.reshape(b, MAXP).to(torch.int32)
            pos = (torch.randint(0, MAXP * PAGE - t, (b,), generator=g, device=dev)
                   if start is None else torch.full((b,), start, device=dev)).to(torch.int32)
            scales = []
            if kv == "int8":
                scales = [torch.rand(sh, generator=g, device=dev) for sh in
                          (shape[:3], shape[:3], (b, t, DEC_KV_HEADS), (b, t, DEC_KV_HEADS))]
            want = paged_kv_write_plain(*(x.clone() for x in pools), table, pos, *new,
                                        *(x.clone() for x in scales))
            untouched = [x.clone() for x in pools]
            got = paged_kv_write(*pools, table, pos, *new, *scales)
            torch.cuda.synchronize()
            equal = all(torch.equal(a[1:], w[1:]) for a, w in zip(got, want))
            written = int((pools[0][1:] != untouched[0][1:]).any(dim=-1).sum())
            in_range = int(((pos.long()[:, None] + torch.arange(t, device=dev)) < MAXP * PAGE).sum())
            row = {"pool": kv, "B": b, "T": t, "start": start, "equal_but_page0": equal,
                   "max_abs_err": 0.0 if equal else 1.0,
                   "rows_written": written, "rows_in_range": in_range * DEC_KV_HEADS}
            require(equal, f"every page but page 0 byte-equal to the twin's: {row}")
            # a new row can equal the old one by chance (1 in 255^64): allow none
            require(written == in_range * DEC_KV_HEADS,
                    f"exactly the in-range tokens landed outside page 0: {row}")
            if (b, t) == (DEC_SLOTS, 1):
                args = (*pools, table, pos, *new, *scales)
                elem = 1 if kv == "int8" else 2
                moved = 2 * 2 * b * t * DEC_KV_HEADS * (DEC_HD * elem + (4 if scales else 0))
                row.update(**both_ms(torch, lambda: paged_kv_write(*args)),
                           plain_ms=cuda_ms(torch, lambda: paged_kv_write_plain(*args)),
                           **bound(moved + b * (MAXP + 1) * 4, 0, "bf16"))
                out[kv] = row
            emit("kernel_kv_write", **row)
        torch.cuda.empty_cache()
    return out


def kernel_int8_linear_phase(torch, dev, seed: int) -> dict:
    from outline_rag_tpu_torch.ops.int8_linear import (
        int8_linear,
        int8_linear_plain,
        quantize_linear_weight,
    )
    from outline_rag_tpu_torch.testing import flash_errors
    from outline_rag_tpu_torch.tools.timing import cold_ring

    g = torch.Generator(device=dev).manual_seed(seed + 8)
    shapes = [(64, 2048, 2560), (64, 2048, 2048), (64, 2048, 11264), (64, 5632, 2048),
              (64, 2048, 32000), (8, 2048, 2560), (8, 2048, 32000),
              # a 256-token prefill chunk at one row: M = 256 on all five widths
              (256, 2048, 2560), (256, 2048, 2048), (256, 2048, 11264), (256, 5632, 2048),
              (256, 2048, 32000)]
    out, max_err = {}, 0.0
    for m, k, n in shapes:
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        q, s = quantize_linear_weight(torch.randn((k, n), generator=g, device=dev) * 0.02)
        got = int8_linear(x, q, s)
        torch.cuda.synchronize()
        plain = int8_linear_plain(x, q, s)
        errs = flash_errors(got, plain, 1e-5 * float(plain.abs().max()), 1.0)
        max_err = max(max_err, errs["max_abs_err"])
        w_deq = (q.to(torch.bfloat16) * s.to(torch.bfloat16)[:, None])  # the yardstick's weight
        # device_ms: many launches over a ring of weights, each found cold as in a decode step
        ring, lib_ring = cold_ring(q, s), cold_ring(w_deq)
        library = both_ms(torch, lambda: torch.nn.functional.linear(x, w_deq),
                          lambda: torch.nn.functional.linear(x, next(lib_ring)[0]))
        row = {"M": m, "K": k, "N": n, **errs,
               **both_ms(torch, lambda: int8_linear(x, q, s),
                         lambda: int8_linear(x, *next(ring))),
               "plain_ms": cuda_ms(torch, lambda: int8_linear_plain(x, q, s)),
               "library_ms": library["ms"], "library_device_ms": library["device_ms"],
               **bound(n * k + n * 4 + m * k * 2 + m * n * 2, 2 * m * n * k, "bf16")}
        del ring, lib_ring
        row["weight_gb_per_s"] = n * k / row["ms"] / 1e6
        require(errs["worst_vs_bound"] <= 1.0,
                f"int8_linear within 1e-5 of the output's scale + 1 bf16 ulp of the twin: {row}")
        if m == 256:
            require(bool(torch.equal(int8_linear(x[:8], q, s), got[:8])),
                    f"int8_linear: 8 rows alone are bit-equal to the same rows at M = 256: {row}")
        emit("kernel_int8_linear", **row)
        out[(m, k, n)] = row

    def step(m: int, key: str) -> float:
        """A forward's 89 projections: 22 layers of q/k/v, o, gate/up and
        down, and the lm_head."""
        layer = ((2048, 2560), (2048, 2048), (2048, 11264), (5632, 2048))
        return 22 * sum(out[(m, k, n)][key] for k, n in layer) + out[(m, 2048, 32000)][key]

    steps = {f"{name}_m{m}": step(m, key) for m in (64, 256)
             for name, key in (("step_device_ms", "device_ms"),
                               ("step_library_device_ms", "library_device_ms"))}
    emit("kernel_int8_linear", **steps)
    return {"max_abs_err": max_err, **out[(64, 2048, 11264)], **steps, "by_shape": {
        f"{m}x{k}x{n}": {key: out[(m, k, n)][key] for key in (
            "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms")}
        for m, k, n in shapes}}


INT4_SHAPES = [  # (K, N, group size): TinyLlama's projections, two 7B ones, wider groups
    (2048, 2560, 128), (2048, 2048, 128), (2048, 11264, 128), (5632, 2048, 128),
    (2048, 32000, 128), (4096, 22016, 128), (11008, 4096, 128),
    (2048, 2560, 256), (2048, 2560, 512),
]
INT4_MS, INT4_TIMED_M = (1, 8, 32, 64, 256), 32
INT4_TOL = 1e-5  # of the output's scale, plus as much relative


def kernel_int4_phase(torch, dev, seed: int) -> dict:
    import outline_rag_tpu_torch.models.decoder as decoder
    import outline_rag_tpu_torch.ops.int4_linear as int4
    from outline_rag_tpu_torch.testing import QUANTIZER_TIE_CODES, quantizer_rows, scaled_errors
    from outline_rag_tpu_torch.tools.timing import cold_ring

    g = torch.Generator(device=dev).manual_seed(seed + 12)
    # the row quantizer against its twin: codes and scale bits, byte for byte
    quant_cases, quant_err, quant_scale_bits = 0, 0, 0
    for k in sorted({k for k, _, _ in INT4_SHAPES}):
        for dtype in (torch.bfloat16, torch.float32):
            for m in INT4_MS:
                x = quantizer_rows(dev, g, m, k, dtype)
                xq, xs = int4.quantize_rows(x)
                torch.cuda.synchronize()
                want_q, want_s = int4._quantize_activations(x)
                quant_err = max(quant_err, int((xq.int() - want_q.int()).abs().max()))
                quant_scale_bits += int((xs.view(torch.int32) != want_s.view(torch.int32)).sum())
                require(bool(torch.equal(xq, want_q)
                             and torch.equal(xs.view(torch.int32), want_s.view(torch.int32))),
                        f"quantize_rows is byte-equal to its twin at M={m} K={k} {dtype}: "
                        f"{int((xq != want_q).sum())} codes differ")
                floor = torch.tensor(1e-12, dtype=torch.float32, device=dev)
                require(bool(xs[0, 0] == floor) and not bool(xq[0].any()),
                        "a row of zeros has the scale's floor and codes 0")
                if m > 3:
                    require(float(xs[2, 0]) == 1.0 and xq[2, :8].tolist() == QUANTIZER_TIE_CODES,
                            f"exact .5 ties round to even: {xq[2, :8].tolist()}")
                    require(int(xq[1].min()) == -127 and int(xq[1].max()) <= 0,
                            "a row with a negative maximum reaches -127")
                quant_cases += 1
    emit("kernel_int4", quantize_rows_cases=quant_cases, max_abs_code_err=quant_err,
         scales_with_other_bits=quant_scale_bits)
    kernels = {
        "w4a8": (lambda x, q4, s4: int4.w4a8_matmul(x.to(torch.bfloat16), q4, s4),
                 lambda x, q4, s4: int4.w4a8_matmul_plain(x.to(torch.bfloat16), q4, s4)),
        "w4a16_bf16": (lambda x, q4, s4: int4.w4a16_matmul(x.to(torch.bfloat16), q4, s4),
                       lambda x, q4, s4: int4.w4a16_matmul_plain(x.to(torch.bfloat16), q4, s4)),
        "w4a16_f32": (lambda x, q4, s4: int4.w4a16_matmul(x, q4, s4),
                      lambda x, q4, s4: int4.w4a16_matmul_plain(x, q4, s4)),
    }
    out, max_err = {}, dict.fromkeys(kernels, 0.0)
    for k, n, gsz in INT4_SHAPES:
        w = torch.randn((k, n), generator=g, device=dev) * 0.02
        q4, s4 = int4.quantize_int4_weight(w, gsz)
        w_deq = int4._dequant(q4, s4, torch.bfloat16)  # the yardstick's weight, [N, K] bf16
        del w
        x = torch.randn((max(INT4_MS), k), generator=g, device=dev)
        row = {"K": k, "N": n, "group_size": gsz}
        for name, (kernel, twin) in kernels.items():
            worst, at_32 = 0.0, None
            for m in INT4_MS:
                got = kernel(x[:m], q4, s4)
                torch.cuda.synchronize()
                errs = scaled_errors(got, twin(x[:m], q4, s4), INT4_TOL)
                worst = max(worst, errs["worst_vs_bound"])
                max_err[name] = max(max_err[name], errs["max_abs_err"])
                require(errs["worst_vs_bound"] <= 1.0,
                        f"{name} within {INT4_TOL} of scale + {INT4_TOL} relative of its twin at "
                        f"M={m} {row}: {errs}")
                require(bool(torch.equal(got, kernel(x[:m], q4, s4))),
                        f"{name}: two runs are bit-equal at M={m} {row}")
                if name == "w4a8":
                    require(errs["max_abs_err"] == 0.0,
                            f"w4a8 is bit-equal to its twin at M={m} {row}: {errs}")
                    xb = x[:m].to(torch.bfloat16)
                    require(bool(torch.equal(int4._w4a8_matmul_as(xb, q4, s4, torch.bfloat16),
                                             got.to(torch.bfloat16))),
                            f"w4a8: the bf16 epilogue equals the f32 result rounded once at "
                            f"M={m} {row}")
                if name == "w4a16_bf16":
                    xb = x[:m].to(torch.bfloat16)
                    require(bool(torch.equal(int4._w4a16_matmul_as(xb, q4, s4, torch.bfloat16),
                                             got.to(torch.bfloat16))),
                            f"w4a16: the bf16 epilogue equals the f32 result rounded once at "
                            f"M={m} {row}")
                at_32 = got if m == 32 else at_32
            for r in (0, 31):
                require(bool(torch.equal(kernel(x[r : r + 1], q4, s4)[0], at_32[r])),
                        f"{name}: row {r} at M = 1 is bit-equal to itself inside M = 32 {row}")
            row[f"{name}_worst_vs_bound"] = worst
        # times at M = 32 (the wrappers as the decoder calls them), the plain
        # twins, the library yardstick and the grouped product beside them
        xb = x[:INT4_TIMED_M].to(torch.bfloat16)
        m = INT4_TIMED_M
        xq, xs = (t.contiguous() for t in int4._quantize_activations(xb))
        raw = torch.empty((m, n), dtype=torch.float32, device=dev)
        launch = int4._launcher("w4a8")

        def kernel_only(wq, ws):  # rows quantized beforehand (no count: not the wrapper)
            launch(xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(), raw.data_ptr(), 0,
                   m, n, k, gsz, torch.cuda.current_stream(dev).cuda_stream)

        # ms: one launch through the wrapper between two events, what the decoder
        # pays today; device_ms: many launches over a ring of weights, each found
        # cold as in a decode step (the ring spans three times the L2 cache)
        ring, lib_ring = cold_ring(q4, s4), cold_ring(w_deq)
        as_decoder = both_ms(torch, lambda: int4._w4a8_matmul_as(xb, q4, s4, torch.bfloat16),
                             lambda: int4._w4a8_matmul_as(xb, *next(ring), torch.bfloat16))
        alone = both_ms(torch, lambda: kernel_only(q4, s4), lambda: kernel_only(*next(ring)))
        quantizer = both_ms(torch, lambda: int4.quantize_rows(xb))
        a16 = both_ms(torch, lambda: int4._w4a16_matmul_as(xb, q4, s4, torch.bfloat16),
                      lambda: int4._w4a16_matmul_as(xb, *next(ring), torch.bfloat16))
        library = both_ms(torch, lambda: torch.nn.functional.linear(xb, w_deq),
                          lambda: torch.nn.functional.linear(xb, next(lib_ring)[0]))
        del ring, lib_ring
        row.update(
            # quantize + product, two launches, bf16 out: a projection of the decoder
            w4a8_ms=as_decoder["ms"], w4a8_device_ms=as_decoder["device_ms"],
            w4a8_queued_ms=as_decoder["queued_ms"],
            w4a8_kernel_only_ms=alone["ms"], w4a8_kernel_only_device_ms=alone["device_ms"],
            quantize_rows_ms=quantizer["ms"], quantize_rows_device_ms=quantizer["device_ms"],
            quantize_rows_plain_ms=cuda_ms(torch, lambda: int4._quantize_activations(xb)),
            w4a8_plain_ms=cuda_ms(torch, lambda: int4.w4a8_matmul_plain(xb, q4, s4)),
            w4a16_ms=a16["ms"], w4a16_device_ms=a16["device_ms"],
            w4a16_plain_ms=cuda_ms(
                torch, lambda: int4._w4a16_matmul_as_plain(xb, q4, s4, torch.bfloat16)),
            library_ms=library["ms"], library_device_ms=library["device_ms"],
        )
        read = n * k // 2 + s4.numel() * 4 + m * k * 2  # q4, s4 and the bf16 rows
        # the calls timed above write bf16, the decoder's epilogue
        row["w4a8_bound"] = bound(read + m * n * 2, 2 * m * n * k, "int8")
        row["w4a16_bound"] = bound(read + m * n * 2, 2 * m * n * k, "bf16")
        row["quantize_rows_bound"] = bound(m * k * 2 + m * k + m * 4, 4 * m * k, "f32")
        row["w4a8_weight_gb_per_s"] = n * k / 2 / row["w4a8_kernel_only_device_ms"] / 1e6
        mode = decoder._INT4_MODE
        decoder._INT4_MODE = "xla"  # the grouped product at every M
        try:
            for gm in (32, 64, 128):
                xg = x[:gm].to(torch.bfloat16)
                row[f"grouped_ms_m{gm}"] = cuda_ms(
                    torch, lambda: decoder._mm_int4(xg, q4, s4, torch.bfloat16), runs=5)
        finally:
            decoder._INT4_MODE = mode
        for gm in (64, 128):
            xg = x[:gm].to(torch.bfloat16)
            row[f"w4a8_ms_m{gm}"] = cuda_ms(torch, lambda: int4.w4a8_matmul(xg, q4, s4), runs=5)
        emit("kernel_int4", **row)
        out[(k, n, gsz)] = row
        del q4, s4, w_deq, x
        torch.cuda.empty_cache()
    top = out[(2048, 11264, 128)]  # the gate/up projection, as for int8_linear
    max_err["quantize_rows"] = float(quant_err)
    return {"max_abs_err": max_err, "quantize_rows_scales_with_other_bits": quant_scale_bits,
            "top": top, "by_shape": {
        f"{k}x{n}g{gsz}": {key: r[key] for key in (
            "w4a8_ms", "w4a8_device_ms", "w4a8_kernel_only_device_ms", "quantize_rows_device_ms",
            "w4a16_ms", "w4a16_device_ms", "library_ms", "library_device_ms", "grouped_ms_m32")}
        for (k, n, gsz), r in out.items()}}


def kernel_int4_floor_phase(torch, dev, seed: int) -> dict:
    import outline_rag_tpu_torch.ops.int4_linear as int4
    from outline_rag_tpu_torch.tools.bench_int4_kernel import bench_shape

    g = torch.Generator(device=dev).manual_seed(seed + 13)
    shapes = [(k, n) for k, n, gsz in INT4_SHAPES if gsz == 128]
    plain_ms, value_err, folds_differ = {}, 0.0, 0
    for k, n in shapes:
        q4 = torch.randint(0, 256, (n, k // 2), generator=g, device=dev, dtype=torch.uint8)
        x = torch.randn((INT4_TIMED_M, k), generator=g, device=dev).to(torch.bfloat16)
        value, fold = int4.int4_stream_floor(x, q4)
        torch.cuda.synchronize()
        want_value, want_fold = int4.int4_stream_floor_plain(x, q4)
        value_err = max(value_err, float((value - want_value).abs().max()))
        folds_differ += int((fold != want_fold).sum())
        require(bool(torch.equal(value, want_value) and torch.equal(fold, want_fold)),
                f"int4_stream_floor equals its twin exactly at K={k} N={n}")
        plain_ms[(k, n)] = cuda_ms(torch, lambda: int4.int4_stream_floor_plain(x, q4), runs=5)
    # the tool's run is the floor's main path: counted from here
    int4.int4_stream_floor.launches = 0
    out = {}
    for k, n in shapes:
        row = bench_shape(f"{k}x{n}", k, n, INT4_TIMED_M, dev)
        row.update(floor_plain_ms=plain_ms[(k, n)],
                   **bound(n * k // 2 + 2 + n * 8, 0, "int8"))  # q4, x[0, 0]; value and fold out
        row["floor_share_of_memory_rate"] = row["bound_ms"] / row["floor_device_ms"]
        emit("kernel_int4_floor", **row)
        out[(k, n)] = row
    launches = int4.int4_stream_floor.launches
    require(launches > 0, "the int4 tool launched the int4_stream_floor kernel")
    return {"launches": launches, "max_abs_err": value_err, "folds_that_differ": folds_differ,
            **out[(2048, 11264)], "by_shape": {
        f"{k}x{n}": {v: (r[f"{v}_ms"], r[f"{v}_device_ms"]) for v in
                     ("floor", "w4a16", "w4a8", "int8")}
        for (k, n), r in out.items()}}


def chat_messages(rng, system: str, vocab: list[str], n_tokens: int) -> list[dict]:
    """A chat whose rendered prompt is about ``n_tokens`` bytes long."""
    words, size = [], 0
    while size < n_tokens:
        words.append(str(rng.choice(vocab)))
        size += len(words[-1]) + 1
    user = " ".join(words)[: max(8, n_tokens)]
    head = [{"role": "system", "content": system}] if system else []
    return head + [{"role": "user", "content": user}]


def stream_burst(provider, chats: list[tuple[list[dict], float]]):
    """Every chat at once through ``provider.stream``:
    ([(text, seconds to the first delta, seconds)], wall seconds)."""

    async def one(messages, temperature):
        t0 = time.perf_counter()
        first, parts = None, []
        async for delta in provider.stream("local", messages, temperature=temperature, top_p=0.9):
            if first is None:
                first = time.perf_counter() - t0
            parts.append(delta["content"])
        return "".join(parts), first, time.perf_counter() - t0

    async def burst():
        t0 = time.perf_counter()
        got = await asyncio.wait_for(asyncio.gather(*(one(m, t) for m, t in chats)), 600)
        return got, time.perf_counter() - t0

    return asyncio.run(burst())


def logits_kernels_vs_twins(torch, dev, decoder, params, cfg, kv_dtype, seed: int) -> dict:
    """One prefill (4 rows x 64 tokens) and one decode forward through a
    small pool at the model's full depth, with the kernels and with the
    plain twins patched into the decoder module; the error's norm over the
    logits' norm, the larger of the two forwards."""
    from outline_rag_tpu_torch.ops.int8_linear import int8_linear_plain
    from outline_rag_tpu_torch.ops.paged_attention import (
        paged_attention_plain,
        paged_kv_write_plain,
    )

    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(3, cfg.vocab_size, (4, 64), generator=g, device=dev)
    step = torch.randint(3, cfg.vocab_size, (4, 1), generator=g, device=dev)

    def run():
        n = 4 * (cfg.max_cache // PAGE)  # every row's pages, scattered (7 and n are coprime)
        cache = decoder.init_paged_cache(cfg, 4, n + 1, PAGE, kv_dtype=kv_dtype, device=dev)
        cache.table[:] = (torch.arange(n, device=dev) * 7 % n + 1).reshape(4, -1)
        with torch.inference_mode():
            a, _ = decoder.decoder_forward(
                params, toks, cache, torch.zeros(4, dtype=torch.int32, device=dev), cfg)
            b, _ = decoder.decoder_forward(
                params, step, cache, torch.full((4,), 64, dtype=torch.int32, device=dev), cfg)
        return a, b

    got = run()
    kernels = (decoder.paged_attention, decoder.paged_kv_write, decoder.int8_linear)
    decoder.paged_attention = paged_attention_plain
    decoder.paged_kv_write = paged_kv_write_plain
    decoder.int8_linear = int8_linear_plain
    try:
        want = run()
    finally:
        decoder.paged_attention, decoder.paged_kv_write, decoder.int8_linear = kernels
    rel = max(float((a - w).norm() / w.norm()) for a, w in zip(got, want))
    worst = max(float((a - w).abs().max()) for a, w in zip(got, want))
    require(all(bool(torch.isfinite(a).all()) and a.shape[-1] == cfg.vocab_size for a in got),
            "finite logits over the vocabulary")
    return {"logits_rel_rms_vs_twins": rel, "logits_max_abs_err_vs_twins": worst,
            "logits_max_abs": float(want[0].abs().max())}


def int4_logits_check(torch, dev, decoder, params, cfg, seed: int) -> dict:
    """One 32-row decode step at the model's full depth, after a short
    prefill, three ways: as served; with the int4 kernels' plain twins
    patched into the decoder module (the paged kernels kept); with every
    twin patched in. The error's norm over the logits' norm."""
    import outline_rag_tpu_torch.ops.int4_linear as int4
    from outline_rag_tpu_torch.ops.paged_attention import (
        paged_attention_plain,
        paged_kv_write_plain,
    )

    rows = 32
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(3, cfg.vocab_size, (rows, 8), generator=g, device=dev)
    step = torch.randint(3, cfg.vocab_size, (rows, 1), generator=g, device=dev)
    n = rows * (cfg.max_cache // PAGE)

    def run(patches: dict):
        cache = decoder.init_paged_cache(cfg, rows, n + 1, PAGE, device=dev)
        cache.table[:] = (torch.arange(n, device=dev) * 7 % n + 1).reshape(rows, -1)
        kept = {name: getattr(decoder, name) for name in patches}
        for name, fn in patches.items():
            setattr(decoder, name, fn)
        try:
            with torch.inference_mode():
                decoder.decoder_forward(
                    params, toks, cache, torch.zeros(rows, dtype=torch.int32, device=dev), cfg)
                out, _ = decoder.decoder_forward(
                    params, step, cache, torch.full((rows,), 8, dtype=torch.int32, device=dev), cfg)
            return out
        finally:
            for name, fn in kept.items():
                setattr(decoder, name, fn)

    int4_twins = {"_w4a8_matmul_as": int4._w4a8_matmul_as_plain,
                  "_w4a16_matmul_as": int4._w4a16_matmul_as_plain}
    got = run({})
    want = run(int4_twins)
    every = run({**int4_twins, "paged_attention": paged_attention_plain,
                 "paged_kv_write": paged_kv_write_plain})
    require(bool(torch.isfinite(got).all()) and got.shape[-1] == cfg.vocab_size,
            "finite logits over the vocabulary")
    return {"logits_rel_rms_vs_int4_twins": float((got - want).norm() / want.norm()),
            "logits_rel_rms_vs_twins": float((got - every).norm() / every.norm()),
            "logits_bit_equal_vs_int4_twins": bool(torch.equal(got, want)),
            "logits_max_abs": float(want.abs().max())}


def spec_ceiling(torch, dev, decoder, params, cfg, seed: int) -> dict:
    """The all-accepted ceiling of speculative decoding: one chunk of
    ``generate_chunk_spec(force_accept=True)`` over 8 live rows at seeded
    lengths, every verify step emitting 1 + spec_k tokens whatever the model
    says. It changes the text and never serves; it says what a verify step
    would yield if every draft were right."""
    slots, spec_k = 8, 3
    g = torch.Generator(device=dev).manual_seed(seed)
    cache = decoder.init_paged_cache(cfg, slots, slots * MAXP + 1, PAGE, device=dev)
    cache.table[:] = (torch.randperm(slots * MAXP, generator=g, device=dev) + 1).reshape(slots, MAXP)
    pos = torch.randint(256, 1500, (slots,), generator=g, device=dev).to(torch.int32)
    tok = torch.randint(3, cfg.vocab_size, (slots,), generator=g, device=dev).to(torch.int32)
    buf = torch.randint(3, cfg.vocab_size, (slots, cfg.max_cache), generator=g, device=dev).to(
        torch.int32)

    def chunk():
        return decoder.generate_chunk_spec(
            params, cache, buf, tok, pos, decoder.make_key(seed, dev), cfg, n_steps=DEC_CHUNK,
            draft_k=spec_k, temperature=0.0, top_p=1.0, eos_id=-1, force_accept=True)

    with torch.inference_mode():
        ms = cuda_ms(torch, chunk, runs=3)
        counts = chunk()[1]
    per_step = float(counts.float().mean()) / DEC_CHUNK
    require(per_step == spec_k + 1, f"force_accept emits {spec_k + 1} tokens a step: {per_step}")
    return {"label": "force_accept ceiling, not served", "slots": slots, "spec_k": spec_k,
            "verify_step_ms": ms / DEC_CHUNK, "tokens_per_step": per_step,
            "ceiling_tokens_per_s": slots * per_step / (ms / DEC_CHUNK) * 1e3}


def decode_profile(torch, dev, decoder, params, cfg, kv_dtype, seed: int,
                   slots: int = DEC_SLOTS) -> dict:
    """Decode steps with all ``slots`` rows live at seeded lengths of
    256-1,900 tokens (every row its own 16 pages), through
    ``generate_chunk``: milliseconds a step from CUDA events over one chunk,
    then one chunk under ``torch.profiler`` for the device's busy share, the
    launches a step and the kernels that take the device's time."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(seed)
    cache = decoder.init_paged_cache(cfg, slots, KV_PAGES, PAGE, kv_dtype=kv_dtype, device=dev)
    cache.table[:] = (torch.randperm(KV_PAGES - 1, generator=g, device=dev)[: slots * MAXP]
                      + 1).reshape(slots, MAXP)
    pos = torch.randint(256, 1900, (slots,), generator=g, device=dev).to(torch.int32)
    tok = torch.randint(3, cfg.vocab_size, (slots,), generator=g, device=dev).to(torch.int32)
    temp = torch.where(torch.arange(slots, device=dev) % 3 == 2, 0.8, 0.0)
    key = decoder.make_key(seed, dev)

    def chunk():
        return decoder.generate_chunk(params, cache, tok, pos, key, cfg, n_steps=DEC_CHUNK,
                                      temperature=temp, top_p=0.9, eos_id=-1)

    with torch.inference_mode():
        step_ms = cuda_ms(torch, chunk, runs=3) / DEC_CHUNK
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            chunk()
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            kernels[e.key] = (us / 1e3, e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    # the busy share is the kernels' time over the step's time without the
    # profiler (tracing slows the host, not the kernels); None: the profiler
    # saw no device activity here (not measured)
    return {"decode_step_ms": step_ms, "mean_len": float(pos.float().mean()),
            "profiled_wall_ms_per_step": wall_ms / DEC_CHUNK,
            "device_busy_share": busy_ms / DEC_CHUNK / step_ms if busy_ms else None,
            "device_ms_per_step": busy_ms / DEC_CHUNK if busy_ms else None,
            "launches_per_step": sum(n for _, n in kernels.values()) / DEC_CHUNK,
            "top_kernels_ms_per_step": {k[:60]: ms / DEC_CHUNK for k, (ms, _) in top}}


def decoder_phase(torch, dev, seed: int) -> dict:
    """The slice: concurrent chats at TinyLlama-1.1B width through the paged
    pool, in seven configurations: bf16, an int8 pool and int8 weights at 64
    slots; int4 weights through the w4a8 and the w4a16 kernel at 32 slots;
    speculative decoding with bf16 and with int4 weights at 8 slots."""
    import numpy as np

    import outline_rag_tpu_torch.models.decoder as decoder
    import outline_rag_tpu_torch.serve.decode_batcher as batcher_module
    from outline_rag_tpu_torch.ops.int4_linear import quantize_rows, w4a8_matmul, w4a16_matmul
    from outline_rag_tpu_torch.ops.int8_linear import int8_linear
    from outline_rag_tpu_torch.ops.paged_attention import paged_attention, paged_kv_write
    from outline_rag_tpu_torch.serve import DONE, LocalChatProvider
    from outline_rag_tpu_torch.testing import ByteTokenizer

    require(decoder._INT8_MODE == "kernel", "DECODER_INT8_MODE=kernel was read at import")
    require(decoder._INT4_MODE == "w4a8", "DECODER_INT4_MODE=w4a8 was read at import")
    cfg = decoder.DecoderConfig.tinyllama_1b()
    t0 = time.perf_counter()
    params = decoder.init_decoder(cfg, torch.Generator(device=dev).manual_seed(seed + 9), dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in [params["embed"], params["lm_head"]]
                   + [v for layer in params["layers"] for v in layer.values()])
    emit("decoder_init", params=n_params, seconds=time.perf_counter() - t0,
         device_mem_gb=torch.cuda.memory_allocated(dev) / 1e9)
    class CountingTokenizer(ByteTokenizer):
        """Remembers how many ids each stream has decoded so far (a stream
        decodes its one growing list), so a burst's tokens can be counted."""

        def __init__(self):
            self.lengths = {}

        def decode(self, ids):
            self.lengths[id(ids)] = len(ids)
            return super().decode(ids)

    tok = CountingTokenizer()
    rng = np.random.default_rng(seed + 9)
    vocab = [f"w{i}" for i in rng.permutation(20_000)[:5000]]
    system = " ".join(rng.choice(vocab, 200))[:504]  # "system: " + 504 bytes = 4 full pages

    # forwards by rows fed (B * T), and the int8 kernel's launches inside
    # them: the batcher's name serves prefill chunks and plain steps, the
    # decoder module's the speculative verify windows
    forwards: dict[int, int] = {}
    int8_by_rows: dict[int, int] = {}
    real_forward = batcher_module.decoder_forward

    def counted_forward(p, tokens, *args, **kwargs):
        rows, before = tokens.numel(), int8_linear.launches
        forwards[rows] = forwards.get(rows, 0) + 1
        try:
            return real_forward(p, tokens, *args, **kwargs)
        finally:
            int8_by_rows[rows] = int8_by_rows.get(rows, 0) + int8_linear.launches - before

    def patch_forward(fn):
        batcher_module.decoder_forward = decoder.decoder_forward = fn

    # (name, provider options, slots, chats, new tokens, DECODER_INT4_MODE)
    configs = [("bf16", {}, DEC_SLOTS, DEC_SLOTS, DEC_NEW, "w4a8"),
               ("kv_int8", {"kv_int8": True}, DEC_SLOTS, DEC_SLOTS, DEC_NEW, "w4a8"),
               ("int8_weights", {"int8_weights": True}, DEC_SLOTS, 16, 32, "w4a8"),
               ("int4_weights", {"int4_weights": True}, 32, 32, DEC_NEW, "w4a8"),
               ("int4_kernel", {"int4_weights": True}, 32, 8, DEC_NEW, "kernel"),
               ("spec", {"spec_k": 3}, 8, 8, DEC_NEW, "w4a8"),
               ("spec_int4", {"spec_k": 3, "int4_weights": True}, 8, 8, DEC_NEW, "w4a8")]
    out = {}
    shared_rng = rng  # the first three configurations draw their chats from one stream
    # each later pair serves the same chats (a burst of 8 is the first 8 of 32)
    pair_seed = {"int4_weights": 20, "int4_kernel": 20, "spec": 21, "spec_int4": 21}
    for name, kw, slots, n_chats, max_new, int4_mode in configs:
        # the mode is a module attribute read at import; switching it here is
        # what the CPU tests do (monkeypatch), undone at the end of the config
        decoder._INT4_MODE = int4_mode
        int4, spec_k = "int4_weights" in kw, kw.get("spec_k", 0)
        rows_fed = slots * (1 + spec_k)  # what one decode forward feeds
        rng = (np.random.default_rng(seed + pair_seed[name]) if name in pair_seed
               else shared_rng)
        provider = LocalChatProvider(
            params, cfg, tok, batch_slots=slots, kv_pages=KV_PAGES, page_size=PAGE,
            chunk_tokens=DEC_CHUNK, max_new_tokens=max_new, device=dev, **kw)
        b = provider._batcher
        if int4:
            check = int4_logits_check(torch, dev, decoder, provider.params, cfg, seed + 10)
            # w4a8 is bit-equal to its twin (exact integers, one f32 order); the
            # w4a16 kernel's f32 sums run in another order, which flips bf16
            # roundings through 22 layers like the other bf16 kernels'
            int4_bound = 0.0 if int4_mode == "w4a8" else LOGITS_REL_RMS
            require(check["logits_rel_rms_vs_int4_twins"] <= int4_bound
                    and check["logits_rel_rms_vs_twins"] <= INT4_LOGITS_REL_RMS,
                    f"{name}: logits with the int4 kernels within {int4_bound} of their twins', "
                    f"within {INT4_LOGITS_REL_RMS} with every twin: {check}")
        else:
            check = logits_kernels_vs_twins(
                torch, dev, decoder, provider.params, cfg, "int8" if kw.get("kv_int8") else None,
                seed + 10)
            require(check["logits_rel_rms_vs_twins"] <= LOGITS_REL_RMS,
                    f"{name}: logits with the kernels within {LOGITS_REL_RMS} of the twins': {check}")

        def make_chats():
            chats = []
            for i in range(n_chats):
                shared = i % 4 != 3  # 3 in 4 carry the system prefix
                n = int(rng.integers(600, 1500)) if shared else int(rng.integers(200, 500))
                messages = chat_messages(
                    rng, system if shared else "", vocab, n - (520 if shared else 20))
                chats.append((messages, 0.8 if i % 3 == 2 else 0.0))
            return chats, [len(provider._encode_prompt(provider._render(m))) for m, _ in chats]

        chats, prompt_tokens = make_chats()
        same_as_plain = None
        if spec_k:
            # the same chats without speculation, for the share of greedy
            # texts that come out equal (printed, not gated)
            plain = LocalChatProvider(
                params, cfg, tok, batch_slots=slots, kv_pages=KV_PAGES, page_size=PAGE,
                chunk_tokens=DEC_CHUNK, max_new_tokens=max_new, device=dev,
                **{k: v for k, v in kw.items() if k != "spec_k"})
            try:
                plain_answers, _ = stream_burst(plain, chats)
            finally:
                plain.close()
            del plain
            torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats(dev)
        patch_forward(counted_forward)
        forwards.clear()
        int8_by_rows.clear()
        paged_attention.launches = paged_kv_write.launches = int8_linear.launches = 0
        w4a8_matmul.launches = w4a16_matmul.launches = quantize_rows.launches = 0
        tok.lengths.clear()
        try:
            answers, wall_s = stream_burst(provider, chats)
            generated = sum(tok.lengths.values())
            launches = (paged_attention.launches, paged_kv_write.launches, int8_linear.launches,
                        w4a8_matmul.launches, w4a16_matmul.launches)
            quantizer_launches = quantize_rows.launches
            by_rows, int8_launches_by_rows = dict(forwards), dict(int8_by_rows)
            n_forwards = sum(by_rows.values())
            decode_forwards = by_rows.get(rows_fed, 0)
            stats = provider.stats()
            # after the burst: the first greedy chat again (its prefix pages are
            # cached now, its neighbours gone), and one prompt twice over
            # the batcher's own interface, cold then warm
            repeat, _ = stream_burst(provider, [chats[0]])
            fresh = [int(x) for x in rng.integers(3, 259, 700)]
            pair = []
            for _ in range(2):
                q, ids = b.submit(fresh, 0.0, 1.0, 32), []
                while (item := q.get(timeout=300)) is not DONE:
                    require(not isinstance(item, Exception), f"{name}: the batcher failed: {item!r}")
                    ids.extend(item)
                pair.append(ids)
            end = provider.stats()
            patch_forward(real_forward)

            # a second burst of new chats, outside the counts and the end-to-end
            # numbers, with the worker's two device programs timed where it
            # runs them; the synchronize calls take away the overlap of host
            # and device, so nothing end to end is read from this burst
            steps, prefills = [], []
            step_name = "_step_spec" if spec_k else "_step_chunk"
            real_step, real_prefill = getattr(b, step_name), b._prefill_paged

            def timed_step(*a, _real=real_step, _b=b):
                active = sum(r is not None for r in _b.active)
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = _real(*a)
                torch.cuda.synchronize()
                steps.append((active, (time.perf_counter() - t) / DEC_CHUNK))
                return res

            def timed_prefill(table, toks, start, _real=real_prefill):
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = _real(table, toks, start)
                torch.cuda.synchronize()
                prefills.append(time.perf_counter() - t)
                return res

            setattr(b, step_name, timed_step)
            b._prefill_paged = timed_prefill
            timed_chats, timed_prompt_tokens = make_chats()
            timed_answers, timed_wall_s = stream_burst(provider, timed_chats)
            timed_hits = provider.stats()["prefix_hits"] - end["prefix_hits"]
        finally:
            patch_forward(real_forward)
            decoder._INT4_MODE = "w4a8"
            provider.close()
        require(len(timed_answers) == n_chats and all(text for text, _, _ in timed_answers),
                f"{name}: every stream of the timed burst ended and yielded text")
        require(len(answers) == n_chats and all(text and first is not None
                                                for text, first, _ in answers),
                f"{name}: every stream ended and yielded text")
        require(launches[0] == launches[1] == cfg.layers * n_forwards and n_forwards > 0,
                f"{name}: paged_attention and paged_kv_write ran {cfg.layers} times in each of "
                f"{n_forwards} forwards: {launches}")
        per_forward = 4 * cfg.layers + 1
        require(launches[2] == (per_forward * n_forwards if "int8_weights" in kw else 0)
                and sum(int8_launches_by_rows.values()) == launches[2],
                f"{name}: int8_linear ran {per_forward} times a forward, each launch inside "
                f"one: {launches[2]}, {int8_launches_by_rows}")
        # int4: the kernel in every projection of every decode forward (32 rows
        # fed), never in a prefill chunk (256 rows: the grouped product)
        want_int4 = per_forward * decode_forwards if int4 else 0
        want = (want_int4, 0) if int4_mode == "w4a8" else (0, want_int4)
        require(launches[3:] == want and (decode_forwards > 0 or not (int4 or spec_k)),
                f"{name}: the int4 kernels ran {per_forward} times in each of {decode_forwards} "
                f"decode forwards and in no prefill chunk: {launches[3:]}, forwards {by_rows}")
        # a w4a8 projection is two launches: the row quantizer and the product
        require(quantizer_launches == launches[3],
                f"{name}: the row quantizer ran once a w4a8 product: {quantizer_launches} "
                f"and {launches[3]}")
        if spec_k:
            require(set(by_rows) <= {rows_fed, 256} and decode_forwards > 0,
                    f"{name}: every decode forward was a verify window of T = {1 + spec_k}: "
                    f"{by_rows}")
            require(end["spec_tokens_per_step"] is not None and end["spec_tokens_per_step"] >= 1.0,
                    f"{name}: spec_tokens_per_step >= 1: {end}")
            greedy = [i for i, (_, temperature) in enumerate(chats) if temperature == 0.0]
            same_as_plain = sum(answers[i][0] == plain_answers[i][0] for i in greedy) / len(greedy)
        require(stats["prefix_hits"] > 0, f"{name}: the shared system prefix hit the cache")
        require(repeat[0][0] == answers[0][0], f"{name}: a warm repeat equals the cold answer")
        require(pair[0] == pair[1] and len(pair[0]) > 0,
                f"{name}: cold and warm token streams are equal: {pair}")
        require(end["prefix_hits"] >= stats["prefix_hits"] + 4 + 5,
                f"{name}: the repeats found their prompt pages in the cache: {end}")
        require(end["active"] == 0 and end["queued"] == 0
                and end["pages_free"] + end["pages_cached"] == end["pages_total"],
                f"{name}: every page is free or cached at the end: {end}")
        firsts = sorted(first for _, first, _ in answers)
        full = [ms for active, ms in steps if active == max(a for a, _ in steps)]
        out_chars = sum(len(text) for text, _, _ in answers)
        row = {"config": name, "chats": n_chats, "slots": slots, "max_new_tokens": max_new,
               "int4_mode": int4_mode if int4 else None, "spec_k": spec_k,
               "prompt_tokens": sum(prompt_tokens), "wall_s": wall_s,
               "ttft_p50_ms": 1e3 * firsts[len(firsts) // 2],
               "ttft_p95_ms": 1e3 * firsts[min(len(firsts) - 1, int(0.95 * len(firsts)))],
               "generated_tokens": generated, "output_chars": out_chars,
               "tokens_per_s": generated / wall_s,
               "decode_step_ms": 1e3 * statistics.median(full),
               "decode_step_rows": max(a for a, _ in steps), "decode_chunks": len(steps),
               "prefill_chunks": len(prefills),
               "prefill_tokens_per_s": (sum(timed_prompt_tokens) - PAGE * timed_hits)
               / sum(prefills),
               "timed_burst_wall_s": timed_wall_s,
               "forwards": n_forwards, "paged_attention_launches": launches[0],
               "paged_kv_write_launches": launches[1], "int8_linear_launches": launches[2],
               # the int8 kernel's launches counted inside the decode forwards
               # (64 rows fed); the rest were inside prefill chunks
               "int8_linear_decode_launches": int8_launches_by_rows.get(rows_fed, 0),
               "w4a8_launches": launches[3], "w4a16_launches": launches[4],
               "quantize_rows_launches": quantizer_launches,
               "decode_forwards": decode_forwards, "forwards_by_rows_fed": by_rows,
               "spec_tokens_per_step": end.get("spec_tokens_per_step"),
               "greedy_texts_equal_to_plain_share": same_as_plain,
               "prefix_hits": stats["prefix_hits"], "prefix_lookups": stats["prefix_lookups"],
               "backpressure_waits": stats["backpressure_waits"],
               "pages_cached_at_end": end["pages_cached"], "kv_dtype": stats["kv_dtype"],
               "peak_device_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9, **check}
        emit("decoder", **row)
        out[name] = row
        run_params = provider.params
        del provider, b, real_step, real_prefill, timed_step, timed_prefill  # frees the pool
        torch.cuda.empty_cache()
        decoder._INT4_MODE = int4_mode
        try:
            if spec_k:
                if not int4:
                    emit("spec_ceiling", config=name,
                         **spec_ceiling(torch, dev, decoder, run_params, cfg, seed + 11))
            else:
                emit("decode_profile", config=name, slots=slots, **decode_profile(
                    torch, dev, decoder, run_params, cfg, "int8" if kw.get("kv_int8") else None,
                    seed + 11, slots))
        finally:
            decoder._INT4_MODE = "w4a8"
        del run_params
        torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    # the decoder reads its int8 strategy once, at import: the w8a16 kernel
    os.environ["DECODER_INT8_MODE"] = "kernel"
    os.environ["DECODER_INT4_MODE"] = "w4a8"  # and its int4 strategy (the default)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from outline_rag_tpu_torch.device import resolve_device
    from outline_rag_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    from outline_rag_tpu_torch.tools.timing import card

    smi = card()
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
    launches, handover = slice_phase(torch, dev, args.seed)
    life = lifecycle_phase(torch, dev, args.seed, handover)
    models = (handover["service"].embedder, handover["service"].reranker)
    slice_p50_ms = handover["serve_p50_ms"]
    del handover  # the index, service and oracle of both phases
    torch.cuda.empty_cache()
    web = http_phase(torch, dev, args.seed, *models, slice_p50_ms)
    del models
    torch.cuda.empty_cache()
    floats, scan_floor_launches = kernel_float_phase(torch, dev, args.seed)
    flash = flash_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()
    long = long_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()
    paged = kernel_paged_phase(torch, dev, args.seed)
    kv_write = kernel_kv_write_phase(torch, dev, args.seed)
    linear = kernel_int8_linear_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()
    int4 = kernel_int4_phase(torch, dev, args.seed)
    int4_floor = kernel_int4_floor_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()
    chat = decoder_phase(torch, dev, args.seed)
    torch.cuda.empty_cache()
    hybrid = hybrid_phase(torch, dev, args.seed)
    entry_phase()

    # ms / plain_ms / bound_ms: topk_* at B = 32, K = 64 (topk_int8's B = 128
    # and K = 12 beside them, its shared headers under "headers"; topk_float in the
    # f32x2 mode the path runs; every mode under "modes"); flash_attention at
    # S = 8192; paged_attention and paged_kv_write at B = 64, T = 1 on a bf16
    # pool; int8_linear at the gate/up projection, M = 64; w4a8_matmul (the
    # row quantizer and the product, as the decoder runs a projection),
    # quantize_rows, w4a16_matmul (bf16) and int4_stream_floor at the gate/up
    # projection, M = 32 (launches: the int4_weights and int4_kernel bursts,
    # and the int4 tool's run). device_ms / library_device_ms, for the kernels
    # of under 0.3 ms: many launches over a ring of cold weights, where ms is
    # one launch through the wrapper; topk_floor in its f32x2 nomerge variant at B = 32
    # (launches: the scan tool's runs over the three modes). library_ms: one
    # PyTorch call computing the same function, where there is one (no single
    # call scans with a penalty and selects, walks a page table, or scatters
    # by one); for topk_int8 the yardstick of two calls, torch._int_mm then
    # torch.topk (null, with library_error, where _int_mm refuses the shape);
    # launches: the count over that kernel's main-path run; topk_int8's
    # launches_lifecycle and launches_hybrid: its counts over the bursts of
    # those phases; launches_http (topk_int8, paged_attention,
    # paged_kv_write): the counts over the http phase's burst of asks.
    print(json.dumps({"kernels": [{
        "name": "topk_int8", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/topk_int8.cu",
        "headers": ["outline_rag_tpu_torch/csrc/topk_float_tile.cuh",
                    "outline_rag_tpu_torch/csrc/topk_common.cuh"],
        "replaces": "outline_rag_tpu/ops/topk.py:346",
        "launches": launches, "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
        "library_ms": kernel["library_pair_ms"],
        **{key: kernel[key] for key in ("device_ms", "ms_b128", "device_ms_b128", "plain_ms_b128",
                                        "bound_ms_b128", "bound_by_b128", "ms_k12",
                                        "library_error")
           if key in kernel},
        "launches_lifecycle": life["launches"],
        "launches_hybrid": hybrid["topk_int8_launches"],
        "launches_http": web["launches"]["topk_int8"],
    }, {
        "name": "topk_float", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/topk_float.cu",
        "replaces": "outline_rag_tpu/ops/topk.py:346",
        "launches": long["scan_launches"],
        "max_abs_err": max(m["max_abs_err"] for m in floats.values()),
        "ms": floats["f32x2"]["ms"], "plain_ms": floats["f32x2"]["plain_ms"],
        "bound_ms": floats["f32x2"]["bound_ms"], "bound_by": floats["f32x2"]["bound_by"],
        "library_ms": None, "modes": floats,
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/flash_attention.cu",
        "replaces": "outline_rag_tpu/ops/attention.py:43",
        "launches": long["flash_launches"], "max_abs_err": flash["max_abs_err"],
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"], "device_ms": flash["device_ms"],
        "library_device_ms": flash["library_device_ms"], "by_S": flash["by_S"],
    }, {
        "name": "paged_attention", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/paged_attention.cu",
        "replaces": "outline_rag_tpu/ops/paged_attention.py:679",
        "launches": chat["bf16"]["paged_attention_launches"],
        "max_abs_err": max(p["max_abs_err"] for p in paged.values()),
        "ms": paged["bf16"]["ms"], "plain_ms": paged["bf16"]["plain_ms"],
        "bound_ms": paged["bf16"]["bound_ms"], "bound_by": paged["bf16"]["bound_by"],
        "library_ms": None, "device_ms": paged["bf16"]["device_ms"], "library_device_ms": None,
        "int8_pool": {k: paged["int8"][k] for k in
                      ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        **{f"{label}_{key}": paged["bf16"][f"{label}_{key}"]
           for label in ("spec_window", "prefill_256")
           for key in ("ms", "device_ms", "bound_ms", "bound_by")},
        "launches_http": web["launches"]["paged_attention"],
    }, {
        "name": "paged_kv_write", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/paged_kv_write.cu",
        "replaces": "outline_rag_tpu/ops/paged_attention.py:892",
        "launches": chat["bf16"]["paged_kv_write_launches"],
        "max_abs_err": max(w["max_abs_err"] for w in kv_write.values()),
        "ms": kv_write["bf16"]["ms"], "plain_ms": kv_write["bf16"]["plain_ms"],
        "bound_ms": kv_write["bf16"]["bound_ms"], "bound_by": kv_write["bf16"]["bound_by"],
        "library_ms": None, "device_ms": kv_write["bf16"]["device_ms"],
        "library_device_ms": None, "launches_http": web["launches"]["paged_kv_write"],
    }, {
        "name": "int8_linear", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/int8_linear.cu",
        "replaces": "outline_rag_tpu/ops/int8_linear.py:94",
        "launches": chat["int8_weights"]["int8_linear_launches"],
        "max_abs_err": linear["max_abs_err"],
        "ms": linear["ms"], "plain_ms": linear["plain_ms"],
        "bound_ms": linear["bound_ms"], "bound_by": linear["bound_by"],
        "library_ms": linear["library_ms"], "device_ms": linear["device_ms"],
        "library_device_ms": linear["library_device_ms"], "by_shape": linear["by_shape"],
        **{key: linear[key] for key in linear if key.startswith("step_")},
        "decode_launches": chat["int8_weights"]["int8_linear_decode_launches"],
    }, {
        "name": "w4a8_matmul", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/int4_linear.cu",
        "replaces": "outline_rag_tpu/ops/int4_linear.py:203",
        "launches": chat["int4_weights"]["w4a8_launches"],
        "max_abs_err": int4["max_abs_err"]["w4a8"],
        "ms": int4["top"]["w4a8_ms"], "plain_ms": int4["top"]["w4a8_plain_ms"],
        **int4["top"]["w4a8_bound"], "library_ms": int4["top"]["library_ms"],
        "device_ms": int4["top"]["w4a8_device_ms"],
        "library_device_ms": int4["top"]["library_device_ms"],
        "kernel_only_ms": int4["top"]["w4a8_kernel_only_ms"],
        "kernel_only_device_ms": int4["top"]["w4a8_kernel_only_device_ms"],
        "by_shape": int4["by_shape"],
        "launches_with_speculation": chat["spec_int4"]["w4a8_launches"],
    }, {
        "name": "quantize_rows", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/int4_linear.cu",
        "replaces": "outline_rag_tpu/ops/int4_linear.py:190",
        "launches": chat["int4_weights"]["quantize_rows_launches"],
        "max_abs_err": int4["max_abs_err"]["quantize_rows"],  # the largest code difference
        "scales_with_other_bits": int4["quantize_rows_scales_with_other_bits"],
        "ms": int4["top"]["quantize_rows_ms"], "plain_ms": int4["top"]["quantize_rows_plain_ms"],
        **int4["top"]["quantize_rows_bound"], "library_ms": None,
        "device_ms": int4["top"]["quantize_rows_device_ms"], "library_device_ms": None,
    }, {
        "name": "w4a16_matmul", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/int4_linear.cu",
        "replaces": "outline_rag_tpu/ops/int4_linear.py:409",
        "launches": chat["int4_kernel"]["w4a16_launches"],
        "max_abs_err": max(int4["max_abs_err"]["w4a16_bf16"], int4["max_abs_err"]["w4a16_f32"]),
        "ms": int4["top"]["w4a16_ms"], "plain_ms": int4["top"]["w4a16_plain_ms"],
        **int4["top"]["w4a16_bound"], "library_ms": int4["top"]["library_ms"],
        "device_ms": int4["top"]["w4a16_device_ms"],
        "library_device_ms": int4["top"]["library_device_ms"],
    }, {
        "name": "int4_stream_floor", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/int4_linear.cu",
        "replaces": "tools/bench_int4_kernel.py:85",
        "launches": int4_floor["launches"], "max_abs_err": int4_floor["max_abs_err"],
        "folds_that_differ": int4_floor["folds_that_differ"],
        "ms": int4_floor["floor_ms"], "plain_ms": int4_floor["floor_plain_ms"],
        "bound_ms": int4_floor["bound_ms"], "bound_by": int4_floor["bound_by"],
        "library_ms": None, "device_ms": int4_floor["floor_device_ms"],
        "library_device_ms": None, "by_shape": int4_floor["by_shape"],
    }, {
        "name": "topk_floor", "route": "cuda",
        "source": "outline_rag_tpu_torch/csrc/topk_floor.cu",
        "replaces": "tools/bench_topk_kernel.py:117",
        "launches": scan_floor_launches,
        "max_abs_err": max(m["floor"]["max_abs_err"] for m in floats.values()),
        "ms": floats["f32x2"]["floor"]["nomerge_ms"], "plain_ms": floats["f32x2"]["floor"]["plain_ms"],
        "bound_ms": floats["f32x2"]["floor"]["bound_ms"],
        "bound_by": floats["f32x2"]["floor"]["bound_by"], "library_ms": None,
        "modes": {mode: m["floor"] for mode, m in floats.items()},
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
