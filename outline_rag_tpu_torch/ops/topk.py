"""Score + top-K selection.

Port of ``outline_rag_tpu/ops/topk.py`` for the int8 index scan:

- :func:`topk_plain`      — exact fp32 cosine top-K (the oracle; the
                            counterpart of ``topk_xla``).
- :func:`topk_int8`       — the int8 scan top-K. On a CUDA tensor it
                            launches the hand-written kernel in
                            ``csrc/topk_int8.cu`` (or raises); on a CPU
                            tensor it runs :func:`topk_int8_plain`.
- :func:`topk_int8_plain` — the same function in plain PyTorch.
- :func:`merge_topk`      — top-k of the union of two top lists.

Conventions carried over from the JAX package: invalid rows (tombstones,
capacity padding) carry an additive ``[N]`` f32 penalty of ``NEG``; the
lower row index wins a tie. ``torch.topk`` does not promise that, so every
selection here is a stable descending sort.
"""

from __future__ import annotations

import ctypes

import torch

NEG = -1e30

# Rows scored per step by the plain versions: bounds the f32 copy of an int8
# corpus slice and the [B, rows] score matrix.
PLAIN_ROWS_PER_STEP = 1 << 18

# Tile sizes of csrc/topk_int8.cu (TB queries x TN rows) and its limit on K.
_KERNEL_TB = 32
_KERNEL_TN = 128
KERNEL_MAX_K = 64


def _select(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row of ``scores``, lowest column first on ties."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)


def merge_topk(
    vals_a: torch.Tensor,
    idx_a: torch.Tensor,
    vals_b: torch.Tensor,
    idx_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two per-query top lists [B, Ka], [B, Kb] -> top-k of the
    union. Equal values keep list a's entries first, so when a holds the
    lower rows the lower row wins."""
    vals = torch.cat([vals_a, vals_b], dim=1)
    idx = torch.cat([idx_a, idx_b], dim=1)
    top_vals, pos = _select(vals, k)
    return top_vals, torch.gather(idx, 1, pos.long())


def _stepped_topk(score_rows, n: int, k: int):
    """Top-k over ``n`` rows scored ``PLAIN_ROWS_PER_STEP`` at a time by
    ``score_rows(start, stop) -> [B, stop-start]``, merged in row order."""
    acc = None
    for start in range(0, n, PLAIN_ROWS_PER_STEP):
        stop = min(start + PLAIN_ROWS_PER_STEP, n)
        vals, idx = _select(score_rows(start, stop), min(k, stop - start))
        idx = idx + start
        acc = (vals, idx) if acc is None else merge_topk(*acc, vals, idx, k)
    return acc


def topk_plain(
    queries: torch.Tensor,  # [B, D] f32
    corpus: torch.Tensor,  # [N, D] f32
    k: int,
    penalty: torch.Tensor | None = None,  # [N] f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact fp32 cosine top-K (the oracle): [B, k] values and int32 rows.
    Callers keep TF32 off (``torch.backends.cuda.matmul.allow_tf32``) so
    the matmul is true fp32."""
    n = corpus.shape[0]
    k = min(k, n)

    def score_rows(start, stop):
        s = queries.float() @ corpus[start:stop].float().T
        return s if penalty is None else s + penalty[start:stop][None, :]

    return _stepped_topk(score_rows, n, k)


def topk_int8_plain(
    q_queries: torch.Tensor,  # [B, D] int8
    q_scale: torch.Tensor,  # [B] f32
    corpus: torch.Tensor,  # [N, D] int8
    c_scale: torch.Tensor,  # [N] f32
    k: int,
    penalty: torch.Tensor | None = None,  # [N] f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 scan top-K in plain PyTorch: what the kernel computes.

    The int32 dot is a float32 matmul of the codes cast to float, exact
    while 127^2 * D < 2^24 (D <= 1040). Scores are
    ``(dot * c_scale) * q_scale + penalty``, each step rounded on its own
    (the Pallas kernel's order). Rows scoring <= NEG/2 are never selected:
    their slots come out as ``(NEG, 0)``."""
    d = q_queries.shape[1]
    if 127 * 127 * d >= 1 << 24:
        raise ValueError(f"D={d}: the f32 dot of int8 codes is not exact past D=1040")
    n = corpus.shape[0]
    k = min(k, n)
    qf = q_queries.float()

    def score_rows(start, stop):
        raw = qf @ corpus[start:stop].float().T
        s = raw * c_scale[start:stop][None, :] * q_scale[:, None]
        if penalty is not None:
            s = s + penalty[start:stop][None, :]
        return s

    vals, idx = _stepped_topk(score_rows, n, k)
    dead = vals <= NEG / 2
    return vals.masked_fill(dead, NEG), idx.masked_fill(dead, 0)


def _kernel_plan(b: int, n: int, device: torch.device) -> tuple[int, int]:
    """(chunks, rows per chunk) for pass 1: about four blocks per SM in
    all, each walking a whole number of 128-row tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = -(-b // _KERNEL_TB)
    tiles = -(-n // _KERNEL_TN)
    chunks = min(tiles, max(1, (4 * sms) // q_tiles))
    rows_per_chunk = -(-tiles // chunks) * _KERNEL_TN
    return -(-n // rows_per_chunk), rows_per_chunk


_launch_fn = None


def _launcher():
    global _launch_fn
    if _launch_fn is None:
        from outline_rag_tpu_torch.ops._build import load_library  # noqa: PLC0415

        fn = load_library().topk_int8_launch
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, i32, i64, i32, i32, i32, i64, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def _check_kernel_inputs(q_queries, q_scale, corpus, c_scale, penalty, k):
    dev = corpus.device
    for name, t, dtype, shape in (
        ("q_queries", q_queries, torch.int8, (q_queries.shape[0], corpus.shape[1])),
        ("q_scale", q_scale, torch.float32, (q_queries.shape[0],)),
        ("corpus", corpus, torch.int8, tuple(corpus.shape)),
        ("c_scale", c_scale, torch.float32, (corpus.shape[0],)),
        ("penalty", penalty, torch.float32, (corpus.shape[0],)),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, corpus on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    b, d = q_queries.shape
    n = corpus.shape[0]
    if b < 1 or d % 16 or not 1 <= k <= min(KERNEL_MAX_K, n) or n >= 1 << 31:
        raise ValueError(
            f"topk_int8 kernel takes B>=1, D%16==0, 1<=K<=min(64, N), "
            f"N<2^31; got B={b} D={d} K={k} N={n}"
        )


def topk_int8(
    q_queries: torch.Tensor,  # [B, D] int8
    q_scale: torch.Tensor,  # [B] f32
    corpus: torch.Tensor,  # [N, D] int8
    c_scale: torch.Tensor,  # [N] f32
    k: int,
    penalty: torch.Tensor | None = None,  # [N] f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query top-k of the int8 scan: [B, k] f32 values, [B, k] int32
    rows, sorted descending, lower row first on ties, dead slots
    ``(NEG, 0)``. On CUDA tensors this launches ``csrc/topk_int8.cu`` (and
    counts the launch in ``topk_int8.launches``); on CPU tensors it runs
    :func:`topk_int8_plain`."""
    if penalty is None:
        penalty = torch.zeros(corpus.shape[0], dtype=torch.float32, device=corpus.device)
    if corpus.device.type == "cpu":
        return topk_int8_plain(q_queries, q_scale, corpus, c_scale, k, penalty)
    if corpus.device.type != "cuda":
        raise ValueError(f"topk_int8 runs on cpu or cuda tensors, not {corpus.device}")
    _check_kernel_inputs(q_queries, q_scale, corpus, c_scale, penalty, k)
    b, d = q_queries.shape
    n = corpus.shape[0]
    dev = corpus.device
    chunks, rows_per_chunk = _kernel_plan(b, n, dev)
    part_v = torch.empty((chunks, b, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((chunks, b, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        rc = launch(
            q_queries.data_ptr(), q_scale.data_ptr(), corpus.data_ptr(),
            c_scale.data_ptr(), penalty.data_ptr(), b, n, d, k, chunks,
            rows_per_chunk, part_v.data_ptr(), part_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"topk_int8 kernel launch failed with CUDA error {rc}")
    topk_int8.launches += 1
    return out_v, out_i


topk_int8.launches = 0
