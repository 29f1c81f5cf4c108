"""Score + top-K selection.

Port of ``outline_rag_tpu/ops/topk.py``:

- :func:`topk_plain`       — exact fp32 cosine top-K (the oracle; the
                             counterpart of ``topk_xla``).
- :func:`topk_int8`        — the int8 scan top-K. On a CUDA tensor it
                             launches the hand-written kernel in
                             ``csrc/topk_int8.cu`` (or raises); on a CPU
                             tensor it runs :func:`topk_int8_plain`.
- :func:`topk_float`       — the fp32 / bf16 / f32x2 scan top-K over
                             ``csrc/topk_float.cu`` the same way, with
                             :func:`topk_float_plain` as its twin.
- :func:`cosine_topk`      — the float dispatcher: picks the mode from the
                             query and corpus dtypes as the JAX package does.
- :func:`topk_floor`       — the float scan with its selection taken out
                             (``csrc/topk_floor.cu``): what the score pass
                             alone costs, with :func:`topk_floor_plain`.
- :func:`split_f32_bf16x2` / :func:`join_bf16x2` — the compensated layout.
- :func:`merge_topk`       — top-k of the union of two top lists.

Conventions carried over from the JAX package: invalid rows (tombstones,
capacity padding) carry an additive ``[N]`` f32 penalty of ``NEG``; the
lower row index wins a tie. ``torch.topk`` does not promise that, so every
selection here is a stable descending sort. The kernels emit the Pallas
kernel's dead slots: a row scoring <= NEG/2 is never selected, and unfilled
slots are ``(NEG, 0)``.
"""

from __future__ import annotations

import ctypes

import torch

NEG = -1e30

# Rows scored per step by the plain versions: bounds the f32 copy of an int8
# corpus slice and the [B, rows] score matrix.
PLAIN_ROWS_PER_STEP = 1 << 18

# The scans' limit on K.
KERNEL_MAX_K = 64

# The int8 scan's constants, from ``Shape<INT8>`` and the score pass of
# csrc/topk_float_tile.cuh: queries a block, the rows a chunk is a multiple
# of (its 128-row tile divides it), and the blocks an SM holds at once
# (``MIN_BLOCKS``, its shared memory). Pass 1 runs one wave of them.
_INT8_KERNEL_TB = 32
_INT8_KERNEL_CHUNK_ROWS = 256
_INT8_RESIDENT = 2

# The float scan's modes, by their code in csrc/topk_float.cu, and the
# constants of csrc/topk_float_tile.cuh: queries a block, the rows a chunk
# is a multiple of (the fp32 tile; the bf16 and f32x2 tiles of 128 divide
# it), and the step over the dimensions (D must be a multiple).
FLOAT_MODES = {"fp32": 0, "bf16": 1, "f32x2": 2}
_FLOAT_KERNEL_TB = 32
_FLOAT_KERNEL_CHUNK_ROWS = 256
_FLOAT_KERNEL_DC = 32
# Blocks of the float scan an SM holds at once (its shared memory), by mode:
# ``MIN_BLOCKS`` of each ``Shape`` in csrc/topk_float_tile.cuh. Pass 1 runs
# one wave of them: fewer, longer chunks leave fewer lists to fill and merge.
_FLOAT_RESIDENT = {"fp32": 1, "bf16": 2, "f32x2": 1}
ORIENTATIONS = ("qmajor", "cmajor")
# The rows of a tile whose first row the ``matmul`` floor keeps: the 128-row
# tile of the bf16 and f32x2 float scans.
_FLOOR_TILE_ROWS = 128


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


def _chunk_plan(n: int, device: torch.device, q_tiles: int, resident: int,
                chunk_rows: int) -> tuple[int, int]:
    """(chunks, rows per chunk) for a scan's pass 1: one wave of the blocks
    the card holds at once (``resident`` an SM, ``q_tiles`` blocks a chunk),
    each walking a whole number of ``chunk_rows`` rows. Fewer, longer chunks
    leave fewer lists to fill and merge."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    steps = -(-n // chunk_rows)
    chunks = min(steps, max(1, (resident * sms) // q_tiles))
    rows_per_chunk = -(-steps // chunks) * chunk_rows
    return -(-n // rows_per_chunk), rows_per_chunk


def _int8_kernel_plan(b: int, n: int, device: torch.device) -> tuple[int, int]:
    """(chunks, rows per chunk) for the int8 scan's pass 1."""
    return _chunk_plan(n, device, -(-b // _INT8_KERNEL_TB), _INT8_RESIDENT,
                       _INT8_KERNEL_CHUNK_ROWS)


def _float_kernel_plan(b: int, n: int, device: torch.device, mode: str) -> tuple[int, int]:
    """(chunks, rows per chunk) for the float scan's pass 1 (and its
    floor) in ``mode``."""
    return _chunk_plan(n, device, -(-b // _FLOAT_KERNEL_TB), _FLOAT_RESIDENT[mode],
                       _FLOAT_KERNEL_CHUNK_ROWS)


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
    chunks, rows_per_chunk = _int8_kernel_plan(b, n, dev)
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


# ---------------------------------------------------------------------------
# float scan: fp32, bf16 and the compensated bf16x2 layout
# ---------------------------------------------------------------------------


def split_f32_bf16x2(x: torch.Tensor) -> torch.Tensor:
    """f32 [..., D] -> compensated bf16 pair [..., 2D] (hi ++ lo), with
    ``hi = bf16(x)`` and ``lo = bf16(x - f32(hi))``, both rounded to
    nearest even. The dot of two such pairs as ``hi.hi + hi.lo + lo.hi``
    carries about 2^-22 relative error. Storage is 4 bytes per dimension,
    as in f32."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return torch.cat([hi, lo], dim=-1)


def join_bf16x2(x2: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_f32_bf16x2` (up to 2^-24 rounding)."""
    d = x2.shape[-1] // 2
    return x2[..., :d].float() + x2[..., d:].float()


def _check_mode(mode: str) -> None:
    if mode not in FLOAT_MODES:
        raise ValueError(f"float scan mode {mode!r}: use one of {tuple(FLOAT_MODES)}")


def topk_float_plain(
    queries: torch.Tensor,  # [B, W]: f32 (fp32), bf16 (bf16), bf16 pairs (f32x2)
    corpus: torch.Tensor,  # [N, W] in the same type
    k: int,
    penalty: torch.Tensor | None = None,  # [N] f32
    mode: str = "fp32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The float scan top-K in plain PyTorch: what ``csrc/topk_float.cu``
    computes. Scores are f32 dots plus the penalty; bf16 inputs are widened
    to f32 first (every bf16 product is exact in f32); in ``f32x2`` mode,
    ``(hi.hi + hi.lo) + lo.hi`` over ``[*, 2D]`` pairs (the Pallas
    ``_dot_compensated``). Callers keep TF32 off. Rows scoring <= NEG/2
    are never selected: their slots come out as ``(NEG, 0)``."""
    _check_mode(mode)
    n = corpus.shape[0]
    k = min(k, n)
    d = queries.shape[1] // 2
    q = queries.float()

    def score_rows(start, stop):
        c = corpus[start:stop].float()
        if mode == "f32x2":
            qh, ql, ch, cl = q[:, :d], q[:, d:], c[:, :d], c[:, d:]
            s = (qh @ ch.T + qh @ cl.T) + ql @ ch.T
        else:
            s = q @ c.T
        return s if penalty is None else s + penalty[start:stop][None, :]

    vals, idx = _stepped_topk(score_rows, n, k)
    dead = vals <= NEG / 2
    return vals.masked_fill(dead, NEG), idx.masked_fill(dead, 0)


_float_launch_fn = None


def _float_launcher():
    global _float_launch_fn
    if _float_launch_fn is None:
        from outline_rag_tpu_torch.ops._build import load_library  # noqa: PLC0415

        fn = load_library().topk_float_launch
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i32, p, p, p, i32, i64, i32, i32, i32, i64, i32, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _float_launch_fn = fn
    return _float_launch_fn


def _check_float_inputs(queries, corpus, penalty, k, mode):
    dev = corpus.device
    dtype = torch.float32 if mode == "fp32" else torch.bfloat16
    operands = [
        ("queries", queries, dtype, (queries.shape[0], corpus.shape[1])),
        ("corpus", corpus, dtype, tuple(corpus.shape)),
    ]
    if penalty is not None:  # the floors take none
        operands.append(("penalty", penalty, torch.float32, (corpus.shape[0],)))
    for name, t, want, shape in operands:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, corpus on {dev}")
        if t.dtype != want or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: {mode} mode wants {want} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    b, width = queries.shape
    d = width // 2 if mode == "f32x2" else width
    n = corpus.shape[0]
    if (b < 1 or d % _FLOAT_KERNEL_DC or (mode == "f32x2" and width % 2)
            or not 1 <= k <= min(KERNEL_MAX_K, n) or n >= 1 << 31):
        raise ValueError(
            f"topk_float kernel takes B>=1, D%{_FLOAT_KERNEL_DC}==0, "
            f"1<=K<=min(64, N), N<2^31; got B={b} D={d} K={k} N={n} ({mode})"
        )
    return b, d, n


def topk_float(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int,
    penalty: torch.Tensor | None = None,
    mode: str = "fp32",
    orientation: str = "qmajor",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query top-k of the float scan (``mode`` fp32, bf16 or f32x2; see
    :func:`topk_float_plain` for the inputs): [B, k] f32 values, [B, k]
    int32 rows, sorted descending, lower row first on ties, dead slots
    ``(NEG, 0)``. On CUDA tensors this launches ``csrc/topk_float.cu`` and
    counts the launch in ``topk_float.launches[mode]``; on CPU tensors it
    runs :func:`topk_float_plain`.

    ``orientation``: ``"qmajor"`` has the kernel write [B, k];
    ``"cmajor"`` has it write [k, B], the output layout of the Pallas
    ``_fused_topk_kernel``, returned transposed back as the JAX wrapper
    does. Both compute the same function."""
    _check_mode(mode)
    if orientation not in ORIENTATIONS:
        raise ValueError(f"orientation {orientation!r}: use one of {ORIENTATIONS}")
    if penalty is None:
        penalty = torch.zeros(corpus.shape[0], dtype=torch.float32, device=corpus.device)
    if corpus.device.type == "cpu":
        return topk_float_plain(queries, corpus, k, penalty, mode)
    if corpus.device.type != "cuda":
        raise ValueError(f"topk_float runs on cpu or cuda tensors, not {corpus.device}")
    b, d, n = _check_float_inputs(queries, corpus, penalty, k, mode)
    dev = corpus.device
    cmajor = orientation == "cmajor"
    chunks, rows_per_chunk = _float_kernel_plan(b, n, dev, mode)
    part_v = torch.empty((chunks, b, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((chunks, b, k), dtype=torch.int32, device=dev)
    out_shape = (k, b) if cmajor else (b, k)
    out_v = torch.empty(out_shape, dtype=torch.float32, device=dev)
    out_i = torch.empty(out_shape, dtype=torch.int32, device=dev)
    launch = _float_launcher()
    with torch.cuda.device(dev):
        rc = launch(
            FLOAT_MODES[mode], queries.data_ptr(), corpus.data_ptr(), penalty.data_ptr(),
            b, n, d, k, chunks, rows_per_chunk, int(cmajor), part_v.data_ptr(),
            part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"topk_float kernel launch failed with CUDA error {rc}")
    topk_float.launches[mode] += 1
    return (out_v.T, out_i.T) if cmajor else (out_v, out_i)


topk_float.launches = dict.fromkeys(FLOAT_MODES, 0)


# ---------------------------------------------------------------------------
# the scan's floors: the score pass with nothing but a running maximum
# ---------------------------------------------------------------------------

FLOOR_VARIANTS = ("nomerge", "matmul")
FLOOR_INIT = -1e30  # the running maximum's first value


def _check_floor(mode: str, variant: str, tile_rows: int) -> None:
    _check_mode(mode)
    if variant not in FLOOR_VARIANTS:
        raise ValueError(f"floor variant {variant!r}: use one of {FLOOR_VARIANTS}")
    if mode == "f32x2" and variant != "nomerge":
        raise ValueError("the f32x2 floor has the nomerge variant only")
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be positive, got {tile_rows}")


def topk_floor_plain(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    mode: str = "fp32",
    variant: str = "nomerge",
    tile_rows: int = _FLOOR_TILE_ROWS,
) -> torch.Tensor:
    """:func:`topk_floor` in plain PyTorch: ``[B]`` f32. Callers keep TF32
    off."""
    _check_floor(mode, variant, tile_rows)
    d = queries.shape[1] // 2
    q = queries.float()
    best = torch.full((queries.shape[0],), FLOOR_INIT, dtype=torch.float32, device=corpus.device)
    step = PLAIN_ROWS_PER_STEP // tile_rows * tile_rows or tile_rows
    for start in range(0, corpus.shape[0], step):
        c = corpus[start : start + step]
        if variant == "matmul":
            c = c[::tile_rows]  # start is a multiple of tile_rows
        c = c.float()
        if mode == "f32x2":
            qh, ql, ch, cl = q[:, :d], q[:, d:], c[:, :d], c[:, d:]
            s = (qh @ ch.T + qh @ cl.T) + ql @ ch.T
        else:
            s = q @ c.T
        best = torch.maximum(best, s.amax(dim=1))
    return best


_floor_launch_fn = None


def _floor_launcher():
    global _floor_launch_fn
    if _floor_launch_fn is None:
        from outline_rag_tpu_torch.ops._build import load_library  # noqa: PLC0415

        fn = load_library().topk_floor_launch
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i32, p, p, i32, i64, i32, i32, i64, i32, i32, p, p, p]
        fn.restype = ctypes.c_int
        _floor_launch_fn = fn
    return _floor_launch_fn


def topk_floor(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    mode: str = "fp32",
    variant: str = "nomerge",
    tile_rows: int = _FLOOR_TILE_ROWS,
) -> torch.Tensor:
    """The float scan's floor: every score of :func:`topk_float` (same
    inputs, no penalty) is computed, and all that is kept is a running
    maximum per query from ``-1e30``: ``[B]`` f32.

    ``variant="nomerge"``: the maximum over all rows, which is the first
    column of :func:`topk_float`'s values. ``variant="matmul"``: the maximum
    over the rows that are multiples of ``tile_rows`` only (by default the
    128-row tile of the float scan's bf16 and f32x2 modes; the JAX tool's
    tiles are 1024 rows), the
    cheapest use of a tile that still needs all of it computed. The f32x2
    mode has ``nomerge`` only, as in the JAX tool. The full scan's time
    minus this one's is what selecting the top K costs. On CUDA tensors
    this launches ``csrc/topk_floor.cu`` and counts the launch in
    ``topk_floor.launches``; on CPU tensors it runs
    :func:`topk_floor_plain`."""
    _check_floor(mode, variant, tile_rows)
    if corpus.device.type == "cpu":
        return topk_floor_plain(queries, corpus, mode, variant, tile_rows)
    if corpus.device.type != "cuda":
        raise ValueError(f"topk_floor runs on cpu or cuda tensors, not {corpus.device}")
    dev = corpus.device
    b, d, n = _check_float_inputs(queries, corpus, None, 1, mode)
    chunks, rows_per_chunk = _float_kernel_plan(b, n, dev, mode)
    part = torch.empty((chunks, b), dtype=torch.float32, device=dev)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _floor_launcher()(
            FLOAT_MODES[mode], queries.data_ptr(), corpus.data_ptr(), b, n, d, chunks,
            rows_per_chunk, int(variant == "matmul"), int(tile_rows), part.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"topk_floor kernel launch failed with CUDA error {rc}")
    topk_floor.launches += 1
    return out


topk_floor.launches = 0


def float_mode(queries: torch.Tensor, corpus: torch.Tensor) -> str:
    """The float scan mode for f32 ``queries`` against ``corpus``, as the
    JAX package's ``_is_compensated`` decides it: an f32 corpus is fp32; a
    bf16 corpus twice as wide as the queries is the f32x2 pair layout;
    another bf16 corpus is bf16."""
    if corpus.dtype == torch.float32:
        return "fp32"
    if corpus.dtype != torch.bfloat16:
        raise ValueError(f"cosine_topk scans f32 or bf16 corpora, not {corpus.dtype}")
    if queries.dtype == torch.float32 and corpus.shape[1] == 2 * queries.shape[1]:
        return "f32x2"
    return "bf16"


def cosine_topk(
    queries: torch.Tensor,  # [B, D] (f32 unit rows)
    corpus: torch.Tensor,  # [N, D] f32 / bf16, or [N, 2D] bf16 pairs
    k: int,
    penalty: torch.Tensor | None = None,  # [N] f32
    orientation: str = "qmajor",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine matches of each query: [B, min(k, N)] values and int32
    rows. The mode follows :func:`float_mode`; bf16 queries are cast to
    bf16 first, f32x2 queries split into pairs. A float corpus always goes
    through :func:`topk_float` (the kernel on CUDA): the JAX package's
    XLA crossover was measured on a TPU and has no counterpart here."""
    mode = float_mode(queries, corpus)
    if mode == "f32x2":
        q = split_f32_bf16x2(queries)
    else:
        q = queries.to(corpus.dtype).contiguous()
    return topk_float(q, corpus, min(k, corpus.shape[0]), penalty, mode, orientation)

