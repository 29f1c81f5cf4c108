"""int4-weight linears of the local chat decoder: nibble-packed weights
decoded on the chip.

Port of ``outline_rag_tpu/ops/int4_linear.py`` (and of the int4 quantizer
and unpacker that the JAX package keeps in ``models/decoder.py``):

- :func:`quantize_int4_weight` — ``[K, N]`` float weight -> packed
                                 ``[N, K/2]`` uint8 with ``[N, G]`` f32
                                 group scales, byte for byte the JAX codes.
- :func:`unpack_int4`          — the packed bytes back as ``[..., K]`` int8.
- :func:`quantize_rows`        — per-row absmax int8 activations, one launch.
- :func:`w4a8_matmul`          — per-row int8 activations x int4 weights:
                                 exact int32 dots a scale group, f32 scales:
                                 two launches (quantize, product).
- :func:`w4a16_matmul`         — exact activations x weights decoded to the
                                 working type, f32 accumulation, one launch
                                 (``_w4a16_matmul_as``: the result in the
                                 working type, as the decoder wants it).
- :func:`int4_stream_floor`    — reads every packed byte once and does no
                                 arithmetic on it: what an int4 linear could
                                 reach on this card.

On CUDA tensors they launch the hand-written kernels of
``csrc/int4_linear.cu`` (or raise); on CPU tensors each runs its plain
twin (``*_plain``; ``_quantize_activations`` for the row quantizer), which
is also what the card's checks hold the kernels to.

The storage contract is the JAX package's. ``q4`` is *block-pair* packed:
byte ``128c + j`` (``j`` in ``[0, 128)``) holds element ``256c + j`` in its
LOW nibble as the biased value ``v + 8`` and element ``256c + 128 + j`` in
its HIGH nibble in two's complement; when ``K % 256 != 0`` the whole row is
one pair block ``K/2`` wide. ``s4[n, g]`` scales elements
``[g * gsz, (g + 1) * gsz)`` of row ``n``, ``gsz = K / G``. The layout was
chosen for the TPU's vector unit; it suits this card as well: four
consecutive packed bytes are four consecutive low elements and four
consecutive high elements, so one 32-bit word decodes into two int8x4
operands.
"""

from __future__ import annotations

import ctypes

import torch

_SEVENTH = 1.0 / 7.0  # rounded to f32 where it is used


def quantize_int4_weight(
    w: torch.Tensor, group_size: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """``[K, N]`` float weight -> (``[N, K/2]`` uint8 block-pair packed,
    ``[N, G]`` f32 group scales): symmetric groups along K, codes in
    ``[-8, 7]``. ``gsz = group_size`` when it divides K, else one group of
    K.

    The scale is ``amax * f32(1/7)``, not ``amax / 7``: the JAX package
    quantizes under ``jit``, where XLA turns the division by a constant
    into that product, and the codes and scales here are held byte-equal to
    its. ``w / scale`` stays a division in both."""
    k, n = w.shape
    if k % 2:
        raise ValueError(f"int4 packing needs an even K, got {k}")
    gsz = group_size if k % group_size == 0 else k
    wg = w.to(torch.float32).T.reshape(n, k // gsz, gsz)
    amax = wg.abs().amax(dim=2, keepdim=True)
    scale = (amax * torch.tensor(_SEVENTH, dtype=torch.float32, device=w.device)).clamp_min(1e-12)
    q = torch.round(wg / scale).clamp(-8, 7).reshape(n, k).to(torch.int32)
    pw = 128 if k % 256 == 0 else k // 2  # pair-block width
    qb = q.reshape(n, k // (2 * pw), 2, pw)
    lo = (qb[:, :, 0, :] + 8) & 15  # biased low nibble
    hi = qb[:, :, 1, :] & 15  # two's-complement high nibble
    packed = (lo | (hi << 4)).reshape(n, k // 2).to(torch.uint8)
    return packed.contiguous(), scale[:, :, 0].contiguous()


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """``[..., Kp]`` uint8 block-pair packed -> ``[..., 2 * Kp]`` int8 in
    ``[-8, 7]``, in element order."""
    kp = p.shape[-1]
    pw = 128 if kp % 128 == 0 else kp
    wide = p.to(torch.int16)
    lo = (wide & 15) - 8  # debias
    hi = wide >> 4
    hi = hi - ((hi & 8) << 1)  # sign-extend the nibble
    lead = p.shape[:-1]
    st = torch.stack([lo.reshape(*lead, kp // pw, pw), hi.reshape(*lead, kp // pw, pw)], dim=-2)
    return st.reshape(*lead, 2 * kp).to(torch.int8)


def int4_kernel_eligible(m: int, k: int, n: int, gsz: int) -> bool:
    """Whether the kernels take ``[m, k] x [n, k]`` with groups of ``gsz``:
    the JAX package's shape rule (whole 256-element pair blocks, groups of
    whole 128-element halves, N in blocks of 128) and 1 to 256 rows."""
    return (
        1 <= m <= 256
        and k % 256 == 0
        and gsz > 0
        and gsz % 128 == 0
        and k % gsz == 0
        and n % 128 == 0
        and (k // 2) % 128 == 0
    )


def _check(x, q4, s4, name: str) -> tuple[int, int, int, int]:
    if x.dim() != 2 or q4.dim() != 2 or s4.dim() != 2:
        raise ValueError(f"{name} takes x [M, K], q4 [N, K/2], s4 [N, G]")
    m, k = x.shape
    n, kp = q4.shape
    if kp * 2 != k:
        raise ValueError(f"packed K mismatch: x K={k}, q4 Kp={kp}")
    g = s4.shape[1]
    if s4.shape[0] != n or g < 1 or k % g:
        raise ValueError(f"{name}: s4 {tuple(s4.shape)} does not fit q4 {tuple(q4.shape)}")
    if q4.dtype != torch.uint8 or s4.dtype != torch.float32:
        raise ValueError(f"{name} takes uint8 packed weights with f32 group scales")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} takes bf16 or f32 activations, not {x.dtype}")
    return m, k, n, k // g


def _check_cuda(x, q4, s4, name: str, m: int, k: int, n: int, gsz: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {x.device}")
    if q4.device != x.device or s4.device != x.device:
        raise ValueError(f"{name}: x, q4 and s4 must share a device")
    if not int4_kernel_eligible(m, k, n, gsz):
        raise ValueError(
            f"{name} kernel needs 1 <= M <= 256, K % 256 == 0, gsz % 128 == 0 and "
            f"N % 128 == 0; got M={m}, K={k}, N={n}, gsz={gsz}"
        )
    if not (q4.is_contiguous() and s4.is_contiguous()) or q4.data_ptr() % 16:
        raise ValueError(f"{name}: q4 and s4 must be contiguous, q4 16-byte aligned")


_launch_fns: dict[str, object] = {}


def _launcher(which: str):
    """The C entry point ``int4_<which>_launch`` of the kernel library."""
    if which not in _launch_fns:
        from outline_rag_tpu_torch.ops._build import load_library  # noqa: PLC0415

        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn = getattr(load_library(), f"int4_{which}_launch")
        fn.argtypes = {
            "quant_rows": [p, i32, p, p, i32, i32, p],
            "w4a8": [p, p, p, p, p, i32, i32, i32, i32, i32, p],
            "w4a16": [p, p, p, p, i32, i32, i32, i32, i32, i32, p],
            "stream_floor": [p, i32, p, p, p, i32, i32, p],
        }[which]
        fn.restype = ctypes.c_int
        _launch_fns[which] = fn
    return _launch_fns[which]


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------------------
# w4a8
# ---------------------------------------------------------------------------


def _quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 activations in plain PyTorch: (``[M, K]`` int8, ``[M, 1]``
    f32 scales), the recipe of ``ops/int8_linear.py::w8a8_matmul`` (f32,
    absmax / 127, floor 1e-12, round half to even, clip to +-127). Both
    divisions are true divisions on every device: the divisor 127 is a tensor,
    since a Python scalar becomes a product with ``f32(1 / 127)`` on the
    card."""
    x32 = x.to(torch.float32)
    xs = (x32.abs().amax(dim=1, keepdim=True) / x32.new_full((), 127.0)).clamp_min(1e-12)
    return torch.round(x32 / xs).clamp(-127, 127).to(torch.int8), xs


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row of ``x`` (``[M, K]`` bf16 or f32) as int8 with its own scale:
    (``[M, K]`` int8, ``[M, 1]`` f32), ``xs = max(absmax / 127, 1e-12)`` and
    ``xq = clip(round_half_even(x / xs), -127, 127)``. On CUDA tensors this
    is one launch of ``csrc/int4_linear.cu``'s row quantizer, byte-equal to
    the plain version in codes and scale bits, counted in
    ``quantize_rows.launches``; on CPU tensors it runs
    :func:`_quantize_activations`."""
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("quantize_rows takes x [M, K] in bf16 or f32")
    if x.device.type == "cpu":
        return _quantize_activations(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows runs on cpu or cuda tensors, not {x.device}")
    m, k = x.shape
    if m < 1 or k % 16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(
            f"quantize_rows kernel needs M >= 1, K % 16 == 0 and a contiguous, 16-byte "
            f"aligned x; got M={m}, K={k}"
        )
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _launcher("quant_rows")(
            x.data_ptr(), int(x.dtype == torch.float32), xq.data_ptr(), xs.data_ptr(), m, k,
            _stream(x),
        )
    if rc != 0:
        raise RuntimeError(f"quantize_rows kernel launch failed with CUDA error {rc}")
    quantize_rows.launches += 1
    return xq, xs


quantize_rows.launches = 0


def _w4a8_groups_plain(xq: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """What the w4a8 kernel computes from int8 rows: ``sum_g s4[n, g] *
    float(sum_{k in g} xq[m, k] * v[n, k])``, the groups added one at a
    time in ascending order, each product and each sum rounded on its own.
    The integer sums are exact: as f32 matmuls of the codes (at most
    ``gsz * 127 * 8 < 2^24`` for groups up to 16,384 wide) on the card,
    int32 on the CPU."""
    m, k = xq.shape
    n, g = s4.shape
    gsz = k // g
    v = unpack_int4(q4).reshape(n, g, gsz)
    xg = xq.reshape(m, g, gsz)
    exact_in_f32 = gsz * 127 * 8 < 1 << 24
    out = torch.zeros((m, n), dtype=torch.float32, device=xq.device)
    for gi in range(g):
        if xq.device.type == "cpu" or not exact_in_f32:
            part = (xg[:, gi].to(torch.int32) @ v[:, gi].to(torch.int32).T).to(torch.float32)
        else:
            part = xg[:, gi].to(torch.float32) @ v[:, gi].to(torch.float32).T
        out = out + part * s4[None, :, gi]
    return out


def w4a8_matmul_plain(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """:func:`w4a8_matmul` in plain PyTorch, for any K, N and group size.
    Callers keep TF32 off."""
    _check(x, q4, s4, "w4a8_matmul")
    xq, xs = _quantize_activations(x)
    return _w4a8_groups_plain(xq, q4, s4) * xs


def _w4a8_matmul_as_plain(
    x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor, dt: torch.dtype
) -> torch.Tensor:
    """:func:`_w4a8_matmul_as` in plain PyTorch: the f32 result rounded once
    to ``dt``."""
    return w4a8_matmul_plain(x, q4, s4).to(dt)


def _w4a8_matmul_as(
    x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor, dt: torch.dtype
) -> torch.Tensor:
    """:func:`w4a8_matmul` with its result in ``dt`` (bf16 or f32), as the
    decoder wants it: the kernel's epilogue writes ``dt`` itself (the f32
    value rounded once: bit-equal to ``w4a8_matmul(...).to(dt)``), so a
    projection is two launches, the row quantizer and the product."""
    m, k, n, gsz = _check(x, q4, s4, "w4a8_matmul")
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"w4a8_matmul writes bf16 or f32, not {dt}")
    if x.device.type == "cpu":
        return _w4a8_matmul_as_plain(x, q4, s4, dt)
    _check_cuda(x, q4, s4, "w4a8_matmul", m, k, n, gsz)
    xq, xs = quantize_rows(x.contiguous())
    out = torch.empty((m, n), dtype=dt, device=x.device)
    with torch.cuda.device(x.device):
        rc = _launcher("w4a8")(
            xq.data_ptr(), xs.data_ptr(), q4.data_ptr(), s4.data_ptr(), out.data_ptr(),
            int(dt == torch.bfloat16), m, n, k, gsz, _stream(x),
        )
    if rc != 0:
        raise RuntimeError(f"w4a8_matmul kernel launch failed with CUDA error {rc}")
    w4a8_matmul.launches += 1
    return out


def w4a8_matmul(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """``quant8(x) @ dequant(q4, s4).T -> [M, N]`` f32.

    Each row of ``x`` is quantized to int8 on its own (:func:`quantize_rows`),
    the integer dots over each scale group are exact, the group scales apply
    to the group sums in f32 in ascending group order, and the row scale
    multiplies the result. A row's result depends on that row alone: not on
    M, not on its neighbours. On CUDA tensors this is two launches of
    ``csrc/int4_linear.cu`` (the row quantizer, then the product, whose
    epilogue applies the row scale), counted in ``quantize_rows.launches``
    and ``w4a8_matmul.launches``; on CPU tensors it runs
    :func:`w4a8_matmul_plain`."""
    return _w4a8_matmul_as(x, q4, s4, torch.float32)


w4a8_matmul.launches = 0


# ---------------------------------------------------------------------------
# w4a16
# ---------------------------------------------------------------------------

_VARIANTS = ("auto", "v1", "v2")


def _dequant(q4: torch.Tensor, s4: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``[N, K]`` weights ``dt(float(v) * s4[n, g])``: the product in f32,
    rounded once to ``dt``."""
    n, g = s4.shape
    v = unpack_int4(q4).reshape(n, g, -1).to(torch.float32)
    return (v * s4[:, :, None]).to(dt).reshape(n, -1)


def w4a16_matmul_plain(
    x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor, dt: torch.dtype | None = None
) -> torch.Tensor:
    """:func:`w4a16_matmul` in plain PyTorch, for any K, N and group size:
    activations and decoded weights in ``dt``, the sum in f32. Callers keep
    TF32 off."""
    _check(x, q4, s4, "w4a16_matmul")
    dt = x.dtype if dt is None else dt
    return x.to(dt).to(torch.float32) @ _dequant(q4, s4, dt).to(torch.float32).T


def _w4a16(x, q4, s4, dt: torch.dtype | None, out_dt: torch.dtype) -> torch.Tensor:
    """The weight decoded to ``dt`` (by default the type of ``x``), the f32
    sum written as ``out_dt``: f32, or ``dt`` itself."""
    m, k, n, gsz = _check(x, q4, s4, "w4a16_matmul")
    dt = x.dtype if dt is None else dt
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"w4a16_matmul decodes to bf16 or f32, not {dt}")
    if x.device.type == "cpu":
        return w4a16_matmul_plain(x, q4, s4, dt).to(out_dt)
    _check_cuda(x, q4, s4, "w4a16_matmul", m, k, n, gsz)
    xd = x.to(dt).contiguous()
    if xd.data_ptr() % 16:
        raise ValueError("w4a16_matmul: x must be 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dt, device=x.device)
    with torch.cuda.device(x.device):
        rc = _launcher("w4a16")(
            xd.data_ptr(), q4.data_ptr(), s4.data_ptr(), out.data_ptr(),
            int(out_dt == torch.bfloat16), m, n, k, gsz, int(dt == torch.float32), _stream(x),
        )
    if rc != 0:
        raise RuntimeError(f"w4a16_matmul kernel launch failed with CUDA error {rc}")
    w4a16_matmul.launches += 1
    return out


def _w4a16_matmul_as_plain(
    x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor, dt: torch.dtype
) -> torch.Tensor:
    """:func:`_w4a16_matmul_as` in plain PyTorch: the f32 result rounded
    once to ``dt``."""
    return w4a16_matmul_plain(x, q4, s4, dt).to(dt)


def _w4a16_matmul_as(
    x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor, dt: torch.dtype
) -> torch.Tensor:
    """:func:`w4a16_matmul` with the weight decoded to ``dt`` (bf16 or f32)
    and its result in ``dt``, as the decoder wants it: the kernel's epilogue
    writes ``dt`` itself (the f32 value rounded once: bit-equal to
    ``w4a16_matmul(x, q4, s4, dt).to(dt)``), so a projection is one launch.
    Raises for any other type, before a launch."""
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"w4a16_matmul writes bf16 or f32, not {dt}")
    return _w4a16(x, q4, s4, dt, dt)


def w4a16_matmul(
    x: torch.Tensor,
    q4: torch.Tensor,
    s4: torch.Tensor,
    dt: torch.dtype | None = None,
    *,
    variant: str = "auto",
) -> torch.Tensor:
    """``x @ dequant(q4, s4).T -> [M, N]`` f32 with exact activations:
    the weight is decoded to ``dt(float(v) * s4[n, g])`` (``dt``: bf16 or
    f32, by default the type of ``x``), the activations are cast to ``dt``,
    the sum is f32.

    ``variant`` is the JAX function's argument and is validated as there.
    Its values select between two TPU kernels that differ in how they fit
    the TPU's fast memory; one kernel serves all three here, with the
    unbiased decode of the JAX ``v1`` (``v2`` rounds ``(v + 8) * s``, a
    different weight at bf16). On CUDA tensors this launches
    ``csrc/int4_linear.cu`` and counts the launch in
    ``w4a16_matmul.launches``; on CPU tensors it runs
    :func:`w4a16_matmul_plain`."""
    if variant not in _VARIANTS:
        raise ValueError(f"variant must be one of 'auto', 'v1', 'v2'; got {variant!r}")
    return _w4a16(x, q4, s4, dt, torch.float32)


w4a16_matmul.launches = 0


# ---------------------------------------------------------------------------
# the packed-byte stream floor
# ---------------------------------------------------------------------------


def int4_stream_floor_plain(x: torch.Tensor, q4: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`int4_stream_floor` in plain PyTorch."""
    words = q4.contiguous().view(torch.int32)  # [N, Kp / 4], little-endian
    width = 1 << max(0, (words.shape[1] - 1).bit_length())
    fold = torch.nn.functional.pad(words, (0, width - words.shape[1]))
    while fold.shape[1] > 1:  # XOR is associative and commutative: any tree
        half = fold.shape[1] // 2
        fold = fold[:, :half] ^ fold[:, half:]
    value = q4[:, :1].to(torch.float32) * x[:1, :1].to(torch.float32)
    return value, fold[:, 0].contiguous()


def int4_stream_floor(
    x: torch.Tensor, q4: torch.Tensor, out: tuple[torch.Tensor, torch.Tensor] | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The int4 linear with its arithmetic taken out: every 16-byte word of
    ``q4`` is loaded once, by the w4a8 kernel's own blocks and load shape
    (8 warps over 32 channels, eight 16-byte loads a thread in flight), and
    folded by XOR. Returns (``float(q4[:, 0]) * x[0, 0]`` as ``[N, 1]``
    f32, the value of the JAX tool's ``dma_floor``; the XOR of each row's
    little-endian 32-bit words, ``[N]`` int32, which proves that every byte
    was read). On a TPU the block pipeline moves a block whatever the body
    reads; on this card nothing is loaded unless it is used, hence the
    fold. ``out``, a pair returned by an earlier call at the same N, is
    written again instead of fresh tensors (a timing loop then pays for the
    launch alone). On CUDA tensors this launches ``csrc/int4_linear.cu``
    and counts the launch in ``int4_stream_floor.launches``; on CPU tensors
    it runs :func:`int4_stream_floor_plain`."""
    if (x.dim() != 2 or q4.dim() != 2 or q4.dtype != torch.uint8
            or x.dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError("int4_stream_floor takes x [M, K] bf16 or f32 and q4 [N, K/2] uint8")
    n, kp = q4.shape
    if kp % 4:
        raise ValueError(f"int4_stream_floor folds 32-bit words: Kp={kp} is no multiple of 4")
    if x.device.type == "cpu":
        return int4_stream_floor_plain(x, q4)
    if x.device.type != "cuda" or q4.device != x.device:
        raise ValueError("int4_stream_floor: x and q4 must share a cuda (or the cpu) device")
    if kp % 128 or n % 8 or not q4.is_contiguous() or q4.data_ptr() % 16:
        raise ValueError(
            f"int4_stream_floor kernel needs Kp % 128 == 0, N % 8 == 0 and a contiguous, "
            f"16-byte aligned q4; got N={n}, Kp={kp}"
        )
    if out is None:
        out = (torch.empty((n, 1), dtype=torch.float32, device=x.device),
               torch.empty((n,), dtype=torch.int32, device=x.device))
    value, fold = out
    if (tuple(value.shape), value.dtype, tuple(fold.shape), fold.dtype) != (
            (n, 1), torch.float32, (n,), torch.int32) or value.device != x.device:
        raise ValueError("int4_stream_floor: out must be a pair this function returned at this N")
    with torch.cuda.device(x.device):
        rc = _launcher("stream_floor")(  # the kernel reads x[0, 0] at x's first address
            x.data_ptr(), int(x.dtype == torch.float32), q4.data_ptr(), value.data_ptr(),
            fold.data_ptr(), n, kp, _stream(x),
        )
    if rc != 0:
        raise RuntimeError(f"int4_stream_floor kernel launch failed with CUDA error {rc}")
    int4_stream_floor.launches += 1
    return value, fold


int4_stream_floor.launches = 0
