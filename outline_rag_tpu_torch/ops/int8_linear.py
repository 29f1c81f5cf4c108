"""int8-weight linears of the local chat decoder.

Port of ``outline_rag_tpu/ops/int8_linear.py``:

- :func:`quantize_linear_weight` — ``[K, N]`` float weight -> ``[N, K]`` int8
                                   with per-output-channel f32 scales.
- :func:`w8a8_matmul`            — per-row int8 activations x int8 weights,
                                   an exact integer product, f32 rescale.
                                   Plain PyTorch on both devices (the JAX
                                   package computes it outside any kernel).
- :func:`int8_linear`            — w8a16: on CUDA tensors it launches the
                                   hand-written kernel in
                                   ``csrc/int8_linear.cu`` (or raises); on CPU
                                   tensors it runs the plain twin.
- :func:`int8_linear_plain`      — the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch


def quantize_linear_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[K, N]`` float weight -> (``[N, K]`` int8, ``[N]`` f32 scales)."""
    wt = w.to(torch.float32).T  # [N, K]
    amax = wt.abs().amax(dim=1, keepdim=True)
    scale = (amax / 127.0).clamp_min(1e-12)
    q = torch.round(wt / scale).clamp(-127, 127).to(torch.int8)
    return q.contiguous(), scale[:, 0].contiguous()


def _int_matmul(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``[M, K] int8 @ [N, K] int8 ^T -> [M, N] int32``, exact."""
    if xq.device.type == "cpu":
        return xq.to(torch.int32) @ q.to(torch.int32).T
    # the card's integer GEMM wants more than 16 rows and multiples of 8
    m, k = xq.shape
    n = q.shape[0]
    mp, kp, np_ = max(32, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        xq = torch.nn.functional.pad(xq, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        q = torch.nn.functional.pad(q, (0, kp - k, 0, np_ - n))
    return torch._int_mm(xq.contiguous(), q.T)[:m, :n]


def w8a8_matmul(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``[M, K] float @ ([N, K] int8, [N] f32 scales) -> [M, N] f32``.

    Each row of ``x2`` is quantized on its own (so a token's result never
    depends on its neighbours), the product is exact integer arithmetic on
    both devices, and the f32 rescale is ``raw * x_scale * s`` in that
    order, as the JAX package computes it."""
    x2 = x2.to(torch.float32)
    amax = x2.abs().amax(dim=1, keepdim=True)
    xs = (amax / 127.0).clamp_min(1e-12)
    xq = torch.round(x2 / xs).clamp(-127, 127).to(torch.int8)
    raw = _int_matmul(xq, q)
    return raw.to(torch.float32) * xs * s[None, :].to(torch.float32)


def int8_linear_plain(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``[M, N]`` in ``x.dtype``.
    The weight is ``bf16(bf16(w_q) * bf16(w_scale))``, the activations are
    bf16 (f32 ``x`` is cast first), the sum is f32. Callers keep TF32 off."""
    w = w_q.to(torch.bfloat16) * w_scale.to(torch.bfloat16)[:, None]
    out = x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32).T
    return out.to(x.dtype)


_launch_fn = None


def _launcher():
    global _launch_fn
    if _launch_fn is None:
        from outline_rag_tpu_torch.ops._build import load_library  # noqa: PLC0415

        fn = load_library().int8_linear_launch
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i32, i32, i32, i32, p]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def _check_inputs(x, w_q, w_scale):
    if x.dim() != 2 or w_q.dim() != 2 or w_scale.dim() != 1:
        raise ValueError("int8_linear takes x [M, K], w_q [N, K], w_scale [N]")
    m, k = x.shape
    n = w_q.shape[0]
    if w_q.shape[1] != k or w_scale.shape[0] != n:
        raise ValueError(
            f"int8_linear: x {tuple(x.shape)}, w_q {tuple(w_q.shape)}, "
            f"w_scale {tuple(w_scale.shape)} do not agree"
        )
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_linear takes bf16 or f32 activations, not {x.dtype}")
    if w_q.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise ValueError("int8_linear takes int8 weights with f32 scales")
    if n % 8 or m % 8 or m == 0:
        # a partial tile must never come back unwritten: refuse it instead
        raise ValueError(
            f"int8_linear requires N % 8 == 0 and M % 8 == 0 "
            f"(got N={n}, M={m}); pad at the caller"
        )
    return m, k, n


def int8_linear(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(w).T -> [M, N]`` in ``x.dtype``; the int8 weight is
    dequantized on the chip, tile by tile, and never stored. Requires
    ``M % 8 == 0`` and ``N % 8 == 0`` (pad at the caller). On CUDA tensors
    this launches ``csrc/int8_linear.cu`` (K a multiple of 16) and counts
    the launch in ``int8_linear.launches``; on CPU tensors it runs
    :func:`int8_linear_plain`."""
    m, k, n = _check_inputs(x, w_q, w_scale)
    if x.device.type == "cpu":
        return int8_linear_plain(x, w_q, w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_linear runs on cpu or cuda tensors, not {x.device}")
    if w_q.device != x.device or w_scale.device != x.device:
        raise ValueError("int8_linear: x, w_q and w_scale must share a device")
    if k % 16:
        raise ValueError(f"int8_linear kernel requires K % 16 == 0, got K={k}")
    if not (w_q.is_contiguous() and w_scale.is_contiguous()):
        raise ValueError("int8_linear: w_q and w_scale must be contiguous")
    if w_q.data_ptr() % 16:
        raise ValueError("int8_linear: w_q must be 16-byte aligned (the kernel reads it by TMA)")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    launch = _launcher()
    with torch.cuda.device(x.device):
        rc = launch(
            xb.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
            m, n, k, int(x.dtype == torch.float32),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"int8_linear kernel launch failed with CUDA error {rc}")
    int8_linear.launches += 1
    return out


int8_linear.launches = 0
