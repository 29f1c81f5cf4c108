"""Bidirectional multi-head attention with a key-padding bias, streamed.

Port of ``outline_rag_tpu/ops/attention.py``:

- :func:`flash_attention`       — on CUDA tensors it launches the
                                  hand-written kernel in
                                  ``csrc/flash_attention.cu`` (or raises);
                                  on CPU tensors it runs the plain twin.
- :func:`flash_attention_plain` — the same function in plain PyTorch.

Both take the encoder's ``[B, S, H, D]`` layout and a ``[B, S]`` f32 key
bias (0 for real tokens, ``NEG_BIAS`` for padding), and compute what the
Pallas ``_flash_kernel`` computes: f32 logits scaled by ``1/sqrt(D)`` plus
the bias, softmax statistics in f32, the unnormalised probabilities cast to
the input dtype before ``P.V`` (f32 accumulation), one division by the row
sum at the end. Keys whose bias is ``<= NEG_BIAS/2`` add nothing, and a
batch row with no live key emits zeros. This is not the einsum attention's
function: that one normalises before the cast.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_BIAS = -1e9  # the encoder's additive padding bias

# Query rows per step of the plain version: bounds its [B, H, rows, S] f32
# logits (1 GiB at B = 1, H = 16, S = 8192).
PLAIN_QUERY_ROWS = 2048

# What csrc/flash_attention.cu takes: bf16 or f32, head dim 64, B * H <= 65535,
# contiguous and 16-byte aligned (bf16 tiles are fetched through tensor maps).
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
KERNEL_HEAD_DIM = 64
_KERNEL_MAX_BH = 65535


def flash_attention_plain(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, H, D]
    v: torch.Tensor,  # [B, S, H, D]
    key_bias: torch.Tensor,  # [B, S] f32
) -> torch.Tensor:
    """The flash kernel's function in plain PyTorch: [B, S, H, D] in the
    input dtype. The max is taken over the whole key row at once (the
    kernel keeps a running max over key tiles), so the two differ by the
    rounding of P to the input dtype, a few of its ulps. Callers keep TF32
    off."""
    s = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[3])
    bias = key_bias.float()[:, None, None, :]  # [B, 1, 1, S]
    live = bias > NEG_BIAS * 0.5
    kf, vf = k.float(), v.float()
    outs = []
    for start in range(0, s, PLAIN_QUERY_ROWS):
        qs = q[:, start : start + PLAIN_QUERY_ROWS].float()
        logits = torch.einsum("bqhd,bkhd->bhqk", qs, kf) * scale + bias
        m = logits.amax(dim=-1, keepdim=True).clamp_min(-1e30)
        p = torch.exp(logits - m).masked_fill(~live, 0.0)
        denom = p.sum(dim=-1, keepdim=True)
        denom = torch.where(denom <= 0, torch.ones_like(denom), denom)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(), vf)
        outs.append((pv / denom).transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)


_launch_fn = None


def _launcher():
    global _launch_fn
    if _launch_fn is None:
        from outline_rag_tpu_torch.ops._build import load_library  # noqa: PLC0415

        fn = load_library().flash_attention_launch
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i32, i32, i32, i32, i32, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def _check_kernel_inputs(q, k, v, key_bias):
    b, s, h, d = q.shape
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash_attention kernel takes bf16 or f32, not {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or tuple(t.shape) != (b, s, h, d):
            raise ValueError(
                f"{name}: want {q.dtype} {(b, s, h, d)} on {q.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:  # the bf16 kernel's tensor maps, the f32 kernel's 16-byte loads
            raise ValueError(f"{name} must be 16-byte aligned")
    if tuple(key_bias.shape) != (b, s) or key_bias.device != q.device:
        raise ValueError(f"key_bias: want {(b, s)} on {q.device}, got {tuple(key_bias.shape)}")
    if d != KERNEL_HEAD_DIM or b * h > _KERNEL_MAX_BH or s >= 1 << 31:
        raise ValueError(
            f"flash_attention kernel takes D={KERNEL_HEAD_DIM}, B*H<={_KERNEL_MAX_BH}; "
            f"got B={b} S={s} H={h} D={d}"
        )


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, H, D]
    v: torch.Tensor,  # [B, S, H, D]
    key_bias: torch.Tensor,  # [B, S] f32, 0 for real tokens / NEG_BIAS for pad
) -> torch.Tensor:
    """Bidirectional multi-head attention with a key-padding bias:
    [B, S, H, D] in the input dtype. On CUDA tensors this launches
    ``csrc/flash_attention.cu`` (bf16 or f32, D = 64) and counts the launch in
    ``flash_attention.launches``; on CPU tensors it runs
    :func:`flash_attention_plain`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, not {q.device}")
    key_bias = key_bias.to(torch.float32).contiguous()  # [B, S]: a small copy at most
    _check_kernel_inputs(q, k, v, key_bias)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    launch = _launcher()
    with torch.cuda.device(q.device):
        rc = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(), out.data_ptr(),
            b, s, h, d, int(q.dtype == torch.float32), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
