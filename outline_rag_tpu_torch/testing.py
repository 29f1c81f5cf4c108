"""Comparisons that hold a kernel to its plain version, shared by the tests
and ``chip_smoke.py``. Nothing on the serving or ingest path imports this."""

from __future__ import annotations

import torch

from outline_rag_tpu_torch.ops.topk import NEG


def tie_aware_mismatches(
    vals: torch.Tensor,  # [B, K]
    idx: torch.Tensor,  # [B, K]
    ref_vals: torch.Tensor,  # [B, K] or [B, K + 1]
    ref_idx: torch.Tensor,  # [B, K] or [B, K + 1]
    tol: float,
) -> int:
    """How many of the [B, K] slots disagree with a reference top list whose
    sums ran in another order: a value more than ``tol`` off, or a row that
    differs where rounding cannot have swapped it — a live reference value
    more than ``tol`` from both neighbours (the one past K is known when
    the reference has K + 1 columns, else the last slot is not held to its
    row) — or a dead slot that is not ``(NEG, 0)`` in both."""
    vals, idx = torch.as_tensor(vals).float(), torch.as_tensor(idx).long()
    ref_vals = torch.as_tensor(ref_vals).float().to(vals.device)
    ref_idx = torch.as_tensor(ref_idx).long().to(vals.device)
    k = vals.shape[1]
    bad = (vals - ref_vals[:, :k]).abs() > tol
    gap = ref_vals[:, :-1] - ref_vals[:, 1:]  # >= 0: sorted descending
    inf = torch.full_like(ref_vals[:, :1], float("inf"))
    left = torch.cat([inf, gap], dim=1)[:, :k] > tol
    right = torch.cat([gap, -inf], dim=1)[:, :k] > tol
    dead = ref_vals[:, :k] <= NEG / 2
    differs = idx != ref_idx[:, :k]
    bad |= differs & left & right & ~dead
    bad |= dead & (differs | (vals != NEG))
    return int(bad.sum())


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at ``|x|`` (f32): 2^(e - 8) for
    ``|x| = m * 2^e`` with m in [0.5, 1); 0 at 0."""
    mag = x.float().abs()
    _, e = torch.frexp(mag)
    return torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), e - 8), torch.zeros_like(mag))


def flash_errors(out: torch.Tensor, plain: torch.Tensor, atol: float, ulps: float) -> dict:
    """``out`` (the kernel) against ``plain`` (its plain version):
    ``max_abs_err``; ``worst_vs_bound``, the largest ``|out - plain|``
    over its bound ``atol + ulps * _bf16_ulp(plain)`` (the check passes
    at <= 1); and ``rel_rms_err``, ``||out - plain|| / ||plain||``."""
    plain = plain.float()
    diff = (out.float() - plain).abs()
    bound = atol + ulps * _bf16_ulp(plain)
    return {
        "max_abs_err": float(diff.max()),
        "worst_vs_bound": float((diff / bound).max()),
        "rel_rms_err": float(diff.norm() / plain.norm().clamp_min(1e-30)),
    }
