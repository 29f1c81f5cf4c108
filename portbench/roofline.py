"""The card's published peaks, and the operations and bytes of the work the
cells do, counted from shapes.

Peaks are NVIDIA's data sheet for one H100 SXM at 700 W, dense: 989 TFLOP/s
bf16, 1,979 TOP/s int8, 3.35 TB/s of HBM. A share of a peak is stated
against these whatever the card's power limit (the run prints the card's
name; ``nvidia-smi`` gives its limit).
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(n_bytes: float, flops: float = 0.0, peak: float = PEAK_BF16) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over ``peak``."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / peak)


def xlmr_flops(cfg: dict, batch: int, seq: int) -> float:
    """Matrix FLOPs of an XLM-R trunk forward over ``batch`` rows of ``seq``
    tokens: the projections (2 x tokens x weights) and attention's two
    products (2 x 2 x S^2 x H a row a layer). Embedding lookups, norms and
    softmax are not counted."""
    h, f, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    tokens = batch * seq
    return n * (2.0 * tokens * (4 * h * h + 2 * h * f) + 4.0 * batch * seq * seq * h)


def scan_ops(batch: int, rows: int, dim: int) -> float:
    """Multiply-adds of an int8 scan, as 2 x B x N x D operations."""
    return 2.0 * batch * rows * dim


def int8_scan_bytes(batch: int, rows: int, dim: int, k: int) -> float:
    """Bytes an int8 scan with per-row scales and a penalty must move: the
    q1 plane, the scales and the penalty read once, the int8 queries and
    their scales, the ``[B, K]`` values and indices written."""
    return rows * dim + 8.0 * rows + batch * (dim + 4) + 8.0 * batch * k


def paged_attention_cost(cfg: dict, lengths, t: int, kv_bytes: int = 2) -> tuple[float, float]:
    """``(bytes, flops)`` of one layer's paged attention over rows whose
    ``t`` new tokens end at the given cached ``lengths`` (the positions
    attended, new tokens included): each row's K and V read once, q read
    and the output written in bf16; q.k and p.v over the causal positions."""
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // heads
    n_bytes = flops = 0.0
    for length in lengths:
        n_bytes += 2.0 * kv * hd * kv_bytes * length + 2.0 * 2 * t * heads * hd
        attended = t * length - t * (t - 1) / 2.0
        flops += 4.0 * heads * hd * attended
    return n_bytes, flops
