"""Host half of the int8r rescore tier: exact ranking past device memory.

Port of ``outline_rag_tpu/ops/hostres.py``. When the q2 residual plane of
an int8r index does not fit on the device beside the q1 plane, it stays in
host memory as a numpy array and the rescore splits:

- device (``ops/quant.py::int8_topk_candidates``): the int8 q1 scan, the
  top-m candidates, their exact f32 q1-part scores;
- host (here): gather the m q2 rows of each query, add the correction
  ``(q . q2_row) * s/254``, take the final top-k.

``q . (q1*s + q2*(s/254)) = (q . q1)*s + (q . q2)*(s/254)``: the same
score as the device rescore up to one f32 rounding in the final add.
"""

from __future__ import annotations

import numpy as np


def host_residual_topk(
    scores_q1: np.ndarray,  # [B, m] f32: the device's q1-part scores
    idx: np.ndarray,  # [B, m] int32 candidate rows, ascending per query
    scale_c: np.ndarray,  # [B, m] f32 per-candidate row scales
    queries: np.ndarray,  # [B, D] f32 exact query values
    q2_plane: np.ndarray,  # [N, D] int8 residual plane (host memory)
    k: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Finish the int8r rescore on the host: ``(vals [B, k], idx [B, k])``
    ranked by the exact two-plane score, the lowest row first among ties
    (a stable sort over ascending candidates). ``k`` larger than the
    candidate count ``m`` raises: the answer would have fewer than k
    columns."""
    b, m = idx.shape
    if k > m:
        raise ValueError(f"k={k} exceeds the {m} candidates of the device scan")
    rows = q2_plane[idx.reshape(-1)].reshape(b, m, -1).astype(np.float32)
    corr = np.matmul(rows, queries.astype(np.float32)[:, :, None])[:, :, 0]
    scores = scores_q1 + corr * (scale_c / np.float32(254.0))
    pos = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(scores, pos, axis=1)
    out_idx = np.take_along_axis(idx, pos, axis=1)
    return vals, out_idx.astype(np.int32)


__all__ = ["host_residual_topk"]
