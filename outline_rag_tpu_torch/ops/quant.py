"""Per-row int8 quantization and the quantized top-K with exact rescore.

Port of ``outline_rag_tpu/ops/quant.py``. Scheme: symmetric per-row
absmax, ``q = round(x / scale)`` with ``scale = absmax(row) / 127`` (round
half to even, as ``jnp.round``); the ``int8r`` mode adds a residual plane
``q2`` with the derived scale ``scale / 254``.

The codes and scales are byte-equal to the JAX package's, which means
following its compiled arithmetic: XLA turns each division by a constant
into a multiplication by its f32 reciprocal, and contracts the residual
``x - q1 * scale`` into one fused multiply-add (a single rounding).
"""

from __future__ import annotations

import torch

from outline_rag_tpu_torch.ops.hostmem import gather_rows
from outline_rag_tpu_torch.ops.topk import NEG, topk_int8


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, D] float -> ([N, D] int8, [N] f32 scales). Zero rows get scale 0."""
    scale = x.abs().amax(dim=1) * (1.0 / 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[:, None]), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_rows_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[:, None]


def quantize_rows_int8_residual(
    x: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[N, D] float -> (q1 [N, D] int8, scale [N] f32, q2 [N, D] int8).

    The scan reads only q1; the rescore dequantizes
    ``q1*s + q2*(s/254)``. The residual ``x - q1*s`` is bounded by s/2, so
    ``s/254`` puts q2 in [-127, 127] with no second scale array."""
    q1, scale = quantize_rows_int8(x)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    # x - q1*s rounded once, as a fused multiply-add: exact in f64 (q1*s
    # has 31 significant bits and |x - q1*s| <= s/2), then one rounding
    r = (x.double() - q1.double() * scale.double()[:, None]).float()
    q2 = torch.clamp(torch.round(r / (safe * (1.0 / 254.0))[:, None]), -127, 127)
    return q1, scale, q2.to(torch.int8)


def rescore_fp32(
    queries: torch.Tensor,  # [B, D] f32
    corpus_rows: torch.Tensor,  # [B, K, D] f32 gathered candidates
) -> torch.Tensor:
    """Exact fp32 scores of gathered candidate rows: [B, K]. True fp32
    needs TF32 off (``torch.backends.cuda.matmul.allow_tf32``, the
    PyTorch default)."""
    return torch.einsum("bd,bkd->bk", queries, corpus_rows)


def _rescore_exact(
    queries: torch.Tensor,  # [B, D] f32 exact query values
    cand_vals: torch.Tensor,  # [B, M] scan values
    cand_idx: torch.Tensor,  # [B, M] scan rows
    corpus: torch.Tensor,  # [N, D] int8 (the q1 plane)
    c_scale: torch.Tensor,  # [N] f32
    penalty: torch.Tensor | None,  # [N] f32
    residual: torch.Tensor | None,  # [N, D] int8 (the q2 plane), device or host
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The exact f32 scores of the scan's candidates, shared by the device
    rescore and the host tier: ``(scores [B, M], rows [B, M] ascending,
    row scales [B, M])``.

    Candidates are put in ascending row order first, so a stable sort of
    the scores keeps the lowest-row-wins tie rule. Rows dequantize from q1
    (plus q2 when ``residual`` is given) and score with the penalty added.
    The q2 rows come through ``ops/hostmem.py::gather_rows``: a q2 plane in
    page-locked host memory is read by row over PCIe and ranks bit for bit
    as the same plane on the card.
    A candidate the scan marked dead (value <= NEG/2, the ``(NEG, 0)``
    slots of an index with fewer live rows than M) scores NEG whatever its
    row: the JAX package rescored those slots as row 0 and could return
    row 0 several times."""
    order = torch.argsort(cand_idx, dim=1, stable=True)
    idx_c = torch.gather(cand_idx, 1, order).long()
    dead = torch.gather(cand_vals, 1, order) <= NEG / 2
    taken_scale = c_scale[idx_c]  # [B, M]
    rows = corpus[idx_c].float() * taken_scale[..., None]
    if residual is not None:
        rows = rows + gather_rows(residual, idx_c).float() * (taken_scale[..., None] / 254.0)
    scores = rescore_fp32(queries.float(), rows)
    if penalty is not None:
        scores = scores + penalty[idx_c]
    return scores.masked_fill(dead, NEG), idx_c, taken_scale


def rescore_candidates(
    queries: torch.Tensor,  # [B, D] f32 exact query values
    cand_vals: torch.Tensor,  # [B, M] scan values
    cand_idx: torch.Tensor,  # [B, M] scan rows
    corpus: torch.Tensor,  # [N, D] int8 (the q1 plane)
    c_scale: torch.Tensor,  # [N] f32
    k: int,
    penalty: torch.Tensor | None = None,  # [N] f32
    residual: torch.Tensor | None = None,  # [N, D] int8 (the q2 plane)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-rank the scan's candidates by the exact f32 ``query . row`` with
    rows dequantized from q1 (and q2 when given); top-k of those, lowest
    row first among ties (:func:`_rescore_exact`)."""
    scores, idx_c, _ = _rescore_exact(
        queries, cand_vals, cand_idx, corpus, c_scale, penalty, residual
    )
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(idx_c, 1, pos[:, :k]).to(torch.int32)


def int8_topk_candidates(
    q_queries: torch.Tensor,  # [B, D] int8
    q_scale: torch.Tensor,  # [B] f32
    corpus: torch.Tensor,  # [N, D] int8 (the q1 plane)
    c_scale: torch.Tensor,  # [N] f32
    m: int,
    rescore_queries: torch.Tensor,  # [B, D] f32 exact query values
    penalty: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device half of the host-residual rescore tier: the int8 scan's top
    ``m`` candidates with their exact f32 q1-part scores. Returns
    ``(scores_q1 [B, m] f32, idx [B, m] int32 ascending, scale_c [B, m]
    f32)`` for ``ops/hostres.py::host_residual_topk`` to finish with the
    q2 plane held in host memory."""
    kq = min(m, corpus.shape[0])
    vals_c, idx_c = topk_int8(q_queries, q_scale, corpus, c_scale, kq, penalty)
    scores, idx_c, taken_scale = _rescore_exact(
        rescore_queries, vals_c, idx_c, corpus, c_scale, penalty, None
    )
    return scores, idx_c.to(torch.int32), taken_scale


def int8_topk(
    q_queries: torch.Tensor,  # [B, D] int8
    q_scale: torch.Tensor,  # [B] f32
    corpus: torch.Tensor,  # [N, D] int8
    c_scale: torch.Tensor,  # [N] f32
    k: int,
    penalty: torch.Tensor | None = None,
    rescore_queries: torch.Tensor | None = None,  # [B, D] f32
    rescore_m: int = 64,
    rescore_residual: torch.Tensor | None = None,  # [N, D] int8, device or host
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized top-K through the int8 scan (:func:`topk_int8`).

    With ``rescore_queries`` the scan keeps ``max(k, rescore_m)``
    candidates, which :func:`rescore_candidates` re-ranks exactly in fp32
    (from q1, or q1 + q2 with ``rescore_residual``, which may lie on the
    card or in page-locked host memory, ``ops/hostmem.py::to_pinned_host``)."""
    n = corpus.shape[0]
    if rescore_queries is None:
        return topk_int8(q_queries, q_scale, corpus, c_scale, min(k, n), penalty)
    kq = min(max(k, rescore_m), n)
    vals_c, idx_c = topk_int8(q_queries, q_scale, corpus, c_scale, kq, penalty)
    return rescore_candidates(
        rescore_queries, vals_c, idx_c, corpus, c_scale, min(k, kq), penalty,
        rescore_residual,
    )
