"""Row-parallel scoring: each shard's scan, then one merge of the tiny lists.

Port of ``outline_rag_tpu/parallel/query.py``. The corpus ``[N, D]`` is
row-sharded over the mesh (:class:`~outline_rag_tpu_torch.parallel.mesh.RowShards`);
each shard's scan runs on its own device over its ``[N/n, D]`` block (on a
CUDA block, its own launch of the scan kernel), its rows are rebased to
global rows, and the ``[B, K]`` lists are gathered onto the mesh's first
device and merged there. Scores never leave their device; what moves is
``n * B * K`` values and rows (and, for the fused query, the candidates'
cached tokens).

The merge keeps the JAX package's tie rule. The gathered lists are
shard-major (``[shard 0: k0 .. k-1, shard 1: ...]``) and shard r owns the
rows above shard r-1's, so a stable descending sort keeps, among equal
values, the lowest global row: the single-device scan's answer. A shard's
dead slots ``(NEG, 0)`` come back rebased, as ``(NEG, r * N/n)``, as the JAX
package's sharded functions return them.

Inputs that are sharded may be given as :class:`RowShards` over ``mesh`` or
as whole tensors, which are split onto it; replicated inputs are tensors on
any device, copied to each shard's.
"""

from __future__ import annotations

import torch

from outline_rag_tpu_torch.ops.quant import int8_topk, quantize_rows_int8
from outline_rag_tpu_torch.ops.topk import cosine_topk
from outline_rag_tpu_torch.parallel.mesh import Mesh, RowShards, as_row_shards

DCN_AXIS = "dcn"
ICI_AXIS = "ici"


def _select(vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k positions of each row, the earliest first on ties."""
    top, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    return top[:, :k], pos[:, :k]


def _rebase(idx: torch.Tensor, shard: int, rows_per_shard: int) -> torch.Tensor:
    """Local rows of shard ``shard`` as global int32 rows (added in int64)."""
    return (idx.long() + shard * rows_per_shard).to(torch.int32)


def _merge_gathered(vals, gidx, k: int, extras=()):
    """Cross-shard merge of per-shard top lists, on the first shard's
    device: ``vals`` / ``gidx`` are lists (shard order) of ``[B, K]``;
    ``extras`` are lists of per-candidate ``[B, K, ...]`` tensors merged
    with the same permutation. Returns ``(vals [B, k], rows [B, k], merged
    extras)``."""
    dev = vals[0].device
    av = torch.cat([v.to(dev) for v in vals], dim=1)
    ai = torch.cat([i.to(dev) for i in gidx], dim=1)
    out_vals, pos = _select(av, k)
    out_idx = torch.gather(ai, 1, pos)
    merged = []
    for parts in extras:
        ae = torch.cat([e.to(dev) for e in parts], dim=1)  # [B, n*K, ...]
        p = pos.reshape(*pos.shape, *([1] * (ae.ndim - 2))).expand(*pos.shape, *ae.shape[2:])
        merged.append(torch.gather(ae, 1, p))
    return out_vals, out_idx, merged


def _blocks(mesh: Mesh, *planes):
    """Each sharded plane's blocks (None stays None), shard by shard."""
    cut = [None if p is None else as_row_shards(p, mesh).blocks for p in planes]
    return [[None if c is None else c[r] for c in cut] for r in range(mesh.size)]


def _zeros_penalty(corpus, mesh: Mesh) -> RowShards:
    return RowShards.full((corpus.shape[0],), 0.0, torch.float32, mesh)


def _local_scans(queries, corpus, penalty, k: int, mesh: Mesh):
    """Each shard's float scan: lists of (values, global rows)."""
    if penalty is None:
        penalty = _zeros_penalty(corpus, mesh)
    vals, gidx = [], []
    for r, (c, pen) in enumerate(_blocks(mesh, corpus, penalty)):
        v, i = cosine_topk(queries.to(c.device), c, k, pen)
        vals.append(v)
        gidx.append(_rebase(i, r, c.shape[0]))
    return vals, gidx


def sharded_topk(
    queries: torch.Tensor,  # [B, D] f32, replicated
    corpus,  # [N, D] (f32, bf16, or [N, 2D] bf16 pairs), row-sharded
    k: int,
    penalty=None,  # [N] f32, row-sharded
    *,
    mesh: Mesh,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the float scan over a row-sharded corpus: each shard's
    ``cosine_topk`` (the ``topk_float`` kernel on CUDA), then the merge.
    Equal to the single-device scan, ties included."""
    vals, gidx = _local_scans(queries, corpus, penalty, k, mesh)
    out_vals, out_idx, _ = _merge_gathered(vals, gidx, k)
    return out_vals, out_idx


def sharded_topk_int8(
    q_codes: torch.Tensor,  # [B, D] int8, replicated
    q_scale: torch.Tensor,  # [B] f32, replicated
    corpus,  # [N, D] int8, row-sharded
    c_scale,  # [N] f32, row-sharded
    k: int,
    penalty=None,  # [N] f32, row-sharded
    *,
    mesh: Mesh,
    rescore_queries: torch.Tensor | None = None,  # [B, D] f32, replicated
    rescore_m: int = 64,
    rescore_residual=None,  # [N, D] int8, row-sharded
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized row-parallel top-k: each shard's ``int8_topk`` (the
    ``topk_int8`` kernel on CUDA) and, with ``rescore_queries``, its exact
    f32 rescore of its own candidates before the merge (from q1, plus the
    q2 plane ``rescore_residual``): candidate rows never leave their
    device, and the merged ranking is the single-device rescored one."""
    if penalty is None:
        penalty = _zeros_penalty(corpus, mesh)
    rescore = rescore_queries is not None
    vals, gidx = [], []
    for r, (c, cs, pen, res) in enumerate(
        _blocks(mesh, corpus, c_scale, penalty, rescore_residual if rescore else None)
    ):
        dev = c.device
        v, i = int8_topk(
            q_codes.to(dev), q_scale.to(dev), c, cs, k, pen,
            rescore_queries=rescore_queries.to(dev) if rescore else None,
            rescore_m=rescore_m, rescore_residual=res,
        )
        vals.append(v)
        gidx.append(_rebase(i, r, c.shape[0]))
    out_vals, out_idx, _ = _merge_gathered(vals, gidx, k)
    return out_vals, out_idx


def sharded_retrieve_tokens(
    q_emb: torch.Tensor,  # [B, D] f32 unit vectors, replicated
    corpus,  # [N, D], row-sharded
    scales,  # [N] f32 (int8 modes), row-sharded
    penalty,  # [N] f32, row-sharded
    tok_ids,  # [N, Tc] int32, row-sharded
    tok_mask,  # [N, Tc] int32, row-sharded
    tok_weights,  # [N, Tc] f32, row-sharded, or None (no lexical weights)
    k: int,
    tok_cvecs=None,  # [N, Tc, r] int8, row-sharded
    tok_cscale=None,  # [N, Tc] f32, row-sharded
    residual=None,  # [N, D] int8 (int8r q2 plane), row-sharded
    *,
    mesh: Mesh,
):
    """The retrieval stage of the mesh fused query: each shard's scan (int8
    with the exact rescore, or float), then the K winners' cached tokens
    gathered *on their shard* and merged with the scores by the same
    permutation. Returns ``(vals [B, k], global rows [B, k], cand_ids /
    cand_mask [B, k, Tc], cand_weights, cand_cvecs, cand_cscale)``, the
    last two None without a ColBERT cache."""
    quantized = corpus.dtype == torch.int8
    if quantized:
        q_codes, q_scale = quantize_rows_int8(q_emb)
    with_cb = tok_cvecs is not None
    vals, gidx = [], []
    extras = [[] for _ in range(5 if with_cb else 3)]
    planes = _blocks(mesh, corpus, scales, penalty, residual, tok_ids, tok_mask, tok_weights,
                     tok_cvecs, tok_cscale)
    for r, (c, cs, pen, res, ids, mask, w, cv, csc) in enumerate(planes):
        dev = c.device
        q = q_emb.to(dev)
        if quantized:
            v, i = int8_topk(
                q_codes.to(dev), q_scale.to(dev), c, cs, k, pen, rescore_queries=q,
                rescore_residual=res if res is not None and res.shape[1] else None,
            )
        else:
            v, i = cosine_topk(q, c, k, pen)
        rows = i.long()
        vals.append(v)
        gidx.append(_rebase(i, r, c.shape[0]))
        cand_w = w[rows] if w is not None else torch.zeros(rows.shape + ids.shape[1:], device=dev)
        local = [ids[rows], mask[rows], cand_w] + ([cv[rows], csc[rows]] if with_cb else [])
        for acc, cand in zip(extras, local):
            acc.append(cand)  # [B, K, Tc, ...]: gathered on the shard
    out_vals, out_idx, merged = _merge_gathered(vals, gidx, k, extras)
    if not with_cb:
        merged += [None, None]
    return (out_vals, out_idx, *merged)


def sharded_topk_2d(
    queries: torch.Tensor,  # [B, D], replicated
    corpus,  # [N, D], rows sharded over ("dcn", "ici")
    k: int,
    penalty=None,
    *,
    mesh: Mesh,  # axes ("dcn", "ici")
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-level merge for a multi-slice layout: each shard's scan, a merge
    within each slice over the ``ici`` axis, then one merge of the slices'
    lists over ``dcn`` (K entries a slice cross it, not K a device). Shard
    ``(d, i)`` holds block ``d * ici + i``; equal to the flat scan, ties
    included."""
    if mesh.axis_names != (DCN_AXIS, ICI_AXIS):
        raise ValueError(f"sharded_topk_2d takes a ({DCN_AXIS}, {ICI_AXIS}) mesh, got {mesh}")
    vals, gidx = _local_scans(queries, corpus, penalty, k, mesh)
    n_dcn, n_ici = mesh.shape
    slices = []
    for d in range(n_dcn):
        part = slice(d * n_ici, (d + 1) * n_ici)
        v, i, _ = _merge_gathered(vals[part], gidx[part], k)
        slices.append((v, i))
    out_vals, out_idx, _ = _merge_gathered([v for v, _ in slices], [i for _, i in slices], k)
    return out_vals, out_idx
