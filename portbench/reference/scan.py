"""The exact retrieval top-k: f32 cosine over every live row, TF32 off.

The rows are the benchmark's own f32 draws, made again block by block from
the seed (``portbench/weights.py::block_rows``) and scaled to unit length
here. Ties go to the lower row, as a stable sort gives them.
"""

from __future__ import annotations

import torch

from portbench.reference.xlmr import _no_tf32


def unit(x: torch.Tensor) -> torch.Tensor:
    n = x.norm(dim=1, keepdim=True)
    return x / torch.where(n == 0, torch.ones_like(n), n)


def exact_topk(q: torch.Tensor, blocks, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values [B, k], rows [B, k])`` of the ``k`` best rows for unit
    queries ``q`` [B, D] over ``blocks``: an iterable of ``(first_row,
    vectors [n, D])`` in row order."""
    best_v = best_i = None
    with _no_tf32():
        for first, vecs in blocks:
            s = q @ unit(vecs.float()).T
            i = torch.arange(first, first + vecs.shape[0], device=q.device).expand_as(s)
            if best_v is not None:
                s, i = torch.cat([best_v, s], 1), torch.cat([best_i, i], 1)
            order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
            best_v, best_i = torch.gather(s, 1, order), torch.gather(i, 1, order)
    return best_v, best_i


def dot(q: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Cosine of unit ``q`` [D] with the row ``vec`` [D]."""
    with _no_tf32():
        return q @ unit(vec[None].float())[0]
