"""Device-resident chunk-token cache.

Port of ``outline_rag_tpu/index/tokens.py``: the tokenized text of every
indexed chunk as fixed-width int32 rows parallel to the shard, so the
fused query gathers candidate tokens on the device by top-K row index and
feeds the cross-encoder without a host round trip. With ``colbert_rank``
the cache also holds each token's projected ColBERT vector as int8 codes
and a scale, so the late-interaction term gathers candidates' vectors by
row instead of re-encoding them.

Under a row sharding every plane is row-sharded like the index's shard
(``parallel/mesh.py``), so a shard gathers its candidates' tokens locally.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from outline_rag_tpu_torch.device import resolve_device
from outline_rag_tpu_torch.parallel.mesh import RowShards, RowSharding, row_pieces


@dataclasses.dataclass
class TokenCacheState:
    ids: torch.Tensor | RowShards  # [capacity, width] int32
    mask: torch.Tensor | RowShards  # [capacity, width] int32
    weights: torch.Tensor | RowShards  # [capacity, width] f32 lexical weights (0 = none)


@dataclasses.dataclass
class ColbertCacheState:
    """Projected per-token ColBERT vectors (``models/encoder.py::
    colbert_cache_codes``); a zero scale contributes nothing to MaxSim."""

    codes: torch.Tensor | RowShards  # [capacity, width, rank] int8
    scales: torch.Tensor | RowShards  # [capacity, width] f32


def _put(plane, start: int, n: int, x, fill) -> None:
    """Rows [start : start+n) of ``plane`` ([cap, width, *tail], a tensor or
    row blocks) set from ``x`` ([n, w, *...] array or tensor, any device),
    clipped or padded with ``fill`` to the plane's width and trailing
    widths, in place."""
    if x is not None:
        x = torch.as_tensor(x)
        w = min(x.shape[1], plane.shape[1])
        x = x[(slice(None), slice(0, w), *(slice(0, t) for t in plane.shape[2:]))]
    for blk, lo, hi, off in row_pieces(plane, start, start + n):
        dst = blk[lo:hi]
        if x is None:
            dst.fill_(fill)
            continue
        dst[:, w:] = fill
        dst[:, :w].copy_(x[off - start:off - start + hi - lo])


class TokenCache:
    def __init__(
        self,
        capacity: int,
        width: int,
        pad_id: int = 1,
        *,
        device: str | torch.device,
        colbert_rank: int = 0,
        sharding: RowSharding | None = None,
    ):
        self.width = width
        self.pad_id = pad_id
        self.colbert_rank = colbert_rank
        if sharding is not None:
            mesh = sharding.mesh
            self.device = mesh.devices[0]

            def full(shape, fill, dt):
                return RowShards.full(shape, fill, dt, mesh)
        else:
            self.device = resolve_device(device)

            def full(shape, fill, dt):
                return torch.full(shape, fill, dtype=dt, device=self.device)

        self.state = TokenCacheState(
            ids=full((capacity, width), pad_id, torch.int32),
            mask=full((capacity, width), 0, torch.int32),
            weights=full((capacity, width), 0.0, torch.float32),
        )
        self.colbert = (
            ColbertCacheState(
                codes=full((capacity, width, colbert_rank), 0, torch.int8),
                scales=full((capacity, width), 0.0, torch.float32),
            )
            if colbert_rank
            else None
        )

    def write(
        self,
        start: int,
        token_ids: np.ndarray | torch.Tensor,
        token_mask: np.ndarray | torch.Tensor,
        token_weights: np.ndarray | torch.Tensor | None = None,
        colbert_codes: np.ndarray | torch.Tensor | None = None,  # [n, w, r] int8
        colbert_scales: np.ndarray | torch.Tensor | None = None,  # [n, w] f32
    ) -> None:
        """Write rows [start : start+n) in place; rows are clipped or padded
        to the cache width. A row written without ColBERT codes gets zero
        codes and scales: the row's earlier occupant's vectors must not
        score for it."""
        n = token_ids.shape[0]
        if n == 0:
            return
        _put(self.state.ids, start, n, token_ids, self.pad_id)
        _put(self.state.mask, start, n, token_mask, 0)
        _put(self.state.weights, start, n, token_weights, 0.0)
        if self.colbert is not None:
            _put(self.colbert.codes, start, n, colbert_codes, 0)
            _put(self.colbert.scales, start, n,
                 None if colbert_codes is None else colbert_scales, 0.0)
