"""Device-resident chunk-token cache.

Port of ``outline_rag_tpu/index/tokens.py``: the tokenized text of every
indexed chunk as fixed-width int32 rows parallel to the shard, so the
fused query gathers candidate tokens on the device by top-K row index and
feeds the cross-encoder without a host round trip. The ColBERT vector
cache is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from outline_rag_tpu_torch.device import resolve_device


@dataclasses.dataclass
class TokenCacheState:
    ids: torch.Tensor  # [capacity, width] int32
    mask: torch.Tensor  # [capacity, width] int32
    weights: torch.Tensor  # [capacity, width] f32 lexical weights (0 = none)


def _as_rows(x, n: int, width: int, fill, dtype, device) -> torch.Tensor:
    """``x`` ([n, w] array or tensor) clipped or padded to ``width``."""
    out = torch.full((n, width), fill, dtype=dtype, device=device)
    if x is not None:
        x = torch.as_tensor(x, device=device)
        w = min(x.shape[1], width)
        out[:, :w] = x[:, :w].to(dtype)
    return out


class TokenCache:
    def __init__(
        self,
        capacity: int,
        width: int,
        pad_id: int = 1,
        *,
        device: str | torch.device,
    ):
        self.width = width
        self.pad_id = pad_id
        self.device = resolve_device(device)
        self.state = TokenCacheState(
            ids=torch.full((capacity, width), pad_id, dtype=torch.int32, device=self.device),
            mask=torch.zeros((capacity, width), dtype=torch.int32, device=self.device),
            weights=torch.zeros((capacity, width), dtype=torch.float32, device=self.device),
        )

    def write(
        self,
        start: int,
        token_ids: np.ndarray | torch.Tensor,
        token_mask: np.ndarray | torch.Tensor,
        token_weights: np.ndarray | torch.Tensor | None = None,
    ) -> None:
        """Write rows [start : start+n) in place; rows are clipped or padded
        to the cache width."""
        n = token_ids.shape[0]
        if n == 0:
            return
        rows = torch.arange(start, start + n, device=self.device)
        dev, w = self.device, self.width
        self.state.ids.index_copy_(0, rows, _as_rows(token_ids, n, w, self.pad_id, torch.int32, dev))
        self.state.mask.index_copy_(0, rows, _as_rows(token_mask, n, w, 0, torch.int32, dev))
        self.state.weights.index_copy_(
            0, rows, _as_rows(token_weights, n, w, 0.0, torch.float32, dev)
        )
