"""Mutable device-resident embedding shards.

Port of ``outline_rag_tpu/index/shard.py``. A shard is a capacity-padded
row matrix with per-row scales and an additive validity penalty
(0 = live, NEG = tombstoned or unused), all preallocated on the index's
device. Mutations write in place (slice copies / ``index_fill_``) — the
port's analogue of the JAX package's donated buffers — so nothing is
reallocated, and the scan always runs over the full capacity with the
penalty masking dead rows.

Dtypes, as in the JAX package: ``float32`` and ``bfloat16`` rows;
``f32x2``, rows stored pre-split as compensated bf16 pairs
``[capacity, 2 * dim]`` (``ops/topk.py::split_f32_bf16x2``: fp32-class
scores, 4 bytes per dimension); ``int8`` codes, and ``int8r`` (int8 plus
the q2 residual plane read by the rescore).

Given a row sharding (``parallel/mesh.py``), every plane is a
:class:`~outline_rag_tpu_torch.parallel.mesh.RowShards` of equal, contiguous
row blocks over the mesh, the q2 plane too; the cursor, the row map and the
generation stay global.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from outline_rag_tpu_torch.device import resolve_device
from outline_rag_tpu_torch.ops.topk import NEG
from outline_rag_tpu_torch.parallel.mesh import RowShards, RowSharding, fill_rows, row_pieces

# index dtype -> (storage dtype, row width in units of dim)
_STORAGE = {
    "float32": (torch.float32, 1),
    "bfloat16": (torch.bfloat16, 1),
    "f32x2": (torch.bfloat16, 2),
    "int8": (torch.int8, 1),
    "int8r": (torch.int8, 1),
}
DTYPES = tuple(_STORAGE)


@dataclasses.dataclass
class ShardState:
    """Tensors of one shard.

    Each is a tensor, or a :class:`RowShards` under a row sharding.

    ``vectors``  [capacity, w]    rows: f32 or bf16 (w = dim), bf16 pairs
                                  (f32x2, w = 2 dim), or int8 codes (the
                                  q1 plane).
    ``scales``   [capacity]       f32 per-row scales (int8 modes; ones
                                  otherwise).
    ``penalty``  [capacity]       f32 additive mask: 0 live, NEG dead.
    ``residual`` [capacity, rdim] int8 q2 plane: rdim == dim in ``int8r``
                                  mode, 0 otherwise, so the structure is
                                  the same in every mode.
    """

    vectors: torch.Tensor
    scales: torch.Tensor
    penalty: torch.Tensor
    residual: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

def init_state(
    capacity: int, dim: int, dtype: str, device: str | torch.device,
    sharding: RowSharding | None = None,
) -> ShardState:
    """Zeroed planes on ``device``, or row-sharded over ``sharding.mesh``
    (``capacity`` must divide by its size)."""
    if dtype not in DTYPES:
        raise ValueError(f"index dtype {dtype!r}: use one of {DTYPES}")
    storage, width = _STORAGE[dtype]
    if sharding is not None:
        mesh = sharding.mesh

        def full(shape, fill, dt):
            return RowShards.full(shape, fill, dt, mesh)
    else:
        dev = resolve_device(device)

        def full(shape, fill, dt):
            return torch.full(shape, fill, dtype=dt, device=dev)

    return ShardState(
        vectors=full((capacity, width * dim), 0, storage),
        scales=full((capacity,), 1.0, torch.float32),
        penalty=full((capacity,), NEG, torch.float32),
        residual=full((capacity, dim if dtype == "int8r" else 0), 0, torch.int8),
    )


class DeviceShard:
    """Host-side manager for one shard: the write cursor, the live count,
    the row -> chunk-id map (device row indices are translated here) and
    the generation, bumped by every append and tombstone that writes a
    row."""

    def __init__(
        self, capacity: int, dim: int, dtype: str, device: str | torch.device,
        sharding: RowSharding | None = None,
    ):
        self.state = init_state(capacity, dim, dtype, device, sharding)
        self.device = self.state.vectors.device
        self.row_ids: np.ndarray = np.full(capacity, "", dtype=object)
        self.cursor = 0  # next free row
        self.live = 0
        self.generation = 0

    @property
    def capacity(self) -> int:
        return self.state.capacity

    @property
    def free(self) -> int:
        return self.capacity - self.cursor

    def append(
        self,
        chunk_ids: list[str],
        rows: torch.Tensor,  # [n, w], any device; cast to the storage dtype
        scales: torch.Tensor,  # [n] f32
        residual: torch.Tensor | None = None,  # [n, dim] int8 (int8r mode)
    ) -> np.ndarray:
        """Write rows at the cursor; returns the assigned row indices."""
        n = rows.shape[0]
        if n == 0:
            return np.empty(0, np.int64)
        if n > self.free:
            raise IndexError(f"shard full: {n} rows requested, {self.free} free")
        if self.state.residual.shape[1] and residual is None:
            raise ValueError("int8r shard append requires the residual plane")
        # the rows are contiguous: slice copies cast in place and take rows
        # from the host without a staging copy on the device
        planes = [(self.state.vectors, rows), (self.state.scales, scales),
                  (self.state.penalty, None)]
        if self.state.residual.shape[1]:
            planes.append((self.state.residual, residual))
        for plane, src in planes:
            for blk, lo, hi, off in row_pieces(plane, self.cursor, self.cursor + n):
                at = off - self.cursor
                if src is None:
                    blk[lo:hi] = 0.0  # the penalty: live
                else:
                    blk[lo:hi].copy_(src[at:at + hi - lo])
        assigned = np.arange(self.cursor, self.cursor + n)
        self.row_ids[self.cursor : self.cursor + n] = chunk_ids
        self.cursor += n
        self.live += n
        self.generation += 1
        return assigned

    def tombstone(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        fill_rows(self.state.penalty, rows, NEG)
        self.row_ids[rows] = ""
        self.live -= rows.size
        self.generation += 1

    def snapshot(self) -> tuple[ShardState, np.ndarray]:
        """(state, row-id map) for a reader. The tensors are written in
        place, so readers hold the index's read section while they use
        them."""
        return self.state, self.row_ids
