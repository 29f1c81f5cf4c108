"""Device meshes and row-sharded tensors.

Port of ``outline_rag_tpu/parallel/mesh.py``. JAX runs ``shard_map`` in one
process over a ``Mesh`` of devices; the port's :class:`Mesh` is the same
idea made explicit: an ordered list of ``torch.device``\\ s and the names of
its axes (row-major over ``shape``). A row-sharded tensor is a
:class:`RowShards`: ``mesh.size`` contiguous, equal row blocks, block ``r``
holding global rows ``[r * N/n, (r + 1) * N/n)`` on ``mesh.devices[r]``,
the layout ``NamedSharding(mesh, P("data"))`` gives.

A mesh may name one device several times (``["cuda:0"] * 4``): each block
is then its own tensor on that device, and each shard's kernel is its own
launch, which is the counterpart on one card of the virtual devices the
JAX package's tests run on. Asking for more devices than are visible is a
``ValueError``; the mesh never shrinks.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from outline_rag_tpu_torch.device import resolve_device

DATA_AXIS = "data"


class Mesh:
    """Devices, in order, with named axes laid out row-major over
    ``shape`` (one axis of ``len(devices)`` by default)."""

    def __init__(self, devices, axis_names=(DATA_AXIS,), shape=None):
        self.devices = tuple(resolve_device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape) if shape is not None else (len(self.devices),)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len(self.shape) != len(self.axis_names) or math.prod(self.shape) != len(self.devices):
            raise ValueError(
                f"mesh shape {self.shape} with axes {self.axis_names} does not fit "
                f"{len(self.devices)} devices"
            )

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names, self.shape))
        return f"Mesh({axes}; {', '.join(str(d) for d in self.devices)})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and (self.devices, self.axis_names, self.shape) == (
            other.devices, other.axis_names, other.shape
        )

    def __hash__(self) -> int:
        return hash((self.devices, self.axis_names, self.shape))


def visible_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """The devices of ``device``'s kind that this process sees: every CUDA
    device for ``cuda`` (an error without CUDA), the one CPU for ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def pick_devices(n_devices: int | None, devices, what: str) -> list:
    """The first ``n_devices`` of ``devices`` (all of them for None). More
    than there are is a ``ValueError``: silently truncating would shard over
    fewer devices than the caller's plan assumed."""
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested a {n_devices}-device {what} but only "
                f"{len(devices)} device(s) are visible"
            )
        devices = devices[:n_devices]
    return devices


def data_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """One ``data`` axis over the first ``n_devices`` of ``devices`` (the
    visible CUDA devices by default)."""
    if devices is None:
        devices = visible_devices("cuda")
    return Mesh(pick_devices(n_devices, devices, "data mesh"), (DATA_AXIS,))


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """Rows split over every device of ``mesh`` (``P("data")``)."""

    mesh: Mesh


def row_sharding(mesh: Mesh) -> RowSharding:
    return RowSharding(mesh)


class RowShards:
    """A ``[N, ...]`` tensor as ``mesh.size`` contiguous, equal row blocks,
    block ``r`` on ``mesh.devices[r]``. Blocks are written in place; a
    reader takes ``blocks`` as they are."""

    def __init__(self, blocks: list[torch.Tensor], mesh: Mesh):
        if len(blocks) != mesh.size:
            raise ValueError(f"{len(blocks)} blocks for a {mesh.size}-device mesh")
        tail = blocks[0].shape[1:]
        for r, (b, dev) in enumerate(zip(blocks, mesh.devices)):
            if b.shape != blocks[0].shape or b.dtype != blocks[0].dtype:
                raise ValueError(f"block {r} is {b.dtype} {tuple(b.shape)}, block 0 "
                                 f"{blocks[0].dtype} {tuple(blocks[0].shape)}")
            if b.device != dev:
                raise ValueError(f"block {r} is on {b.device}, the mesh puts it on {dev}")
        self.blocks = list(blocks)
        self.mesh = mesh
        self.rows_per_shard = blocks[0].shape[0]
        self.shape = torch.Size((self.rows_per_shard * mesh.size, *tail))

    @classmethod
    def full(cls, shape, fill, dtype: torch.dtype, mesh: Mesh) -> "RowShards":
        n = shape[0]
        if n % mesh.size:
            raise ValueError(f"{n} rows do not split into {mesh.size} equal blocks")
        per = (n // mesh.size, *shape[1:])
        return cls([torch.full(per, fill, dtype=dtype, device=d) for d in mesh.devices], mesh)

    @classmethod
    def split(cls, x: torch.Tensor, mesh: Mesh) -> "RowShards":
        """``x`` cut into the mesh's blocks, each copied to its device."""
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f"{n} rows do not split into {mesh.size} equal blocks")
        per = n // mesh.size
        return cls(
            [x[r * per:(r + 1) * per].to(d).contiguous() for r, d in enumerate(mesh.devices)],
            mesh,
        )

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]

    def element_size(self) -> int:
        return self.blocks[0].element_size()

    def pieces(self, start: int, stop: int):
        """``(block, local start, local stop, offset)`` for each block that
        rows ``[start, stop)`` touch; ``offset`` is where the piece begins
        within ``[start, stop)``."""
        per = self.rows_per_shard
        r = start // per
        while start < stop:
            hi = min(stop, (r + 1) * per)
            yield self.blocks[r], start - r * per, hi - r * per, start
            start, r = hi, r + 1

    def rows(self, start: int, stop: int, device: str | torch.device = "cpu") -> torch.Tensor:
        """Rows ``[start, stop)`` as one tensor on ``device``."""
        parts = [blk[lo:hi].to(device) for blk, lo, hi, _ in self.pieces(start, stop)]
        if not parts:
            return torch.empty((0, *self.shape[1:]), dtype=self.dtype, device=device)
        return torch.cat(parts, dim=0)

    def cpu(self) -> torch.Tensor:
        return self.rows(0, self.shape[0], "cpu")

    def index_fill_(self, rows: np.ndarray, value) -> None:
        """Set whole rows (global indices) to ``value``, in place."""
        rows = np.asarray(rows, np.int64)
        per = self.rows_per_shard
        for r, blk in enumerate(self.blocks):
            local = rows[(rows >= r * per) & (rows < (r + 1) * per)] - r * per
            if local.size:
                blk.index_fill_(0, torch.as_tensor(local, device=blk.device), value)


def row_pieces(plane, start: int, stop: int):
    """:meth:`RowShards.pieces` for a plane that is a :class:`RowShards` or a
    plain tensor (one piece)."""
    if isinstance(plane, RowShards):
        yield from plane.pieces(start, stop)
    elif start < stop:
        yield plane, start, stop, start


def host_rows(plane, start: int, stop: int) -> torch.Tensor:
    """Rows ``[start, stop)`` of a plane as one CPU tensor."""
    if isinstance(plane, RowShards):
        return plane.rows(start, stop)
    return plane[start:stop].cpu()


def fill_rows(plane, rows: np.ndarray, value) -> None:
    """Set whole rows of a plane (global indices) to ``value``, in place."""
    rows = np.asarray(rows, np.int64)
    if rows.size == 0:
        return
    if isinstance(plane, RowShards):
        plane.index_fill_(rows, value)
    else:
        plane.index_fill_(0, torch.as_tensor(rows, device=plane.device), value)


def as_row_shards(x, mesh: Mesh) -> RowShards:
    """``x`` as the mesh's row blocks: a :class:`RowShards` over ``mesh`` as
    it is, a tensor split (``N`` must divide by ``mesh.size``)."""
    if isinstance(x, RowShards):
        if x.mesh != mesh:
            raise ValueError(f"rows sharded over {x.mesh}, asked for {mesh}")
        return x
    return RowShards.split(x, mesh)
