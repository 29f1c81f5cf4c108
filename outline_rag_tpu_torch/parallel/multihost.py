"""Multi-process orchestration for index builds and queries.

Port of ``outline_rag_tpu/parallel/multihost.py``. The JAX package runs one
Python process per host under ``jax.distributed``; the port's counterpart is
``torch.distributed``, with the backend named by the caller (``gloo`` on
the CPU, or when the processes share a card; ``nccl`` where each process
has a card of its own). Nothing here picks a backend by itself.

Division of labour for an index build:

- each process encodes a contiguous slice of the chunk list
  (:func:`host_slice`) on its own devices, with no traffic between them;
- :func:`global_row_sharded` makes each process's block its part of one
  global ``[N, D]`` array: process h owns global rows ``[h*N/H, (h+1)*N/H)``
  (its devices' row blocks, in order), and no process ever holds the whole
  matrix;
- :func:`sharded_topk_across` queries it: each process scans its blocks
  (``parallel/query.py``), and the ``[B, K]`` lists are all-gathered and
  merged in process order, so every process returns the same global top-K,
  with the single-process scan's ties.

Where a collective meets a CUDA tensor under ``gloo``, which moves host
memory, the tensor is staged through the host.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch
import torch.distributed as dist

from outline_rag_tpu_torch.ops.topk import NEG
from outline_rag_tpu_torch.parallel.mesh import Mesh, RowShards, data_mesh, visible_devices
from outline_rag_tpu_torch.parallel.query import _merge_gathered, _rebase, sharded_topk

log = logging.getLogger(__name__)


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
) -> None:
    """Join the process group at ``coordinator_address`` (``host:port``)
    as rank ``process_id`` of ``num_processes`` over ``backend``. Nothing
    to join without ``num_processes`` (a single-process run); a world of
    one is initialized, so the collectives' path runs alone."""
    if not num_processes:
        return
    if backend is None:
        raise ValueError("init_multihost needs its backend named: 'gloo' or 'nccl'")
    if coordinator_address is None or process_id is None:
        raise ValueError("init_multihost needs coordinator_address and process_id")
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )
    log.info("multihost: process %d/%d over %s", dist.get_rank(), dist.get_world_size(), backend)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _staged(t: torch.Tensor) -> bool:
    return dist.get_backend() == "gloo" and t.device.type == "cuda"


def all_gather_tensor(t: torch.Tensor) -> list[torch.Tensor]:
    """Every process's ``t`` (same shape and dtype everywhere), in process
    order, on ``t``'s device."""
    src = t.detach().cpu() if _staged(t) else t.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(out, src)
    return [o.to(t.device) for o in out]


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the processes, in place."""
    if _staged(t):
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """One ``data`` axis over every device of every process: this process's
    devices (``local``), its rank and the world size. Global shard
    ``rank * local.size + r`` is device r of process ``rank``."""

    local: Mesh
    rank: int
    world: int


def global_data_mesh(devices=None) -> ProcessMesh:
    """This process's devices (the visible CUDA devices by default) as its
    part of the global ``data`` axis."""
    local = data_mesh(None, devices if devices is not None else visible_devices("cuda"))
    return ProcessMesh(local, process_index(), process_count())


def host_slice(n_total: int) -> tuple[int, int]:
    """This process's contiguous ``[start, stop)`` slice of an ``n_total``
    item work list: equal blocks, the last one short, as
    :func:`global_row_sharded` pads them. With unequal blocks
    (``n_total % process_count() != 0``) the paired ``global_row_sharded``
    must get ``n_global=n_total``."""
    return _host_slice(n_total, process_index(), process_count())


def _host_slice(n_total: int, h: int, nh: int) -> tuple[int, int]:
    per = math.ceil(n_total / nh)
    return min(h * per, n_total), min((h + 1) * per, n_total)


@dataclasses.dataclass
class GlobalRows:
    """A ``[N, ...]`` array row-sharded over a :class:`ProcessMesh`: this
    process holds ``local``, its ``N / world`` rows as row blocks over its
    devices."""

    local: RowShards
    mesh: ProcessMesh

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.local.shape[0] * self.mesh.world, *self.local.shape[1:]))

    @property
    def rows_per_process(self) -> int:
        return self.local.shape[0]


def global_row_sharded(
    local_rows,  # [N_local, ...] this process's block
    mesh: ProcessMesh,
    n_global: int | None = None,
    fill=0,
    penalty: bool = False,
) -> GlobalRows:
    """This process's block as its part of one global row-sharded array.

    Blocks are padded to equal sizes of ``ceil(n_global / world)`` rows.
    Penalty rows pass ``penalty=True``: their padding is the ``NEG``
    tombstone, so a pad row never enters a top-K (a zero pad would score 0
    and win wherever every true similarity is negative). ``n_global``
    defaults to ``N_local * world``, right only for equal blocks: with the
    short last block of :func:`host_slice`, every process must pass the true
    ``n_global`` or the processes disagree on the shape."""
    if penalty:
        fill = NEG
    rows = torch.as_tensor(local_rows)
    nh = mesh.world
    if n_global is None:
        n_global = rows.shape[0] * nh
    per = math.ceil(n_global / nh)
    if rows.shape[0] > per:
        raise ValueError(f"a block of {rows.shape[0]} rows for {per} rows a process")
    if rows.shape[0] < per:
        pad = torch.full((per - rows.shape[0], *rows.shape[1:]), fill, dtype=rows.dtype)
        rows = torch.cat([rows, pad.to(rows.device)], dim=0)
    return GlobalRows(RowShards.split(rows, mesh.local), mesh)


def replicated_from_host0(value, mesh: ProcessMesh) -> torch.Tensor:
    """A small array on this process's first device. Every process passes a
    value of the same shape and dtype; its contents are taken as this
    process holds them (callers pass the same data everywhere, such as a
    query batch the serving tier sent to all)."""
    return torch.as_tensor(value).to(mesh.local.devices[0])


def sharded_topk_across(
    queries: torch.Tensor,  # [B, D] f32, the same on every process
    corpus: GlobalRows,  # [N, D]
    k: int,
    penalty: GlobalRows | None = None,  # [N] f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """The float scan's top-k over a corpus row-sharded across processes:
    each process's :func:`~outline_rag_tpu_torch.parallel.query.sharded_topk`
    over its blocks, its rows rebased by its first global row, then one
    all-gather of the ``[B, k]`` lists and the shard-major merge. Every
    process returns the same ``(values, rows)``."""
    mesh = corpus.mesh
    vals, idx = sharded_topk(
        queries, corpus.local, k, None if penalty is None else penalty.local, mesh=mesh.local
    )
    idx = _rebase(idx, mesh.rank, corpus.rows_per_process)
    out_vals, out_idx, _ = _merge_gathered(all_gather_tensor(vals), all_gather_tensor(idx), k)
    return out_vals, out_idx


def build_and_query_demo(
    chunks_per_host: int,
    dim: int,
    queries: np.ndarray,
    k: int,
    seed: int = 0,
    devices=None,
) -> tuple[np.ndarray, np.ndarray]:
    """The multi-process flow end to end: every process makes its slice
    (seeded by its rank, as an encoder would embed it), assembles the global
    sharded corpus, and runs the sharded query on ``devices`` (its visible
    CUDA devices by default). Returns ``(vals, idx)``, the same on every
    process."""
    mesh = global_data_mesh(devices)
    rng = np.random.default_rng(seed + mesh.rank)
    local = rng.standard_normal((chunks_per_host, dim)).astype(np.float32)
    local /= np.linalg.norm(local, axis=1, keepdims=True)
    corpus = global_row_sharded(local, mesh)
    penalty = global_row_sharded(np.zeros((chunks_per_host,), np.float32), mesh, penalty=True)
    q = replicated_from_host0(queries.astype(np.float32), mesh)
    vals, idx = sharded_topk_across(q, corpus, k, penalty)
    return vals.cpu().numpy(), idx.cpu().numpy()
