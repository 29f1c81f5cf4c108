"""Host-memory-resident index planes: page-locked host tensors whose rows the
card reads and writes over PCIe.

Port of ``outline_rag_tpu/ops/hostmem.py``. The 10M-row exact-ranking rung
of an int8r index has a q2 residual plane (N x D int8, 10 GB at 10M x 1024)
that only the rescore of each query's top 64 candidates reads, some 64 KB a
query. Keeping it in the host's RAM leaves device memory to the scanned q1
plane and costs one PCIe row gather per query batch.

A host plane is a CPU tensor; placed for the card it is page-locked, and
then the card reaches its rows through the unified address space:

- :func:`to_pinned_host` — a numpy array or tensor as a host plane:
                           page-locked by default, a plain CPU tensor with
                           ``device="cpu"`` (PyTorch can page-lock only with
                           a CUDA device).
- :func:`is_host_resident` — True for a CPU tensor.
- :func:`gather_rows`    — ``plane [N, D]``, ``idx [B, M]`` -> ``[B, M, D]``
                           on ``idx``'s device. A page-locked plane with
                           indices on the card launches the kernel
                           ``host_gather_rows`` (``csrc/hostmem.cu``): only
                           the gathered rows cross the bus. A plane on the
                           indices' device is indexed as it lies,
                           ``plane[idx]`` (JAX's ``jnp.take``).
                           A pageable CPU plane with indices on the card
                           raises: copying the plane to the card is what this
                           module exists to avoid.
- :func:`make_host_append` — ``append(plane, rows [K, D], idx [K])``, written
                           in place into the host plane (JAX donates it):
                           the kernel ``host_scatter_rows`` for rows on the
                           card, :func:`scatter_rows_plain` for rows on the
                           CPU. JAX's ``device`` argument picks the device
                           whose pinned-host placement to use; here the
                           rows' own device picks the route, so there is
                           none.

An out-of-range index never touches a host plane: its gathered row is zero,
and its appended row is dropped (the JAX gather promises in-range indices and
leaves the rest undefined; its scatter drops them, as the shard padding
convention wants, ``index/shard.py::_append_block``). A plane on the card is
indexed as it lies, and its callers keep to in-range rows as JAX's do.

The JAX module's ``pinned_host_sharding`` has no counterpart: it returns a
JAX ``Sharding`` with ``memory_kind="pinned_host"``, and PyTorch has no such
object. A page-locked CPU tensor is the placement itself.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from outline_rag_tpu_torch.device import resolve_device


def to_pinned_host(x, device=None) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) copied into a new CPU tensor:
    page-locked for the card ``device`` (default: the current CUDA device),
    or a plain CPU tensor for ``device="cpu"``."""
    dev = resolve_device("cuda" if device is None else device)
    host = isinstance(x, np.ndarray)
    dtype = torch.from_numpy(np.empty(0, x.dtype)).dtype if host else x.dtype
    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        out = torch.empty(tuple(x.shape), dtype=dtype, pin_memory=dev.type == "cuda")
    if host:
        out.numpy()[...] = x  # numpy writes it: a read-only array needs no tensor view
        return out
    return out.copy_(x)


def is_host_resident(x) -> bool:
    """True for a tensor in host memory (page-locked or not)."""
    return isinstance(x, torch.Tensor) and x.device.type == "cpu"


def gather_rows_plain(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``plane[idx]`` in plain PyTorch, on the device both lie on, with a row
    of zeros for an index outside ``[0, N)``: the twin of
    :func:`host_gather_rows`."""
    if plane.shape[0] == 0:
        return plane.new_zeros((*idx.shape, *plane.shape[1:]), device=idx.device)
    i = idx.long()
    ok = (i >= 0) & (i < plane.shape[0])
    rows = plane[torch.where(ok, i, torch.zeros_like(i))]
    return rows.masked_fill(~ok.reshape(*ok.shape, *(1,) * (plane.dim() - 1)), 0)


def scatter_rows_plain(plane: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``plane[idx] = rows`` in place, in plain PyTorch on the device all
    three lie on, dropping every row whose index is outside ``[0, N)``: the
    twin of :func:`host_scatter_rows`. Returns ``plane``."""
    i = idx.long()
    keep = (i >= 0) & (i < plane.shape[0])
    return plane.index_copy_(0, i[keep], rows[keep])


_launch_fns: dict[str, object] = {}


def _launcher(name: str):
    if name not in _launch_fns:
        from outline_rag_tpu_torch.ops._build import load_library  # noqa: PLC0415

        lib = load_library()
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        gather = lib.host_gather_rows_launch
        gather.argtypes = [p, p, p, i64, i64, i64, p]
        gather.restype = ctypes.c_int
        scatter = lib.host_scatter_rows_launch
        scatter.argtypes = [p, p, p, i64, i64, i64, p]
        scatter.restype = ctypes.c_int
        _launch_fns.update(gather=gather, scatter=scatter)
    return _launch_fns[name]


def _check_plane(plane: torch.Tensor, what: str) -> None:
    if not is_host_resident(plane):
        raise ValueError(f"{what} takes a host plane (a CPU tensor), not one on {plane.device}")
    if plane.dim() != 2 or not plane.is_contiguous():
        raise ValueError(f"{what} takes a contiguous [N, D] plane, got {tuple(plane.shape)}")


def _check_pinned(plane: torch.Tensor, what: str) -> None:
    if not plane.is_pinned():
        raise ValueError(
            f"{what}: the plane is pageable host memory, which the card cannot read by row; "
            "place it with to_pinned_host (copying the whole plane to the card is what a "
            "host plane avoids)"
        )


def host_gather_rows(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx [...]`` of the host plane ``plane [N, D]``: ``[..., D]`` on
    ``idx``'s device, a row of zeros for an index outside ``[0, N)``.

    With ``idx`` on the card this launches ``csrc/hostmem.cu``'s gather,
    which reads the rows of the page-locked plane over PCIe (a pageable
    plane raises), and counts the launch in ``host_gather_rows.launches``;
    with ``idx`` on the CPU it runs :func:`gather_rows_plain`."""
    _check_plane(plane, "host_gather_rows")
    if idx.device.type == "cpu":
        return gather_rows_plain(plane, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"host_gather_rows takes indices on cpu or cuda, not {idx.device}")
    _check_pinned(plane, "host_gather_rows")
    idx32 = idx.to(torch.int32).contiguous()
    out = torch.empty((*idx.shape, plane.shape[1]), dtype=plane.dtype, device=idx.device)
    if out.numel() == 0 or plane.shape[0] == 0:
        return out.zero_()
    launch = _launcher("gather")
    with torch.cuda.device(idx.device):
        rc = launch(
            plane.data_ptr(), idx32.data_ptr(), out.data_ptr(), idx32.numel(), plane.shape[0],
            plane.shape[1] * plane.element_size(),
            torch.cuda.current_stream(idx.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"host_gather_rows kernel launch failed with CUDA error {rc}")
    host_gather_rows.launches += 1
    return out


host_gather_rows.launches = 0


def host_scatter_rows(plane: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``plane[idx] = rows`` in place into the host plane ``plane [N, D]``,
    dropping every row whose index is outside ``[0, N)``; in-range indices
    must be distinct. Returns ``plane``.

    With ``rows`` on the card this launches ``csrc/hostmem.cu``'s scatter,
    which writes through the page-locked plane's mapping (a pageable plane
    raises), and counts the launch in ``host_scatter_rows.launches``: like
    any launch it is asynchronous, and the host sees the rows once the
    current stream has passed it (``torch.cuda.synchronize()``). With
    ``rows`` on the CPU it runs :func:`scatter_rows_plain`."""
    _check_plane(plane, "host_scatter_rows")
    if rows.dim() != 2 or rows.shape[1] != plane.shape[1] or rows.dtype != plane.dtype:
        raise ValueError(
            f"rows {rows.dtype} {tuple(rows.shape)} do not fit a plane "
            f"{plane.dtype} {tuple(plane.shape)}"
        )
    idx = torch.as_tensor(idx, device=rows.device)
    if tuple(idx.shape) != (rows.shape[0],):
        raise ValueError(f"idx must be [{rows.shape[0]}], got {tuple(idx.shape)}")
    if rows.device.type == "cpu":
        return scatter_rows_plain(plane, rows, idx)
    if rows.device.type != "cuda":
        raise ValueError(f"host_scatter_rows takes rows on cpu or cuda, not {rows.device}")
    _check_pinned(plane, "host_scatter_rows")
    if rows.shape[0] == 0 or plane.shape[0] == 0:
        return plane
    rows, idx32 = rows.contiguous(), idx.to(torch.int32).contiguous()
    launch = _launcher("scatter")
    with torch.cuda.device(rows.device):
        rc = launch(
            plane.data_ptr(), rows.data_ptr(), idx32.data_ptr(), rows.shape[0], plane.shape[0],
            plane.shape[1] * plane.element_size(),
            torch.cuda.current_stream(rows.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"host_scatter_rows kernel launch failed with CUDA error {rc}")
    host_scatter_rows.launches += 1
    return plane


host_scatter_rows.launches = 0


def gather_rows(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``plane [N, D]`` (host- or device-resident), ``idx [B, M]`` ->
    ``[B, M, D]`` rows on ``idx``'s device. A host plane goes through
    :func:`host_gather_rows` (bytes moved = gathered rows, not plane size;
    a row of zeros for an index outside ``[0, N)``); a plane on ``idx``'s
    device is ``plane[idx]``, as JAX's ``jnp.take``, for in-range indices."""
    if is_host_resident(plane):
        return host_gather_rows(plane, idx)
    if plane.device != idx.device:
        raise ValueError(f"plane on {plane.device} and idx on {idx.device}: gather on one device")
    return plane[idx]


def make_host_append():
    """``append(plane, rows [K, D], idx [K] int32) -> plane``: write ``rows``
    into the host plane at ``idx`` in place and return the same tensor
    (:func:`host_scatter_rows`: the kernel for rows on the card, the twin
    for rows on the CPU; out-of-range indices are dropped)."""

    def append(plane: torch.Tensor, rows: torch.Tensor, idx) -> torch.Tensor:
        rows = torch.as_tensor(rows)
        return host_scatter_rows(plane, rows, torch.as_tensor(idx, device=rows.device))

    return append


__all__ = [
    "to_pinned_host",
    "is_host_resident",
    "gather_rows",
    "gather_rows_plain",
    "host_gather_rows",
    "host_scatter_rows",
    "make_host_append",
    "scatter_rows_plain",
]
