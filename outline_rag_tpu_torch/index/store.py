"""VectorIndex: the queryable, mutable vector store.

Port of ``outline_rag_tpu/index/store.py`` for the int8 scan dtypes:

- ``add_chunks`` / ``delete_source`` implement the delete-then-add per-doc
  update protocol as tombstone + append on the device shard; rows are
  L2-normalized and quantized on the index's device.
- ``query`` runs the int8 scan (the CUDA kernel on a GPU), the exact fp32
  candidate rescore, and translates device rows back to chunk ids.

Not ported yet: growth and compaction (``add_chunks`` past capacity
raises, as ``DeviceShard.append`` does), ``save``/``load`` snapshots,
capacity pre-warming, mesh sharding and the ColBERT projection.

Concurrency: one writer, many concurrent readers. Mutations write the
shard's tensors in place, so readers enter a read section (``_RWLock``)
around snapshot -> scan -> fetch -> row-id translation, and the writer
waits for in-flight readers before it writes.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from outline_rag_tpu_torch.index.shard import DeviceShard
from outline_rag_tpu_torch.index.tokens import TokenCache
from outline_rag_tpu_torch.ops.quant import (
    int8_topk,
    quantize_rows_int8,
    quantize_rows_int8_residual,
)
from outline_rag_tpu_torch.ops.topk import NEG


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit L2 norm (zero rows stay zero), f32."""
    x = x.float()
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.where(norms == 0, torch.ones_like(norms), norms)


class _RWLock:
    """Writer-preferring reader-writer lock.

    Readers run concurrently; a writer first blocks new readers, then
    waits for in-flight readers to drain (they hold tensors the writer is
    about to overwrite), then runs exclusively.
    """

    def __init__(self):
        self._cv = threading.Condition()
        self._readers = 0
        self._writer = False

    @contextlib.contextmanager
    def read(self):
        with self._cv:
            while self._writer:
                self._cv.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cv:
                self._readers -= 1
                if not self._readers:
                    self._cv.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cv:
            while self._writer:
                self._cv.wait()
            self._writer = True
        try:
            # drain in-flight readers INSIDE the try: an async exception
            # (KeyboardInterrupt) delivered mid-wait must still clear
            # _writer or every later read()/write() deadlocks forever
            with self._cv:
                while self._readers:
                    self._cv.wait()
            yield
        finally:
            with self._cv:
                self._writer = False
                self._cv.notify_all()


class VectorIndex:
    def __init__(
        self,
        dim: int,
        capacity: int = 1 << 17,
        dtype: str = "int8r",
        *,
        device: str | torch.device,
        token_width: int | None = None,
        token_pad_id: int = 1,
    ):
        self.dim = dim
        self.dtype = dtype
        self._shard = DeviceShard(capacity, dim, dtype, device)
        self.device = self._shard.device
        self.token_width = token_width
        self.token_pad_id = token_pad_id
        self.tokens = (
            TokenCache(capacity, token_width, token_pad_id, device=self.device)
            if token_width
            else None
        )
        self._by_chunk: dict[str, int] = {}  # chunk_id -> row
        self._by_source: dict[str, list[str]] = {}  # source_id -> chunk ids
        self._rw = _RWLock()

    def read_section(self):
        """Context manager for external readers (FusedEngine): snapshot,
        scan, fetch and row-id translation all happen inside."""
        return self._rw.read()

    def snapshot(self):
        """(shard state, row-id map); use inside a read section."""
        return self._shard.snapshot()

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------

    def add_chunks(
        self,
        chunk_ids: list[str],
        vectors: np.ndarray | torch.Tensor,
        source_id: str,
        replace: bool = True,
        token_ids: np.ndarray | torch.Tensor | None = None,
        token_mask: np.ndarray | torch.Tensor | None = None,
        token_weights: np.ndarray | torch.Tensor | None = None,
    ) -> np.ndarray:
        """Index chunks of one source document; returns their rows. With
        ``replace`` (the default), existing chunks of the same source are
        tombstoned first (delete-then-add per document). ``token_ids`` /
        ``token_mask`` feed the token cache for the fused rerank path."""
        vecs = torch.as_tensor(vectors, device=self.device)
        if tuple(vecs.shape) != (len(chunk_ids), self.dim):
            raise ValueError(f"vectors {tuple(vecs.shape)} for {len(chunk_ids)} ids, dim {self.dim}")
        # preparation outside the write section: concurrent queries only
        # wait for the in-place writes below
        vecs = normalize_rows(vecs)
        residual = None
        if self.dtype == "int8r":
            codes, scales, residual = quantize_rows_int8_residual(vecs)
        else:
            codes, scales = quantize_rows_int8(vecs)
        with self._rw.write():
            # checked before the tombstones: a refused add changes nothing
            if len(chunk_ids) > self._shard.free:
                raise IndexError(
                    f"index full: {len(chunk_ids)} rows requested, "
                    f"{self._shard.free} free of {self._shard.capacity}; "
                    "growth and compaction are not ported"
                )
            if replace:
                self._delete_source_locked(source_id)
            start = self._shard.cursor
            rows = self._shard.append(chunk_ids, codes, scales, residual)
            if self.tokens is not None and token_ids is not None:
                if token_mask is None:
                    token_mask = torch.as_tensor(token_ids) != self.token_pad_id
                self.tokens.write(start, token_ids, token_mask, token_weights)
            for cid, row in zip(chunk_ids, rows):
                self._by_chunk[cid] = int(row)
            self._by_source.setdefault(source_id, []).extend(chunk_ids)
        return rows

    def delete_source(self, source_id: str) -> int:
        with self._rw.write():
            return self._delete_source_locked(source_id)

    def _delete_source_locked(self, source_id: str) -> int:
        cids = self._by_source.pop(source_id, [])
        rows = [self._by_chunk.pop(c) for c in cids if c in self._by_chunk]
        self._shard.tombstone(np.asarray(rows, np.int64))
        return len(rows)

    def delete_chunks(self, chunk_ids: list[str]) -> int:
        with self._rw.write():
            rows = [self._by_chunk.pop(c) for c in chunk_ids if c in self._by_chunk]
            self._shard.tombstone(np.asarray(rows, np.int64))
            for cids in self._by_source.values():
                for c in chunk_ids:
                    if c in cids:
                        cids.remove(c)
            return len(rows)

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------

    @property
    def size(self) -> int:
        return self._shard.live

    def query(
        self, queries: np.ndarray | torch.Tensor, k: int
    ) -> tuple[list[list[str]], np.ndarray]:
        """Top-k chunk ids + cosine scores per query. ``queries`` [B, dim].
        The scan's top 64 candidates are rescored exactly in f32 (from q1,
        plus q2 in ``int8r``) before the final k."""
        q = normalize_rows(torch.as_tensor(queries, device=self.device).reshape(-1, self.dim))
        qq, qs = quantize_rows_int8(q)
        with self._rw.read():
            state, row_ids = self._shard.snapshot()
            vals, idx = int8_topk(
                qq, qs, state.vectors, state.scales, min(k, state.capacity),
                state.penalty, rescore_queries=q,
                rescore_residual=state.residual if self.dtype == "int8r" else None,
            )
            vals = vals.cpu().numpy()
            idx = idx.cpu().numpy()
            # translate row -> chunk id inside the read section: the
            # writer rewrites row_ids in place once readers drain
            out_ids = [
                [str(row_ids[i]) for v, i in zip(vrow, irow) if v > NEG / 2]
                for vrow, irow in zip(vals, idx)
            ]
        return out_ids, vals
