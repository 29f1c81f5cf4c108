"""VectorIndex: the queryable, mutable vector store.

Port of ``outline_rag_tpu/index/store.py``:

- ``add_chunks`` / ``delete_source`` implement the delete-then-add per-doc
  update protocol as tombstone + append on the device shard; rows are
  L2-normalized on the index's device, then quantized (int8 modes), cast
  (bfloat16) or split into bf16 pairs once (f32x2).
- ``query`` runs the scan (a CUDA kernel on a GPU): for the int8 modes the
  int8 scan and the exact fp32 candidate rescore, for the float modes
  ``cosine_topk``; then it translates device rows back to chunk ids.

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
from outline_rag_tpu_torch.ops.topk import NEG, cosine_topk, split_f32_bf16x2

INT8_DTYPES = ("int8", "int8r")


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
        dtype: str = "float32",
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
        scales = torch.ones(len(chunk_ids), dtype=torch.float32, device=self.device)
        residual = None
        if self.dtype == "int8r":
            rows, scales, residual = quantize_rows_int8_residual(vecs)
        elif self.dtype == "int8":
            rows, scales = quantize_rows_int8(vecs)
        elif self.dtype == "f32x2":
            rows = split_f32_bf16x2(vecs)  # paid once here, not per query
        else:
            rows = vecs  # float32, or rounded to bfloat16 by the append
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
            rows = self._shard.append(chunk_ids, rows, scales, residual)
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
        In the int8 modes the scan's top 64 candidates are rescored exactly
        in f32 (from q1, plus q2 in ``int8r``) before the final k; the
        float modes score through ``cosine_topk``."""
        q = normalize_rows(torch.as_tensor(queries, device=self.device).reshape(-1, self.dim))
        with self._rw.read():
            state, row_ids = self._shard.snapshot()
            k_eff = min(k, state.capacity)
            if self.dtype in INT8_DTYPES:
                qq, qs = quantize_rows_int8(q)
                vals, idx = int8_topk(
                    qq, qs, state.vectors, state.scales, k_eff, state.penalty,
                    rescore_queries=q,
                    rescore_residual=state.residual if self.dtype == "int8r" else None,
                )
            else:
                vals, idx = cosine_topk(q, state.vectors, k_eff, state.penalty)
            vals = vals.cpu().numpy()
            idx = idx.cpu().numpy()
            # translate row -> chunk id inside the read section: the
            # writer rewrites row_ids in place once readers drain
            out_ids = [
                [str(row_ids[i]) for v, i in zip(vrow, irow) if v > NEG / 2]
                for vrow, irow in zip(vals, idx)
            ]
        return out_ids, vals
