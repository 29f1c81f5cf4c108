"""VectorIndex: the queryable, mutable, persistable vector store.

Port of ``outline_rag_tpu/index/store.py``:

- ``add_chunks`` / ``delete_source`` implement the delete-then-add per-doc
  update protocol as tombstone + append on the device shard; rows are
  L2-normalized on the index's device, then quantized (int8 modes), cast
  (bfloat16) or split into bf16 pairs once (f32x2).
- An add that finds no free rows rebuilds the shard without its
  tombstones: at the same capacity when that makes room (the churn of
  delta updates), else at the next doubling (``_compact_locked``). Live
  rows keep their ascending row order, so ties rank the same before and
  after, and the old planes are freed before the new ones are allocated.
- ``query`` runs the scan (a CUDA kernel on a GPU): for the int8 modes the
  int8 scan and the exact fp32 rescore of the top ``rescore_m``
  candidates, for the float modes ``cosine_topk``; then it translates
  device rows back to chunk ids.
- ``save`` / ``load`` / ``adopt``: a snapshot is ``<path>.npz`` plus
  ``<path>.meta.json`` with the JAX package's keys, paired by a save tag;
  either package loads the other's.

Not ported: capacity pre-warming (the port compiles nothing per capacity)
and mesh sharding.

Concurrency: one writer, many concurrent readers. Mutations write the
shard's tensors in place, so readers enter a read section (``_RWLock``)
around snapshot -> scan -> fetch -> row-id translation, and the writer
waits for in-flight readers before it writes or swaps the shard.
"""

from __future__ import annotations

import contextlib
import json
import os
import secrets
import tempfile
import threading
import traceback

import numpy as np
import torch

from outline_rag_tpu_torch.index.shard import DeviceShard
from outline_rag_tpu_torch.index.tokens import TokenCache
from outline_rag_tpu_torch.models.encoder import colbert_projection
from outline_rag_tpu_torch.ops.quant import (
    int8_topk,
    quantize_rows_int8,
    quantize_rows_int8_residual,
)
from outline_rag_tpu_torch.ops.topk import NEG, cosine_topk, split_f32_bf16x2

INT8_DTYPES = ("int8", "int8r")

# the JAX package re-draws the matrix of a snapshot with ColBERT codes and
# no colbert_proj from jax.random, whose bits the port cannot reproduce:
# scoring those codes with any other matrix would be wrong without a sign
_NO_PROJ = (
    "snapshot {path} has ColBERT codes but no colbert_proj (a snapshot from before the "
    "projection was saved, or codes projected with a matrix the index never pinned): "
    "its matrix cannot be reproduced without jax.random; re-ingest it, or re-save it "
    "with the JAX package"
)


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


def _snapshot_paths(path: str) -> tuple[str, str]:
    return (path if path.endswith(".npz") else path + ".npz"), path + ".meta.json"


def _write_atomic(final: str, write) -> str:
    """``write(file)`` into a temporary file unique to this call in
    ``final``'s directory; returns its name, for ``os.replace``."""
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(final) or ".", prefix=os.path.basename(final) + ".", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
    except BaseException:
        os.unlink(tmp)
        raise
    return tmp


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
        colbert_rank: int = 0,
        rescore_m: int = 64,
    ):
        self.dim = dim
        self.dtype = dtype
        # int8 modes: the scan's top ``rescore_m`` candidates are rescored
        # exactly in f32 before the final k (0 turns the rescore off)
        self.rescore_m = rescore_m if dtype in INT8_DTYPES else 0
        self._shard = DeviceShard(capacity, dim, dtype, device)
        self.device = self._shard.device
        self.token_width = token_width
        self.token_pad_id = token_pad_id
        self.colbert_rank = colbert_rank
        self.tokens = self._new_tokens(capacity)
        self._by_chunk: dict[str, int] = {}  # chunk_id -> row
        self._by_source: dict[str, list[str]] = {}  # source_id -> chunk ids
        self._rw = _RWLock()
        self._save_lock = threading.Lock()  # pairs each save's two renames
        # the [Hc, colbert_rank] projection of the cached ColBERT codes:
        # pinned by the first colbert_projection_for, carried by snapshots
        self.colbert_proj: np.ndarray | None = None

    def _new_tokens(self, capacity: int) -> TokenCache | None:
        if not self.token_width:
            return None
        return TokenCache(
            capacity, self.token_width, self.token_pad_id, device=self.device,
            colbert_rank=self.colbert_rank,
        )

    def read_section(self):
        """Context manager for external readers (FusedEngine): snapshot,
        scan, fetch and row-id translation all happen inside."""
        return self._rw.read()

    def snapshot(self):
        """(shard state, row-id map); use inside a read section."""
        return self._shard.snapshot()

    def colbert_projection_for(self, hc: int) -> np.ndarray:
        """The [hc, colbert_rank] projection shared by ingest and query.
        The first caller pins it on the index (``models/encoder.py::
        colbert_projection``); a loaded snapshot brings the matrix its
        codes were projected with."""
        if self.colbert_rank <= 0:
            raise ValueError("index has no ColBERT cache (colbert_rank=0)")
        if self.colbert_proj is None:
            self.colbert_proj = colbert_projection(hc, self.colbert_rank).numpy()
        if self.colbert_proj.shape != (hc, self.colbert_rank):
            raise ValueError(
                f"ColBERT projection shape {self.colbert_proj.shape} does not match the "
                f"encoder head ({hc}, {self.colbert_rank}): the snapshot was ingested "
                "with another encoder"
            )
        return self.colbert_proj

    # ------------------------------------------------------------------
    # capacity
    # ------------------------------------------------------------------

    def _next_capacity(self, needed: int, size: int) -> int:
        cap = new_cap = self._shard.capacity
        while new_cap - size < needed or new_cap == cap:
            new_cap *= 2
        return new_cap

    def _index_bytes(self, cap: int) -> int:
        """Device bytes of the index at capacity ``cap``: vectors, the q2
        plane, scales and penalty, the token cache and its ColBERT planes."""
        vectors = self._shard.state.vectors
        width = vectors.shape[1] * vectors.element_size() + self._shard.state.residual.shape[1]
        need = cap * width + cap * 8
        if self.tokens is not None:
            need += cap * self.token_width * 12  # ids, mask, weights
            if self.colbert_rank:
                need += cap * self.token_width * (self.colbert_rank + 4)
        return need

    def _growth_would_fit(self, cap: int) -> bool:
        """Whether the index at ``cap`` fits the card: the rebuild frees the
        old planes before it allocates the new ones, so the new index must
        fit in what is free, what the caching allocator holds unused, and
        the old index's own bytes. Nothing to check on the CPU."""
        if self.device.type != "cuda":
            return True
        free, _ = torch.cuda.mem_get_info(self.device)
        unused = torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        return self._index_bytes(cap) <= free + unused + self._index_bytes(self._shard.capacity)

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
        colbert_codes: np.ndarray | torch.Tensor | None = None,
        colbert_scales: np.ndarray | torch.Tensor | None = None,
    ) -> np.ndarray:
        """Index chunks of one source document; returns their rows. With
        ``replace`` (the default), existing chunks of the same source are
        tombstoned first (delete-then-add per document). ``token_ids`` /
        ``token_mask`` / ``token_weights`` and the ColBERT codes feed the
        token cache for the fused path. Past the free rows the shard is
        rebuilt first: compacted at its capacity if dropping tombstones
        makes room, else grown; a growth that cannot fit the card raises
        ``RuntimeError`` and changes nothing."""
        n = len(chunk_ids)
        vecs = torch.as_tensor(vectors, device=self.device)
        if tuple(vecs.shape) != (n, self.dim):
            raise ValueError(f"vectors {tuple(vecs.shape)} for {n} ids, dim {self.dim}")
        # preparation outside the write section: concurrent queries only
        # wait for the in-place writes below
        vecs = normalize_rows(vecs)
        scales = torch.ones(n, dtype=torch.float32, device=self.device)
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
            rebuild_at = None
            if n > self._shard.free:
                # decided before the tombstones, so a refused growth
                # changes nothing
                size = self.size - (self._live_in_source(source_id) if replace else 0)
                rebuild_at = self._shard.capacity
                if size + n > rebuild_at:
                    rebuild_at = self._next_capacity(n, size)
                    self._check_growth(rebuild_at)
            if replace:
                self._delete_source_locked(source_id)
            if rebuild_at is not None:
                self._compact_locked(rebuild_at)
            start = self._shard.cursor
            rows = self._shard.append(chunk_ids, rows, scales, residual)
            if self.tokens is not None and token_ids is not None:
                if token_mask is None:
                    token_mask = torch.as_tensor(token_ids) != self.token_pad_id
                self.tokens.write(
                    start, token_ids, token_mask, token_weights, colbert_codes, colbert_scales
                )
            for cid, row in zip(chunk_ids, rows):
                self._by_chunk[cid] = int(row)
            self._by_source.setdefault(source_id, []).extend(chunk_ids)
        return rows

    def _live_in_source(self, source_id: str) -> int:
        return sum(c in self._by_chunk for c in self._by_source.get(source_id, ()))

    def _check_growth(self, cap: int) -> None:
        if not self._growth_would_fit(cap):
            raise RuntimeError(
                f"index at terminal capacity for this device: growing to {cap} rows "
                f"(~{self._index_bytes(cap) / 1e9:.1f} GB) cannot fit the card's memory. "
                "Use a smaller dtype (bfloat16 / int8 store 2-4x the rows) or delete sources."
            )

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

    def compact(self) -> None:
        """Rewrite the shard at its capacity keeping only live rows (drops
        tombstones)."""
        with self._rw.write():
            self._compact_locked(self._shard.capacity)

    def _compact_locked(self, cap: int) -> None:
        """Rebuild the shard and token cache at ``cap`` with the live rows
        in ascending row order. Each plane is copied to the host whole and
        the live rows picked there; the old planes are freed before the new
        ones are allocated, so the device holds max(old, new), not both. If
        the rebuild fails (the allocation, most likely), the index is
        rebuilt at its old capacity from the host copies and the error
        re-raised."""
        state, row_ids = self._shard.snapshot()
        live = np.nonzero(state.penalty.cpu().numpy() > NEG / 2)[0]
        pick = torch.from_numpy(live)

        def host(plane: torch.Tensor) -> torch.Tensor:
            return plane.cpu()[pick]

        vecs, scales, res = host(state.vectors), host(state.scales), host(state.residual)
        ids = list(row_ids[live])
        tok = cb = None
        if self.tokens is not None:
            tok = [host(x) for x in (self.tokens.state.ids, self.tokens.state.mask,
                                     self.tokens.state.weights)]
            if self.tokens.colbert is not None:
                cb = [host(self.tokens.colbert.codes), host(self.tokens.colbert.scales)]
        old_cap, old_gen = self._shard.capacity, self._shard.generation
        # every live row is on the host now: free the old planes first.
        # Readers have drained (the write lock), so none holds them.
        del state
        self._shard.state = None  # type: ignore[assignment]
        if self.tokens is not None:
            self.tokens.state = self.tokens.colbert = None  # type: ignore[assignment]

        def rebuild(at_cap: int) -> None:
            self._shard = DeviceShard(at_cap, self.dim, self.dtype, self.device)
            # generation stays monotonic across rebuilds: change detectors
            # must never see a rebuilt shard walk numbers again
            self._shard.generation = old_gen + 1
            self.tokens = self._new_tokens(at_cap)
            self._by_chunk.clear()
            rows = self._shard.append(ids, vecs, scales, res if res.shape[1] else None)
            if tok is not None:
                self.tokens.write(0, *tok, *(cb or (None, None)))
            self._by_chunk.update(zip(ids, rows.tolist()))

        try:
            rebuild(cap)
        except Exception as err:
            # drop what the failed rebuild allocated first: the shard, and
            # a half-built token cache's planes, which only the traceback's
            # frames hold. The restore then needs the old planes alone.
            self._shard = self.tokens = None  # type: ignore[assignment]
            traceback.clear_frames(err.__traceback__)
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            rebuild(old_cap)
            raise

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------

    @property
    def size(self) -> int:
        return self._shard.live

    @property
    def capacity(self) -> int:
        return self._shard.capacity

    @property
    def generation(self) -> int:
        return self._shard.generation

    def query(
        self, queries: np.ndarray | torch.Tensor, k: int
    ) -> tuple[list[list[str]], np.ndarray]:
        """Top-k chunk ids + cosine scores per query. ``queries`` [B, dim].
        In the int8 modes the scan's top ``rescore_m`` candidates are
        rescored exactly in f32 (from q1, plus q2 in ``int8r``) before the
        final k; the float modes score through ``cosine_topk``."""
        q = normalize_rows(torch.as_tensor(queries, device=self.device).reshape(-1, self.dim))
        with self._rw.read():
            state, row_ids = self._shard.snapshot()
            k_eff = min(k, state.capacity)
            if self.dtype in INT8_DTYPES:
                qq, qs = quantize_rows_int8(q)
                rescore = self.rescore_m > 0
                vals, idx = int8_topk(
                    qq, qs, state.vectors, state.scales, k_eff, state.penalty,
                    rescore_queries=q if rescore else None,
                    rescore_m=self.rescore_m,
                    rescore_residual=state.residual if self.dtype == "int8r" and rescore else None,
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

    # ------------------------------------------------------------------
    # snapshots
    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        """Snapshot to ``<path>.npz`` + ``<path>.meta.json``, the JAX
        package's files and keys, paired by a random save tag. Rows past
        the cursor were never written and are left out. Int8 modes store
        their q1 codes as int8 (the JAX package reads them exactly through
        its f32 staging); float modes store f32, cast exactly from bf16
        and the bf16 pairs of f32x2.

        Only the device-to-host fetches hold the read section: a writer
        queued behind a multi-GB disk write would stall every query. Each
        call writes temporary files of its own, and the two renames happen
        under one lock, so saves that run at once leave a paired snapshot."""
        with self._rw.read():
            state, row_ids = self._shard.snapshot()
            n = self._shard.cursor

            def fetch(x: torch.Tensor) -> np.ndarray:
                x = x[:n].cpu()  # bf16 widens on the host, not in device memory
                return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

            arrays = {
                "vectors": fetch(state.vectors),
                "scales": fetch(state.scales),
                "penalty": fetch(state.penalty),
            }
            if state.residual.shape[1]:
                arrays["residual"] = fetch(state.residual)
            if self.tokens is not None:
                arrays["token_ids"] = fetch(self.tokens.state.ids)
                arrays["token_mask"] = fetch(self.tokens.state.mask)
                arrays["token_weights"] = fetch(self.tokens.state.weights)
                if self.tokens.colbert is not None:
                    arrays["colbert_codes"] = fetch(self.tokens.colbert.codes)
                    arrays["colbert_scales"] = fetch(self.tokens.colbert.scales)
                    if self.colbert_proj is not None:
                        arrays["colbert_proj"] = self.colbert_proj
                    elif arrays["colbert_scales"].any():
                        # codes projected with a matrix the index never
                        # pinned: ``load`` would refuse the snapshot
                        raise ValueError(_NO_PROJ.format(path=path))
            meta = {
                "dim": self.dim,
                "dtype": self.dtype,
                "capacity": self._shard.capacity,
                "cursor": n,
                "generation": self._shard.generation,
                "row_ids": [str(r) for r in row_ids[:n]],
                # copied inside the section: the lists alias live state
                "by_source": {k: list(v) for k, v in self._by_source.items()},
                "token_width": self.token_width,
                "token_pad_id": self.token_pad_id,
                "colbert_rank": self.colbert_rank,
            }
        tag = secrets.token_hex(8)
        arrays["save_tag"] = np.frombuffer(bytes.fromhex(tag), np.uint8).copy()
        meta["save_tag"] = tag
        npz_path, meta_path = _snapshot_paths(path)
        os.makedirs(os.path.dirname(npz_path) or ".", exist_ok=True)
        tmp_npz = _write_atomic(npz_path, lambda f: np.savez(f, **arrays))
        try:
            tmp_meta = _write_atomic(meta_path, lambda f: f.write(json.dumps(meta).encode()))
        except BaseException:
            os.unlink(tmp_npz)
            raise
        with self._save_lock:
            os.replace(tmp_npz, npz_path)
            os.replace(tmp_meta, meta_path)

    def adopt(self, other: "VectorIndex") -> None:
        """Take over ``other``'s contents (shard, token cache, id maps,
        ColBERT projection) under the write lock: the restore path for an
        index that services already hold. ``other`` must match the
        index's dim, dtype, token width, ColBERT rank and device. The
        generation moves past this index's own."""
        mine = (self.dim, self.dtype, self.token_width, self.colbert_rank, self.device)
        theirs = (other.dim, other.dtype, other.token_width, other.colbert_rank, other.device)
        if theirs != mine:
            raise ValueError(
                "snapshot config mismatch: snapshot (dim, dtype, token_width, colbert_rank, "
                f"device) = {theirs} vs index {mine}"
            )
        with self._rw.write():
            # the served index's generation never walks back
            other._shard.generation = max(other._shard.generation, self._shard.generation + 1)
            self._shard = other._shard
            self.tokens = other.tokens
            self._by_chunk = other._by_chunk
            self._by_source = other._by_source
            self.colbert_proj = other.colbert_proj

    @classmethod
    def load(cls, path: str, *, device: str | torch.device) -> "VectorIndex":
        """An index from a snapshot written by either package: the live rows
        only, in their saved order, and ``by_source`` restricted to them.
        Refuses an npz and a meta.json of two different saves, and ColBERT
        codes without their projection matrix."""
        npz_path, meta_path = _snapshot_paths(path)
        with open(meta_path) as f:
            meta = json.load(f)
        with np.load(npz_path) as npz:
            arrays = {k: npz[k] for k in npz.files}
        want_tag = meta.get("save_tag")
        if want_tag is not None:
            got = bytes(arrays["save_tag"].astype(np.uint8)).hex() if "save_tag" in arrays else None
            if got != want_tag:
                raise ValueError(
                    f"snapshot npz and meta are from different saves (meta tag {want_tag}, "
                    f"npz tag {got}): refusing to bind row ids to other vectors "
                    "(rebuild from the store)"
                )
        rank = meta.get("colbert_rank", 0)
        if rank and "colbert_proj" not in arrays and arrays.get("colbert_scales", np.zeros(0)).any():
            raise ValueError(_NO_PROJ.format(path=path))
        index = cls(
            dim=meta["dim"], capacity=meta["capacity"], dtype=meta["dtype"], device=device,
            token_width=meta.get("token_width"), token_pad_id=meta.get("token_pad_id", 1),
            colbert_rank=rank,
        )
        if "colbert_proj" in arrays:
            index.colbert_proj = np.asarray(arrays["colbert_proj"], np.float32)
        cursor = meta["cursor"]
        row_ids = np.asarray(meta["row_ids"][:cursor], dtype=object)
        live = np.nonzero((arrays["penalty"][:cursor] > NEG / 2) & (row_ids != ""))[0]
        if live.size:

            def rows(name: str) -> torch.Tensor | None:
                return torch.from_numpy(arrays[name][live]) if name in arrays else None

            ids = [str(c) for c in row_ids[live]]
            assigned = index._shard.append(
                ids, rows("vectors"), rows("scales"), rows("residual")
            )
            if index.tokens is not None and "token_ids" in arrays:
                index.tokens.write(
                    0, rows("token_ids"), rows("token_mask"), rows("token_weights"),
                    rows("colbert_codes"), rows("colbert_scales"),
                )
            index._by_chunk.update(zip(ids, assigned.tolist()))
        for src, cids in meta["by_source"].items():
            kept = [c for c in cids if c in index._by_chunk]
            if kept:
                index._by_source[src] = kept
        return index
