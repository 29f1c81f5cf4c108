"""Delta refresh + batch ingestion.

Preserves the reference's full-refresh protocol (``refresh_all_task``,
reference ``app/rag.py:265-344``) and batch ingestion
(``process_doc_batch_task``, reference ``app/rag.py:119-262``):

- diff remote ``{id: updatedAt}`` against the local document table;
- delete orphans, enqueue add/update ids in REFRESH_BATCH_SIZE batches on
  the task queue (competing consumers);
- per doc: fetch info+export, skip empty, chunk with title injection,
  embed (through the idempotent embedding cache), land on the device index
  as tombstone+append (replace semantics);
- progress counters advance in ``finally`` so a failed batch still
  completes the refresh (failure -> skipped, reference ``rag.py:244-258``);
- status JSON with TTL + lock release semantics
  (reference ``rag.py:309-344``, ``api.py:984-1007``).
"""

from __future__ import annotations

import asyncio
import logging
import time

import numpy as np

from outline_rag_tpu_torch.utils.chunking import chunk_document
from outline_rag_tpu_torch.utils.hashing import embedding_cache_key, stable_chunk_id

log = logging.getLogger(__name__)

TASK_QUEUE = "task_queue"
REFRESH_LOCK = "refresh:lock"
REFRESH_STATUS = "refresh:status"
REFRESH_TOTAL = "refresh:total_count"
REFRESH_SUCCESS = "refresh:success_count"
REFRESH_SKIPPED = "refresh:skipped_count"
WEBHOOK_TIMER = "webhook:refresh_timer_due"
WEBHOOK_TRIGGER_LOCK = "webhook:trigger_lock"


class CachedEmbedder:
    """Embedding cache wrapper: SHA-256 keyed KV read-through/write-back
    with idempotent (INSERT OR IGNORE) writes — semantics of the
    reference's CacheBackedEmbeddings + IdempotentSQLStore
    (``app/llm_services.py:118-126,55-87``)."""

    NAMESPACE = "emb_cache"

    def __init__(self, inner, meta):
        self.inner = inner
        self.meta = meta

    @property
    def dim(self) -> int:
        return self.inner.dim

    @property
    def model_name(self) -> str:
        return getattr(self.inner, "model_name", "encoder")

    def embed(self, texts: list[str]) -> np.ndarray:
        keys = [embedding_cache_key(self.model_name, t) for t in texts]
        cached = self.meta.kv_mget(self.NAMESPACE, keys)
        out = np.zeros((len(texts), self.dim), np.float32)
        misses: list[int] = []
        for i, blob in enumerate(cached):
            if blob is not None and len(blob) == self.dim * 4:
                out[i] = np.frombuffer(blob, np.float32)
            else:
                misses.append(i)
        if misses:
            fresh = self.inner.embed([texts[i] for i in misses])
            to_store = []
            for j, i in enumerate(misses):
                out[i] = fresh[j]
                to_store.append((keys[i], fresh[j].astype(np.float32).tobytes()))
            try:
                self.meta.kv_mset(self.NAMESPACE, to_store)
            except Exception:
                log.warning("embedding cache write failed (non-fatal)")
        return out


class Ingestor:
    def __init__(
        self,
        outline,  # OutlineClient
        meta,  # SqliteMetaStore
        index,  # VectorIndex
        embedder,  # anything with .embed / .dim
        bus,  # Bus
        settings,
        tokenizer=None,  # optional: fills the device token cache
    ):
        self.outline = outline
        self.meta = meta
        self.index = index
        self.embedder = CachedEmbedder(embedder, meta)
        self.bus = bus
        self.s = settings
        self.tokenizer = tokenizer

    # -- full refresh (delta sync) --------------------------------------

    async def refresh_all(self) -> dict:
        started = time.time()
        try:
            remote = await self.outline.list_docs()
        except Exception:
            log.exception("outline listing failed; aborting refresh")
            await self.bus.set(
                REFRESH_STATUS,
                {"state": "failed", "error": "outline listing failed"},
                ex=300,
            )
            await self.bus.delete(REFRESH_LOCK)
            return {"state": "failed"}

        local = self.meta.local_doc_versions()
        remote_ids = set(remote)
        local_ids = set(local)
        to_delete = sorted(local_ids - remote_ids)
        to_add = sorted(remote_ids - local_ids)
        to_update = sorted(
            i for i in remote_ids & local_ids if remote[i]["updatedAt"] != local[i]
        )
        for sid in to_delete:
            try:
                # off the event loop (device tombstone work) and isolated:
                # one failing delete must not abort the refresh with the
                # lock held
                await asyncio.to_thread(self.delete_doc, sid)
            except Exception:
                log.exception("delete failed for %s (continuing)", sid)

        work = to_add + to_update
        await self.bus.set_counter(REFRESH_TOTAL, len(work))
        await self.bus.set_counter(REFRESH_SUCCESS, 0)
        await self.bus.set_counter(REFRESH_SKIPPED, 0)
        status = {
            "state": "running",
            "total": len(work),
            "deleted": len(to_delete),
            "started_at": started,
        }
        await self.bus.set(REFRESH_STATUS, status, ex=3600)

        batch = self.s.refresh_batch_size
        for off in range(0, len(work), batch):
            await self.bus.push(
                TASK_QUEUE,
                {"task": "process_doc_batch", "ids": work[off : off + batch]},
            )
        if not work:
            await self.bus.set(
                REFRESH_STATUS,
                {"state": "done", "total": 0, "deleted": len(to_delete)},
                ex=300,
            )
            await self.bus.delete(REFRESH_LOCK)
        return status

    # -- batch ingestion ------------------------------------------------

    async def process_doc_batch(self, ids: list[str]) -> None:
        for doc_id in ids:
            ok = False
            try:
                info = await self.outline.get_doc_info(doc_id)
                text = await self.outline.export_doc(doc_id)
                if not text or not text.strip():
                    log.info("doc %s empty; skipping", doc_id)
                    continue
                # to_thread: the encoder forward + device landing can
                # take seconds (cold compiles: tens) — run it off the
                # event loop so SSE keepalives and /api/ask keep flowing
                await asyncio.to_thread(
                    self.ingest_document,
                    doc_id,
                    info.get("title", ""),
                    info.get("url", ""),
                    info.get("updatedAt", ""),
                    text,
                )
                ok = True
            except Exception:
                log.exception("ingest failed for doc %s", doc_id)
            finally:
                # counters advance regardless so refresh completes
                # (reference rag.py:250-258)
                await self.bus.incr(REFRESH_SUCCESS if ok else REFRESH_SKIPPED)
        # worker-side finalization: completing the queued work must
        # release REFRESH_LOCK itself — leaving it to a client status
        # poll kept the lock (and 429s + dropped webhook timers) for its
        # full TTL whenever nobody had the UI open
        await refresh_status(self.bus)

    def ingest_document(
        self, source_id: str, title: str, url: str, updated_at: str, text: str
    ) -> int:
        """Chunk, embed, and land one document (sync; called from worker
        context). Returns number of chunks indexed."""
        chunks = chunk_document(
            title, text, self.s.chunk_size, self.s.chunk_overlap
        )
        if not chunks:
            return 0
        chunk_ids = [
            stable_chunk_id(source_id, c.seq, c.text) for c in chunks
        ]
        vectors = self.embedder.embed([c.text for c in chunks])
        token_ids = token_mask = token_weights = None
        cb_codes = cb_scales = None
        if self.tokenizer is not None and self.index.tokens is not None:
            tb = self.tokenizer.batch(
                [c.text for c in chunks],
                self.index.token_width,
                buckets=(self.index.token_width,),
            )
            token_ids, token_mask = tb.input_ids, tb.attention_mask
            inner = self.embedder.inner
            if getattr(inner, "has_sparse_head", False):
                token_weights = inner.token_weights(token_ids, token_mask)
            if (
                self.index.tokens.colbert is not None
                and getattr(inner, "has_colbert_head", False)
            ):
                hc = inner.encoder.colbert.out_features
                cb_codes, cb_scales = inner.colbert_cache(
                    token_ids,
                    token_mask,
                    self.index.colbert_rank,
                    # index-pinned matrix: persisted in the snapshot so
                    # query-side scoring provably shares it (ADVICE r2)
                    proj=self.index.colbert_projection_for(hc),
                )
        # index landing FIRST: recording the new updatedAt before a
        # failed add_chunks would make the delta diff consider the doc
        # current forever (never retried) while its old index rows point
        # at deleted chunk ids. If the meta writes below fail instead,
        # the stale updatedAt just re-ingests the doc next refresh —
        # replace semantics make that idempotent.
        self.index.add_chunks(
            chunk_ids,
            vectors,
            source_id=source_id,
            replace=True,
            token_ids=token_ids,
            token_mask=token_mask,
            token_weights=token_weights,
            colbert_codes=cb_codes,
            colbert_scales=cb_scales,
        )
        self.meta.upsert_document(source_id, title, url, updated_at, text)
        self.meta.replace_chunks(
            source_id,
            [(cid, c.seq, c.body, c.start) for cid, c in zip(chunk_ids, chunks)],
        )
        return len(chunks)

    def delete_doc(self, source_id: str) -> None:
        self.index.delete_source(source_id)
        self.meta.delete_document(source_id)

    def rebuild_from_store(self) -> int:
        """Reconstruct the device index from the host document store after
        a restart (the index is a derived artifact; the document table is
        the source of truth — SURVEY.md section 5 checkpoint/resume; the
        embedding cache makes this mostly KV reads, not encoder work).
        Returns the number of documents indexed."""
        count = 0
        for source_id in list(self.meta.local_doc_versions()):
            doc = self.meta.get_document(source_id)
            if not doc:
                continue
            try:
                self.ingest_document(
                    source_id,
                    doc["title"],
                    doc["url"],
                    doc["updated_at"],
                    doc["text"],
                )
                count += 1
            except Exception:
                log.exception("rebuild failed for %s", source_id)
        return count

    # -- workers --------------------------------------------------------

    async def task_worker(self) -> None:
        """Queue consumer loop (reference ``app/main.py:40-64``)."""
        import asyncio

        while True:
            try:
                item = await self.bus.pop(TASK_QUEUE, timeout=5)
                if item is None:
                    continue
                task = item.get("task")
                if task == "refresh_all":
                    await self.refresh_all()
                elif task == "process_doc_batch":
                    await self.process_doc_batch(item.get("ids", []))
                else:
                    log.warning("unknown task %r", task)
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("task worker error; continuing")
                await asyncio.sleep(1)

    async def webhook_watcher(self, poll_s: float = 5.0) -> None:
        """Debounce watcher (reference ``app/main.py:67-87``): when the
        timer set by webhook events expires, take the trigger lock and
        enqueue a full refresh."""
        import asyncio

        while True:
            try:
                await asyncio.sleep(poll_s)
                due = await self.bus.get(WEBHOOK_TIMER)
                if due is None or time.time() < float(due):
                    continue
                if await self.bus.set_nx(WEBHOOK_TRIGGER_LOCK, 1, ex=60):
                    if await self.bus.set_nx(REFRESH_LOCK, 1, ex=3600):
                        await self.bus.delete(WEBHOOK_TIMER)
                        await self.bus.push(TASK_QUEUE, {"task": "refresh_all"})
                    # else: a refresh is running — KEEP the due timer so
                    # the update isn't dropped; the watcher retries once
                    # the trigger lock expires
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("webhook watcher error; continuing")


async def refresh_status(bus) -> dict:
    """Aggregate progress from counters; when complete, finalize status and
    clear keys (reference ``api.py:984-1007``)."""
    status = await bus.get(REFRESH_STATUS)
    if status is None:
        return {"state": "idle"}
    if status.get("state") != "running":
        return status
    total = await bus.get_counter(REFRESH_TOTAL)
    done = await bus.get_counter(REFRESH_SUCCESS)
    skipped = await bus.get_counter(REFRESH_SKIPPED)
    if total and done + skipped >= total:
        final = {
            "state": "done",
            "total": total,
            "success": done,
            "skipped": skipped,
        }
        await bus.set(REFRESH_STATUS, final, ex=300)
        await bus.delete(REFRESH_LOCK, REFRESH_TOTAL, REFRESH_SUCCESS, REFRESH_SKIPPED)
        return final
    return {
        "state": "running",
        "total": total,
        "success": done,
        "skipped": skipped,
        "progress": (done + skipped) / total if total else 0.0,
    }
