"""Host-side storage and coordination.

The reference splits state across Postgres (users/conversations/messages/
attachments/KV/vectors, reference ``app/database.py:68-139``) and Redis
(task queue, locks, counters, caches — SURVEY.md section 2c). Here vectors
live on-device (``outline_rag_tpu_torch.index``); everything else sits behind
small interfaces with batteries-included backends:

- ``MetaStore``  (sqlite default) — users, conversations, messages,
  attachments, the idempotent KV cache, and the document/chunk store.
- ``Bus`` — queues, NX locks with expiry, counters, debounce timers.
  In-process asyncio implementation by default; a Redis backend gates in
  when ``redis`` is importable and REDIS_URL is set (multi-process
  deployments), preserving the reference's cross-worker semantics.
"""

from outline_rag_tpu_torch.storage.bus import InMemoryBus, make_bus
from outline_rag_tpu_torch.storage.sqlite import SqliteMetaStore

__all__ = [
    "InMemoryBus",
    "make_bus",
    "SqliteMetaStore",
    "PostgresMetaStore",
    "make_meta_store",
]


def __getattr__(name):  # lazy: pgwire only loads when a PG url is used
    if name in ("PostgresMetaStore", "make_meta_store"):
        from outline_rag_tpu_torch.storage import postgres

        return getattr(postgres, name)
    raise AttributeError(name)
