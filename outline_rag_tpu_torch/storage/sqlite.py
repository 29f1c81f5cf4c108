"""SQLite metadata store.

Covers the reference's Postgres schema (users / conversations / messages /
attachments / KV store, reference ``app/database.py:68-113``) plus the
document+chunk store that replaces both the pickled parent-doc KV
(reference ``app/rag.py:53-64``) and the non-vector columns of
``langchain_pg_embedding`` (reference ``app/database.py:118-131``).
Vectors themselves live on-device (``outline_rag_tpu_torch.index``).

Sync sqlite3 under one lock; the serve layer calls through
``asyncio.to_thread``. A Postgres backend can implement the same surface
for multi-process deployments (the interface is this class's public
methods).
"""

from __future__ import annotations

import datetime as dt
import os
import sqlite3
import threading
from typing import Iterable


def _now() -> str:
    return dt.datetime.now(dt.timezone.utc).isoformat()


_SCHEMA = """
CREATE TABLE IF NOT EXISTS users (
  id TEXT PRIMARY KEY, name TEXT, email TEXT, created_at TEXT
);
CREATE TABLE IF NOT EXISTS conversations (
  id TEXT PRIMARY KEY, user_id TEXT NOT NULL, title TEXT,
  created_at TEXT, updated_at TEXT
);
CREATE INDEX IF NOT EXISTS ix_conv_user ON conversations(user_id, updated_at);
CREATE TABLE IF NOT EXISTS messages (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  conversation_id TEXT NOT NULL, role TEXT NOT NULL, content TEXT,
  model TEXT, created_at TEXT
);
CREATE INDEX IF NOT EXISTS ix_msg_conv ON messages(conversation_id, id);
CREATE TABLE IF NOT EXISTS attachments (
  id TEXT PRIMARY KEY, user_id TEXT, filename TEXT, content TEXT,
  created_at TEXT
);
CREATE TABLE IF NOT EXISTS kv_store (
  namespace TEXT NOT NULL, key TEXT NOT NULL, value BLOB,
  PRIMARY KEY (namespace, key)
);
CREATE TABLE IF NOT EXISTS documents (
  source_id TEXT PRIMARY KEY, title TEXT, url TEXT,
  updated_at TEXT, text TEXT
);
CREATE TABLE IF NOT EXISTS chunks (
  chunk_id TEXT PRIMARY KEY, source_id TEXT NOT NULL,
  seq INTEGER, body TEXT, start INTEGER
);
CREATE INDEX IF NOT EXISTS ix_chunks_source ON chunks(source_id, seq);
"""


class SqliteMetaStore:
    def __init__(self, path: str = ":memory:"):
        if path != ":memory:":
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._lock = threading.RLock()
        with self._lock, self._conn:
            self._conn.executescript(_SCHEMA)

    def close(self) -> None:
        self._conn.close()

    # -- users ----------------------------------------------------------

    def upsert_user(self, user_id: str, name: str, email: str = "") -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO users (id, name, email, created_at) VALUES (?,?,?,?) "
                "ON CONFLICT(id) DO UPDATE SET name=excluded.name, email=excluded.email",
                (user_id, name, email, _now()),
            )

    def get_user(self, user_id: str) -> dict | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM users WHERE id=?", (user_id,)
            ).fetchone()
        return dict(row) if row else None

    # -- conversations --------------------------------------------------

    def create_conversation(self, conv_id: str, user_id: str, title: str) -> dict:
        now = _now()
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO conversations (id, user_id, title, created_at, updated_at)"
                " VALUES (?,?,?,?,?)",
                (conv_id, user_id, title, now, now),
            )
        return {
            "id": conv_id,
            "user_id": user_id,
            "title": title,
            "created_at": now,
            "updated_at": now,
        }

    def list_conversations(
        self, user_id: str, limit: int = 100, offset: int = 0
    ) -> list[dict]:
        limit = min(limit, 100)  # page cap, reference api.py:198-220
        with self._lock:
            rows = self._conn.execute(
                "SELECT * FROM conversations WHERE user_id=? "
                "ORDER BY updated_at DESC LIMIT ? OFFSET ?",
                (user_id, limit, offset),
            ).fetchall()
        return [dict(r) for r in rows]

    def get_conversation(self, conv_id: str) -> dict | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM conversations WHERE id=?", (conv_id,)
            ).fetchone()
        return dict(row) if row else None

    def rename_conversation(self, conv_id: str, user_id: str, title: str) -> bool:
        """Ownership-scoped UPDATE; False when not owner / missing
        (reference returns 403 on rowcount 0, api.py:198-305)."""
        with self._lock, self._conn:
            cur = self._conn.execute(
                "UPDATE conversations SET title=?, updated_at=? WHERE id=? AND user_id=?",
                (title, _now(), conv_id, user_id),
            )
        return cur.rowcount > 0

    def touch_conversation(self, conv_id: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE conversations SET updated_at=? WHERE id=?", (_now(), conv_id)
            )

    def delete_conversation(self, conv_id: str, user_id: str) -> bool:
        with self._lock, self._conn:
            cur = self._conn.execute(
                "DELETE FROM conversations WHERE id=? AND user_id=?",
                (conv_id, user_id),
            )
            if cur.rowcount:
                self._conn.execute(
                    "DELETE FROM messages WHERE conversation_id=?", (conv_id,)
                )
        return cur.rowcount > 0

    # -- messages -------------------------------------------------------

    def add_message(
        self, conv_id: str, role: str, content: str, model: str | None = None
    ) -> int:
        with self._lock, self._conn:
            cur = self._conn.execute(
                "INSERT INTO messages (conversation_id, role, content, model, created_at)"
                " VALUES (?,?,?,?,?)",
                (conv_id, role, content, model, _now()),
            )
        return int(cur.lastrowid)

    def list_messages(self, conv_id: str) -> list[dict]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT * FROM messages WHERE conversation_id=? ORDER BY id",
                (conv_id,),
            ).fetchall()
        return [dict(r) for r in rows]

    def delete_messages_after(self, conv_id: str, message_id: int) -> int:
        """Edit-branch truncation: drop every message with id > message_id
        (reference api.py:626-629)."""
        with self._lock, self._conn:
            cur = self._conn.execute(
                "DELETE FROM messages WHERE conversation_id=? AND id>?",
                (conv_id, message_id),
            )
        return cur.rowcount

    # -- attachments ----------------------------------------------------

    def add_attachment(
        self, att_id: str, user_id: str, filename: str, content: str
    ) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO attachments (id, user_id, filename, content, created_at)"
                " VALUES (?,?,?,?,?)",
                (att_id, user_id, filename, content, _now()),
            )

    def get_attachment(self, att_id: str) -> dict | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM attachments WHERE id=?", (att_id,)
            ).fetchone()
        return dict(row) if row else None

    # -- idempotent KV (embedding cache etc.) ---------------------------

    def kv_mset(self, namespace: str, items: Iterable[tuple[str, bytes]]) -> None:
        """INSERT OR IGNORE — concurrent-writer-safe idempotent upsert,
        the semantics of the reference's IdempotentSQLStore
        (``app/llm_services.py:55-87``)."""
        with self._lock, self._conn:
            self._conn.executemany(
                "INSERT OR IGNORE INTO kv_store (namespace, key, value) VALUES (?,?,?)",
                [(namespace, k, v) for k, v in items],
            )

    def kv_mget(self, namespace: str, keys: list[str]) -> list[bytes | None]:
        with self._lock:
            out = []
            for k in keys:
                row = self._conn.execute(
                    "SELECT value FROM kv_store WHERE namespace=? AND key=?",
                    (namespace, k),
                ).fetchone()
                out.append(row["value"] if row else None)
        return out

    def kv_mdelete(self, namespace: str, keys: list[str]) -> None:
        with self._lock, self._conn:
            self._conn.executemany(
                "DELETE FROM kv_store WHERE namespace=? AND key=?",
                [(namespace, k) for k in keys],
            )

    # -- documents / chunks ---------------------------------------------

    def upsert_document(
        self, source_id: str, title: str, url: str, updated_at: str, text: str
    ) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO documents (source_id, title, url, updated_at, text)"
                " VALUES (?,?,?,?,?) ON CONFLICT(source_id) DO UPDATE SET"
                " title=excluded.title, url=excluded.url,"
                " updated_at=excluded.updated_at, text=excluded.text",
                (source_id, title, url, updated_at, text),
            )

    def get_document(self, source_id: str) -> dict | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM documents WHERE source_id=?", (source_id,)
            ).fetchone()
        return dict(row) if row else None

    def delete_document(self, source_id: str) -> None:
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM documents WHERE source_id=?", (source_id,))
            self._conn.execute("DELETE FROM chunks WHERE source_id=?", (source_id,))

    def local_doc_versions(self) -> dict[str, str]:
        """{source_id: updated_at} — the local side of the delta diff
        (reference ``app/rag.py:277-287``)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT source_id, updated_at FROM documents"
            ).fetchall()
        return {r["source_id"]: r["updated_at"] for r in rows}

    def replace_chunks(
        self, source_id: str, chunks: list[tuple[str, int, str, int]]
    ) -> None:
        """chunks: [(chunk_id, seq, body, start)]"""
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM chunks WHERE source_id=?", (source_id,))
            self._conn.executemany(
                "INSERT OR REPLACE INTO chunks (chunk_id, source_id, seq, body, start)"
                " VALUES (?,?,?,?,?)",
                [(cid, source_id, seq, body, start) for cid, seq, body, start in chunks],
            )

    def get_chunk(self, chunk_id: str) -> dict | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM chunks WHERE chunk_id=?", (chunk_id,)
            ).fetchone()
        return dict(row) if row else None

    def chunks_of(self, source_id: str) -> list[dict]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT * FROM chunks WHERE source_id=? ORDER BY seq", (source_id,)
            ).fetchall()
        return [dict(r) for r in rows]

    def doc_count(self) -> int:
        with self._lock:
            return self._conn.execute("SELECT COUNT(*) c FROM documents").fetchone()["c"]

    def chunk_count(self) -> int:
        with self._lock:
            return self._conn.execute("SELECT COUNT(*) c FROM chunks").fetchone()["c"]
