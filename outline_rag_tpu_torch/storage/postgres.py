"""Postgres metadata store — same public surface as ``SqliteMetaStore``.

For multi-process deployments (N serving workers sharing state, the
reference's topology: ``entrypoint.sh:16`` runs 2 uvicorn workers against
one Postgres). Speaks the wire protocol directly via
``storage/pgwire.py`` — no psycopg/SQLAlchemy.

Schema parity notes vs the reference (``app/database.py:68-113``):
users/conversations/messages/attachments/kv match; documents/chunks are
the non-vector columns of ``langchain_pg_embedding``
(``app/database.py:118-131``) — vectors live on-device. DDL runs under
``pg_advisory_lock(9876543210)`` exactly like the reference's
``db_init()`` (``app/database.py:142-182``) so N workers can race at
startup safely.
"""

from __future__ import annotations

import datetime as dt
import threading
from typing import Iterable

from outline_rag_tpu_torch.storage.pgwire import PgConnection, PgError


def _now() -> str:
    return dt.datetime.now(dt.timezone.utc).isoformat()


_ADVISORY_LOCK = 9876543210  # reference app/database.py:146

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
  id BIGSERIAL PRIMARY KEY,
  conversation_id TEXT NOT NULL, role TEXT NOT NULL, content TEXT,
  model TEXT, created_at TEXT
);
CREATE INDEX IF NOT EXISTS ix_msg_conv ON messages(conversation_id, id);
CREATE TABLE IF NOT EXISTS attachments (
  id TEXT PRIMARY KEY, user_id TEXT, filename TEXT, content TEXT,
  created_at TEXT
);
CREATE TABLE IF NOT EXISTS kv_store (
  namespace TEXT NOT NULL, key TEXT NOT NULL, value BYTEA,
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
CREATE INDEX IF NOT EXISTS ix_chunks_source ON chunks(source_id, seq)
"""

_USER_COLS = ("id", "name", "email", "created_at")
_CONV_COLS = ("id", "user_id", "title", "created_at", "updated_at")
_MSG_COLS = ("id", "conversation_id", "role", "content", "model", "created_at")
_ATT_COLS = ("id", "user_id", "filename", "content", "created_at")
_DOC_COLS = ("source_id", "title", "url", "updated_at", "text")
_CHUNK_COLS = ("chunk_id", "source_id", "seq", "body", "start")


def _row(cols, values) -> dict:
    return dict(zip(cols, values))


class PostgresMetaStore:
    """Drop-in ``SqliteMetaStore`` replacement backed by Postgres."""

    def __init__(self, url: str):
        self._url = url
        self._conn = PgConnection.from_url(url)
        self._lock = threading.RLock()
        self._init_schema()

    def _init_schema(self) -> None:
        with self._lock:
            self._conn.query(f"SELECT pg_advisory_lock({_ADVISORY_LOCK})")
            try:
                self._conn.execute_script(_SCHEMA)
            finally:
                self._conn.query(f"SELECT pg_advisory_unlock({_ADVISORY_LOCK})")

    def _q(self, sql: str, params: tuple = ()):
        with self._lock:
            if getattr(self._conn, "broken", False):
                # one transparent redial: a poisoned connection (timeout
                # or EOF mid-reply) must never serve another query
                self._conn = PgConnection.from_url(self._url)
            return self._conn.query(sql, params)

    def _tx(self):
        """BEGIN/COMMIT (ROLLBACK on error) around multi-statement
        mutations — parity with the sqlite backend's `with self._conn:`
        atomicity."""
        import contextlib

        @contextlib.contextmanager
        def tx():
            with self._lock:
                self._q("BEGIN")
                try:
                    yield
                except BaseException:
                    try:
                        self._q("ROLLBACK")
                    except Exception:
                        pass
                    raise
                self._q("COMMIT")

        return tx()

    def close(self) -> None:
        self._conn.close()

    # -- users ----------------------------------------------------------

    def upsert_user(self, user_id: str, name: str, email: str = "") -> None:
        self._q(
            "INSERT INTO users (id, name, email, created_at) VALUES ($1,$2,$3,$4)"
            " ON CONFLICT (id) DO UPDATE SET name=excluded.name, email=excluded.email",
            (user_id, name, email, _now()),
        )

    def get_user(self, user_id: str) -> dict | None:
        rows, _, _ = self._q(
            "SELECT id, name, email, created_at FROM users WHERE id=$1", (user_id,)
        )
        return _row(_USER_COLS, rows[0]) if rows else None

    # -- conversations --------------------------------------------------

    def create_conversation(self, conv_id: str, user_id: str, title: str) -> dict:
        now = _now()
        self._q(
            "INSERT INTO conversations (id, user_id, title, created_at, updated_at)"
            " VALUES ($1,$2,$3,$4,$5)",
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
        rows, _, _ = self._q(
            "SELECT id, user_id, title, created_at, updated_at FROM conversations"
            " WHERE user_id=$1 ORDER BY updated_at DESC LIMIT $2 OFFSET $3",
            (user_id, limit, offset),
        )
        return [_row(_CONV_COLS, r) for r in rows]

    def get_conversation(self, conv_id: str) -> dict | None:
        rows, _, _ = self._q(
            "SELECT id, user_id, title, created_at, updated_at FROM conversations"
            " WHERE id=$1",
            (conv_id,),
        )
        return _row(_CONV_COLS, rows[0]) if rows else None

    def rename_conversation(self, conv_id: str, user_id: str, title: str) -> bool:
        _, count, _ = self._q(
            "UPDATE conversations SET title=$1, updated_at=$2"
            " WHERE id=$3 AND user_id=$4",
            (title, _now(), conv_id, user_id),
        )
        return count > 0

    def touch_conversation(self, conv_id: str) -> None:
        self._q(
            "UPDATE conversations SET updated_at=$1 WHERE id=$2", (_now(), conv_id)
        )

    def delete_conversation(self, conv_id: str, user_id: str) -> bool:
        with self._tx():
            _, count, _ = self._q(
                "DELETE FROM conversations WHERE id=$1 AND user_id=$2",
                (conv_id, user_id),
            )
            if count:
                self._q(
                    "DELETE FROM messages WHERE conversation_id=$1", (conv_id,)
                )
        return count > 0

    # -- messages -------------------------------------------------------

    def add_message(
        self, conv_id: str, role: str, content: str, model: str | None = None
    ) -> int:
        rows, _, _ = self._q(
            "INSERT INTO messages (conversation_id, role, content, model, created_at)"
            " VALUES ($1,$2,$3,$4,$5) RETURNING id",
            (conv_id, role, content, model, _now()),
        )
        return int(rows[0][0])

    def list_messages(self, conv_id: str) -> list[dict]:
        rows, _, _ = self._q(
            "SELECT id, conversation_id, role, content, model, created_at"
            " FROM messages WHERE conversation_id=$1 ORDER BY id",
            (conv_id,),
        )
        return [_row(_MSG_COLS, r) for r in rows]

    def delete_messages_after(self, conv_id: str, message_id: int) -> int:
        _, count, _ = self._q(
            "DELETE FROM messages WHERE conversation_id=$1 AND id>$2",
            (conv_id, message_id),
        )
        return count

    # -- attachments ----------------------------------------------------

    def add_attachment(
        self, att_id: str, user_id: str, filename: str, content: str
    ) -> None:
        self._q(
            "INSERT INTO attachments (id, user_id, filename, content, created_at)"
            " VALUES ($1,$2,$3,$4,$5)",
            (att_id, user_id, filename, content, _now()),
        )

    def get_attachment(self, att_id: str) -> dict | None:
        rows, _, _ = self._q(
            "SELECT id, user_id, filename, content, created_at FROM attachments"
            " WHERE id=$1",
            (att_id,),
        )
        return _row(_ATT_COLS, rows[0]) if rows else None

    # -- idempotent KV (embedding cache etc.) ---------------------------

    @staticmethod
    def _text_array(keys: list[str]) -> str:
        """Postgres text-format array literal (quoted, escaped)."""
        quoted = [
            '"' + k.replace("\\", "\\\\").replace('"', '\\"') + '"'
            for k in keys
        ]
        return "{" + ",".join(quoted) + "}"

    def kv_mset(self, namespace: str, items: Iterable[tuple[str, bytes]]) -> None:
        """ON CONFLICT DO NOTHING — the reference IdempotentSQLStore
        semantics (``app/llm_services.py:55-87``). One multi-row INSERT:
        an ingest batch caching N embeddings must not pay N round trips
        serialized behind the connection lock."""
        items = list(items)
        if not items:
            return
        values = []
        params: list = []
        for i, (k, v) in enumerate(items):
            base = 2 + i * 2
            values.append(f"($1,${base},${base + 1})")
            params.extend((k, v))
        self._q(
            "INSERT INTO kv_store (namespace, key, value) VALUES "
            + ",".join(values)
            + " ON CONFLICT (namespace, key) DO NOTHING",
            (namespace, *params),
        )

    def kv_mget(self, namespace: str, keys: list[str]) -> list[bytes | None]:
        if not keys:
            return []
        rows, _, _ = self._q(
            "SELECT key, value FROM kv_store WHERE namespace=$1"
            " AND key = ANY($2::text[])",
            (namespace, self._text_array(keys)),
        )
        got = {k: v for k, v in rows}
        return [got.get(k) for k in keys]

    def kv_mdelete(self, namespace: str, keys: list[str]) -> None:
        if not keys:
            return
        self._q(
            "DELETE FROM kv_store WHERE namespace=$1 AND key = ANY($2::text[])",
            (namespace, self._text_array(keys)),
        )

    # -- documents / chunks ---------------------------------------------

    def upsert_document(
        self, source_id: str, title: str, url: str, updated_at: str, text: str
    ) -> None:
        self._q(
            "INSERT INTO documents (source_id, title, url, updated_at, text)"
            " VALUES ($1,$2,$3,$4,$5) ON CONFLICT (source_id) DO UPDATE SET"
            " title=excluded.title, url=excluded.url,"
            " updated_at=excluded.updated_at, text=excluded.text",
            (source_id, title, url, updated_at, text),
        )

    def get_document(self, source_id: str) -> dict | None:
        rows, _, _ = self._q(
            "SELECT source_id, title, url, updated_at, text FROM documents"
            " WHERE source_id=$1",
            (source_id,),
        )
        return _row(_DOC_COLS, rows[0]) if rows else None

    def delete_document(self, source_id: str) -> None:
        self._q("DELETE FROM documents WHERE source_id=$1", (source_id,))
        self._q("DELETE FROM chunks WHERE source_id=$1", (source_id,))

    def local_doc_versions(self) -> dict[str, str]:
        rows, _, _ = self._q("SELECT source_id, updated_at FROM documents")
        return {r[0]: r[1] for r in rows}

    def replace_chunks(
        self, source_id: str, chunks: list[tuple[str, int, str, int]]
    ) -> None:
        with self._tx():
            self._q("DELETE FROM chunks WHERE source_id=$1", (source_id,))
            for cid, seq, body, start in chunks:
                self._q(
                    "INSERT INTO chunks (chunk_id, source_id, seq, body, start)"
                    " VALUES ($1,$2,$3,$4,$5) ON CONFLICT (chunk_id) DO UPDATE SET"
                    " source_id=excluded.source_id, seq=excluded.seq,"
                    " body=excluded.body, start=excluded.start",
                    (cid, source_id, seq, body, start),
                )

    def get_chunk(self, chunk_id: str) -> dict | None:
        rows, _, _ = self._q(
            "SELECT chunk_id, source_id, seq, body, start FROM chunks"
            " WHERE chunk_id=$1",
            (chunk_id,),
        )
        return _row(_CHUNK_COLS, rows[0]) if rows else None

    def chunks_of(self, source_id: str) -> list[dict]:
        rows, _, _ = self._q(
            "SELECT chunk_id, source_id, seq, body, start FROM chunks"
            " WHERE source_id=$1 ORDER BY seq",
            (source_id,),
        )
        return [_row(_CHUNK_COLS, r) for r in rows]

    def doc_count(self) -> int:
        rows, _, _ = self._q("SELECT COUNT(*) FROM documents")
        return int(rows[0][0])

    def chunk_count(self) -> int:
        rows, _, _ = self._q("SELECT COUNT(*) FROM chunks")
        return int(rows[0][0])


def make_meta_store(settings):
    """DATABASE_URL=postgres://... -> PostgresMetaStore; else sqlite."""
    import os

    url = getattr(settings, "database_url", "") or ""
    if url.startswith(("postgres://", "postgresql://")):
        return PostgresMetaStore(url)
    db_path = (
        ":memory:"
        if not url and not settings.data_dir
        else os.path.join(settings.data_dir, "meta.sqlite3")
    )
    from outline_rag_tpu_torch.storage.sqlite import SqliteMetaStore

    return SqliteMetaStore(db_path)
