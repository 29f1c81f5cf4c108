"""First-party asyncio Redis (RESP2) client.

The reference depends on ``redis[hiredis]`` (reference
``requirements.txt``; usage ``app/database.py:41-57``); this environment
ships no redis package at all, and the bus only needs six commands — so
the wire protocol is implemented directly, the same first-party approach
as ``storage/pgwire.py`` for PostgreSQL.

Connection handling: a small pool. Blocking commands (BRPOP) hold their
connection for the full wait, so each command checks out a free
connection (or dials a new one up to ``max_connections``) and returns it
afterwards — concurrent BRPOP + SET/GET never serialize behind each
other. Tested against a protocol-speaking fake server
(tests/fake_redis.py) the same way pgwire is tested against
tests/fake_postgres.py.
"""

from __future__ import annotations

import asyncio
import urllib.parse


class RespError(Exception):
    pass


class _Conn:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    @classmethod
    async def dial(
        cls, host: str, port: int, db: int = 0, password: str | None = None
    ) -> "_Conn":
        reader, writer = await asyncio.open_connection(host, port)
        conn = cls(reader, writer)
        if password:
            await conn.command("AUTH", password)
        if db:
            await conn.command("SELECT", str(db))
        return conn

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass

    async def command(self, *parts: str | bytes | int | float):
        out = [b"*" + str(len(parts)).encode() + b"\r\n"]
        for p in parts:
            if isinstance(p, bytes):
                b = p
            else:
                b = str(p).encode()
            out.append(b"$" + str(len(b)).encode() + b"\r\n" + b + b"\r\n")
        self.writer.write(b"".join(out))
        await self.writer.drain()
        return await self._read_reply()

    async def _read_reply(self):
        line = await self.reader.readline()
        if not line:
            raise ConnectionError("redis connection closed")
        kind, rest = line[:1], line[1:].strip()
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = await self.reader.readexactly(n + 2)
            return data[:-2]
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [await self._read_reply() for _ in range(n)]
        raise RespError(f"unexpected reply type {kind!r}")


class RespClient:
    """Pooled command interface. ``url``: redis://[:password@]host:port/db"""

    def __init__(self, url: str, max_connections: int = 8):
        u = urllib.parse.urlparse(url)
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 6379
        self.db = int((u.path or "/0").lstrip("/") or 0)
        # percent-decode: redis://:p%40ss@host must AUTH with "p@ss"
        # (same convention pgwire.parse_dsn applies to DATABASE_URL)
        self.password = (
            urllib.parse.unquote(u.password) if u.password else u.password
        )
        self.max_connections = max_connections
        self._free: list[_Conn] = []
        self._count = 0
        self._waiter = asyncio.Condition()

    async def _checkout(self) -> _Conn:
        async with self._waiter:
            while True:
                if self._free:
                    return self._free.pop()
                if self._count < self.max_connections:
                    self._count += 1
                    break
                await self._waiter.wait()
        try:
            return await _Conn.dial(self.host, self.port, self.db, self.password)
        except Exception:
            async with self._waiter:
                self._count -= 1
                self._waiter.notify()
            raise

    async def _checkin(self, conn: _Conn, broken: bool = False) -> None:
        async with self._waiter:
            if broken:
                conn.close()
                self._count -= 1
            else:
                self._free.append(conn)
            self._waiter.notify()

    async def command(self, *parts):
        # One transparent retry on a fresh connection: a pooled socket the
        # server closed while idle (redis `timeout` config is common in
        # managed deployments) surfaces ConnectionError/EOF on first use —
        # redis-py redials; so do we. No retry on the second attempt, and
        # never for RespError (-ERR replies arrive on a healthy wire).
        for attempt in (0, 1):
            conn = await self._checkout()
            # the finally must run even on CancelledError (a consumer
            # wrapping a blocking BRPOP in wait_for is routine): a
            # cancelled command leaves a pending reply on the wire, so
            # the connection cannot be pooled — close it and free the
            # slot, or the pool leaks dry. A RespError (-ERR reply) is
            # fully consumed: the conn stays good.
            broken = True
            try:
                reply = await conn.command(*parts)
                broken = False
                return reply
            except RespError:
                broken = False
                raise
            except (ConnectionError, OSError):
                if attempt == 1:
                    raise
            finally:
                await asyncio.shield(self._checkin(conn, broken=broken))

    async def aclose(self) -> None:
        async with self._waiter:
            for c in self._free:
                c.close()
            self._count -= len(self._free)
            self._free.clear()
            self._waiter.notify_all()
