"""Coordination bus: queues, NX locks with expiry, counters, timers.

Re-implements the Redis usage patterns of the reference with the same
semantics behind one interface:

- task queue push/blocking-pop (reference ``app/main.py:40-64`` BRPOP loop)
- ``SET NX EX`` mutual-exclusion locks (``refresh:lock``
  reference ``app/blueprints/api.py:957``; ``webhook:trigger_lock``
  reference ``app/main.py:77``)
- counters for refresh progress (reference ``app/rag.py:314-324``)
- debounce timer keys (reference ``app/blueprints/api.py:1025``)
- JSON status values with TTL (reference ``app/rag.py:309-341``)

``InMemoryBus`` is the single-process default (the serve layer is one
asyncio process; queue consumers are tasks, not separate workers).
``RedisBus`` gates in for multi-process deployments.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any


class InMemoryBus:
    def __init__(self):
        self._queues: dict[str, asyncio.Queue] = {}
        self._kv: dict[str, tuple[Any, float | None]] = {}  # key -> (value, expiry)
        self._counters: dict[str, int] = {}

    def _queue(self, name: str) -> asyncio.Queue:
        if name not in self._queues:
            self._queues[name] = asyncio.Queue()
        return self._queues[name]

    # -- queue ----------------------------------------------------------
    async def push(self, queue: str, item: dict) -> None:
        await self._queue(queue).put(json.dumps(item))

    async def pop(self, queue: str, timeout: float | None = None) -> dict | None:
        try:
            if timeout is None:
                raw = await self._queue(queue).get()
            else:
                raw = await asyncio.wait_for(self._queue(queue).get(), timeout)
        except asyncio.TimeoutError:
            return None
        return json.loads(raw)

    def queue_len(self, queue: str) -> int:
        return self._queue(queue).qsize()

    # -- kv with expiry -------------------------------------------------
    def _live(self, key: str) -> bool:
        if key not in self._kv:
            return False
        _, exp = self._kv[key]
        if exp is not None and time.monotonic() > exp:
            del self._kv[key]
            return False
        return True

    async def set(self, key: str, value: Any, ex: float | None = None) -> None:
        self._kv[key] = (value, time.monotonic() + ex if ex else None)

    async def get(self, key: str) -> Any | None:
        if not self._live(key):
            return None
        return self._kv[key][0]

    async def delete(self, *keys: str) -> None:
        for key in keys:
            self._kv.pop(key, None)
            self._counters.pop(key, None)

    async def set_nx(self, key: str, value: Any, ex: float | None = None) -> bool:
        """SET key value NX [EX ex] — returns True iff the lock was taken."""
        if self._live(key):
            return False
        await self.set(key, value, ex)
        return True

    # -- counters -------------------------------------------------------
    async def incr(self, key: str, by: int = 1) -> int:
        self._counters[key] = self._counters.get(key, 0) + by
        return self._counters[key]

    async def get_counter(self, key: str) -> int:
        return self._counters.get(key, 0)

    async def set_counter(self, key: str, value: int) -> None:
        self._counters[key] = value


class RedisBus:
    """Same interface over a real Redis server, speaking the wire protocol
    through the first-party client (``storage/resp.py`` — no redis
    package dependency, mirroring ``storage/pgwire.py`` for PostgreSQL).
    Mirrors the reference's key usage so multi-process deployments keep
    cross-worker semantics."""

    def __init__(self, url: str):
        from outline_rag_tpu_torch.storage.resp import RespClient  # noqa: PLC0415

        self.r = RespClient(url)

    async def push(self, queue: str, item: dict) -> None:
        await self.r.command("LPUSH", queue, json.dumps(item))

    async def pop(self, queue: str, timeout: float | None = None) -> dict | None:
        res = await self.r.command("BRPOP", queue, timeout or 0)
        if res is None:
            return None
        return json.loads(res[1])

    async def set(self, key: str, value: Any, ex: float | None = None) -> None:
        args = ["SET", key, json.dumps(value)]
        if ex:
            args += ["EX", max(int(ex), 1)]
        await self.r.command(*args)

    async def get(self, key: str) -> Any | None:
        raw = await self.r.command("GET", key)
        return None if raw is None else json.loads(raw)

    async def delete(self, *keys: str) -> None:
        if keys:
            await self.r.command("DEL", *keys)

    async def set_nx(self, key: str, value: Any, ex: float | None = None) -> bool:
        args = ["SET", key, json.dumps(value), "NX"]
        if ex:
            args += ["EX", max(int(ex), 1)]
        return (await self.r.command(*args)) is not None

    async def incr(self, key: str, by: int = 1) -> int:
        return await self.r.command("INCRBY", key, by)

    async def get_counter(self, key: str) -> int:
        raw = await self.r.command("GET", key)
        return int(raw) if raw else 0

    async def set_counter(self, key: str, value: int) -> None:
        await self.r.command("SET", key, value)


def make_bus(redis_url: str = ""):
    if redis_url:
        try:
            # RespClient dials lazily, so probe reachability NOW — the
            # documented in-memory fallback must trigger at startup, not
            # surface ConnectionErrors on every later request
            import socket
            import urllib.parse

            u = urllib.parse.urlparse(redis_url)
            s = socket.create_connection(
                (u.hostname or "127.0.0.1", u.port or 6379), timeout=2.0
            )
            s.close()
            return RedisBus(redis_url)
        except Exception:
            import logging

            logging.getLogger(__name__).warning(
                "redis unavailable; falling back to in-memory bus"
            )
    return InMemoryBus()
