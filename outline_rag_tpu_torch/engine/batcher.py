"""Continuous micro-batcher for concurrent queries.

Carried over from ``outline_rag_tpu/engine/batcher.py`` as it is:
concurrent ``retrieve`` calls arriving within a small window are coalesced
into one ``retrieve_batch`` call. asyncio-native: callers await a future; a
drainer task forms batches and dispatches each on a worker thread, with up
to ``max_in_flight`` batches executing concurrently — queries are
concurrent readers of the index (``index/store.py`` RWLock), so while one
batch runs on the device the next batch's host-side work (tokenization,
dispatch) proceeds instead of idling behind it. In-flight is bounded so a
burst can't pile up unbounded device work.
"""

from __future__ import annotations

import asyncio
from typing import Callable


class QueryBatcher:
    def __init__(
        self,
        retrieve_batch: Callable[[list[str]], list],
        window_ms: float = 4.0,
        max_batch: int = 32,
        max_in_flight: int = 2,
    ):
        self.retrieve_batch = retrieve_batch
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        self.max_in_flight = max(1, int(max_in_flight))
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: asyncio.Task | None = None
        self._inflight: set[asyncio.Task] = set()
        self._sem: asyncio.Semaphore | None = None

    async def start(self) -> None:
        if self._task is None:
            self._sem = asyncio.Semaphore(self.max_in_flight)
            self._task = asyncio.create_task(self._drain())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._inflight:
            # let dispatched batches finish (their waiters get results)
            await asyncio.gather(*self._inflight, return_exceptions=True)

    async def retrieve(self, query: str):
        if self._task is None:
            await self.start()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._queue.put((query, fut))
        return await fut

    async def _drain(self) -> None:
        assert self._sem is not None
        while True:
            query, fut = await self._queue.get()
            batch = [(query, fut)]
            # collect more work for up to window_s, bounded by max_batch
            # (with a backlog the queue yields instantly — no added wait)
            try:
                deadline = asyncio.get_running_loop().time() + self.window_s
                while len(batch) < self.max_batch:
                    timeout = deadline - asyncio.get_running_loop().time()
                    if timeout <= 0:
                        break
                    item = await asyncio.wait_for(self._queue.get(), timeout)
                    batch.append(item)
            except asyncio.TimeoutError:
                pass
            await self._sem.acquire()
            task = asyncio.create_task(self._run_batch(batch))
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)

    async def _run_batch(self, batch) -> None:
        assert self._sem is not None
        queries = [q for q, _ in batch]
        try:
            results = await asyncio.to_thread(self.retrieve_batch, queries)
            for (_, f), res in zip(batch, results):
                if not f.done():
                    f.set_result(res)
        except Exception as exc:  # fail all waiters in this batch
            for _, f in batch:
                if not f.done():
                    f.set_exception(exc)
        finally:
            self._sem.release()
