"""Tracing and per-stage timing.

The reference has no tracing/profiling (SURVEY.md section 5: stdlib
logging only). Here:

- :class:`Metrics` — lightweight process-global stage timings (count/mean/
  p50/p95/max over a sliding window), fed by the engine and the chat
  pipeline, exposed at ``/chat/api/metrics``;
- :func:`trace` — context-manager wrapper over ``torch.profiler`` for
  on-demand trace capture (set ORT_TRACE_DIR or pass a path);
- stage timer decorator/context ``Metrics.timeit``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time


class Metrics:
    def __init__(self, window: int = 512):
        self._window = window
        self._samples: dict[str, collections.deque] = {}
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def record(self, stage: str, seconds: float) -> None:
        with self._lock:
            dq = self._samples.setdefault(
                stage, collections.deque(maxlen=self._window)
            )
            dq.append(seconds)
            self._counts[stage] = self._counts.get(stage, 0) + 1

    @contextlib.contextmanager
    def timeit(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(stage, time.perf_counter() - t0)

    def increment(self, counter: str, by: int = 1) -> None:
        with self._lock:
            self._counts[counter] = self._counts.get(counter, 0) + by

    def snapshot(self) -> dict:
        out: dict = {}
        with self._lock:
            for stage, dq in self._samples.items():
                if not dq:
                    continue
                xs = sorted(dq)
                n = len(xs)
                out[stage] = {
                    "count": self._counts.get(stage, n),
                    "mean_ms": round(sum(xs) / n * 1000, 3),
                    "p50_ms": round(xs[n // 2] * 1000, 3),
                    "p95_ms": round(xs[min(n - 1, int(n * 0.95))] * 1000, 3),
                    "max_ms": round(xs[-1] * 1000, 3),
                }
            for counter, v in self._counts.items():
                if counter not in out:
                    out[counter] = {"count": v}
        return out


metrics = Metrics()


@contextlib.contextmanager
def trace(path: str | None = None):
    """Capture a torch profiler trace (host and, where there is one, CUDA
    activity) into ``path`` (or ORT_TRACE_DIR) as a Chrome trace file.
    No-op when neither is set."""
    target = path or os.environ.get("ORT_TRACE_DIR")
    if not target:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(target, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(target, f"trace_{os.getpid()}_{time.time_ns()}.json"))
