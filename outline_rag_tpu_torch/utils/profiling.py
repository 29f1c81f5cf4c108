"""Stage timings and spans of the port.

- :class:`Metrics` — process-wide stage timings (count, mean, p50, p95 and
  max over a sliding window of samples), exposed at ``/chat/api/metrics``;
- spans (:meth:`Metrics.span`, :meth:`Metrics.add`): a named stretch of host
  time with its parent span, the request it serves, its fields and its
  thread, kept in an in-memory ring (:meth:`Metrics.spans` reads it back).
  A closing span also feeds its stage timing, so ``timeit`` is a span with
  no fields;
- request ids (:func:`request`): one id carried across the spans of a
  request, from the route that starts it to the shared workers that serve
  it. A shared worker thread or task never inherits a caller's id: entry
  points take the caller's (:func:`current_request`) and hand it on.

Times are ``time.perf_counter`` seconds, on the host: a span takes no CUDA
event and waits for no device work.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import threading
import time

RING = 65_536  # spans kept

_open: contextvars.ContextVar[int | None] = contextvars.ContextVar("ort_span", default=None)
_request: contextvars.ContextVar[int | None] = contextvars.ContextVar("ort_request", default=None)
_request_ids = itertools.count(1)  # next() is atomic


def new_request_id() -> int:
    return next(_request_ids)


def current_request() -> int | None:
    """The request id set for this thread or task, if any."""
    return _request.get()


@contextlib.contextmanager
def request(rid: int | None = None):
    """Set ``rid`` (a new id by default) as the request id of this block."""
    rid = new_request_id() if rid is None else rid
    token = _request.set(rid)
    try:
        yield rid
    finally:
        _request.reset(token)


class Span:
    """One span: ``name``, ``t0`` / ``t1``, its ``id``, its ``parent``'s id,
    the request id ``rid``, ``fields`` and the ``thread`` it closed on."""

    __slots__ = ("name", "t0", "t1", "id", "parent", "rid", "fields", "thread")

    def __init__(self, name, sid, parent, rid, fields):
        self.name, self.id, self.parent, self.rid, self.fields = name, sid, parent, rid, fields
        self.t0 = self.t1 = self.thread = None


class _Open:
    """The context manager of :meth:`Metrics.span`; yields the span."""

    __slots__ = ("metrics", "span", "token")

    def __init__(self, metrics, span):
        self.metrics, self.span = metrics, span

    def __enter__(self) -> Span:
        s = self.span
        self.token = _open.set(s.id)
        s.t0 = time.perf_counter()
        return s

    def __exit__(self, *exc) -> bool:
        s = self.span
        s.t1 = time.perf_counter()
        _open.reset(self.token)
        self.metrics._close(s)
        return False


class Metrics:
    def __init__(self, window: int = 512):
        self._window = window
        self._samples: dict[str, collections.deque] = {}
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque()  # spans, as they closed
        self._capacity = RING
        self._dropped = 0  # spans evicted from the ring
        self._lost_t0 = float("-inf")  # the latest start among them
        self._ids = itertools.count(1)

    # -- stage timings ----------------------------------------------------

    def record(self, stage: str, seconds: float) -> None:
        with self._lock:
            dq = self._samples.setdefault(
                stage, collections.deque(maxlen=self._window)
            )
            dq.append(seconds)
            self._counts[stage] = self._counts.get(stage, 0) + 1

    def timeit(self, stage: str) -> _Open:
        """A span of ``stage`` with no fields (its time feeds the stage)."""
        return self.span(stage)

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
        return out

    # -- spans --------------------------------------------------------------

    def new_span_id(self) -> int:
        """An id for a span recorded later by :meth:`add` (its children
        can name it as their parent before it closes)."""
        return next(self._ids)

    def span(self, name: str, rid: int | None = None, parent: int | None = None,
             **fields) -> _Open:
        """A context manager timing its block as span ``name``. Its parent is
        ``parent``, by default the innermost span open in this thread or task;
        its request id ``rid``, by default the one set there."""
        s = Span(name, next(self._ids), _open.get() if parent is None else parent,
                 _request.get() if rid is None else rid, fields)
        return _Open(self, s)

    def add(self, name: str, t0: float, t1: float, rid: int | None = None,
            parent: int | None = None, sid: int | None = None, **fields) -> Span:
        """Record a span whose ends were taken elsewhere (a wait that starts
        on one thread and ends on another); ``sid`` from :meth:`new_span_id`."""
        s = Span(name, self.new_span_id() if sid is None else sid, parent, rid, fields)
        s.t0, s.t1 = t0, t1
        self._close(s)
        return s

    def _close(self, s: Span) -> None:
        s.thread = threading.get_ident()
        ring = self._ring
        ring.append(s)
        if len(ring) > self._capacity:
            with self._lock:
                while len(ring) > self._capacity:
                    old = ring.popleft()
                    self._dropped += 1
                    if old.t0 > self._lost_t0:
                        self._lost_t0 = old.t0
        self.record(s.name, s.t1 - s.t0)

    @property
    def recorded(self) -> int:
        """Spans recorded since the process started."""
        return self._dropped + len(self._ring)

    def spans(self, name: str, since: float = float("-inf")) -> list[Span]:
        """The spans of ``name`` that started at or after ``since``, in the
        order they closed. Raises if the ring dropped one of them."""
        held = list(self._ring)
        if self._dropped and self._lost_t0 >= since:
            raise RuntimeError(
                f"the span ring dropped spans that started at or after {since}: "
                f"read them within {self._capacity} spans of their closing"
            )
        return [s for s in held if s.name == name and s.t0 >= since]


metrics = Metrics()
