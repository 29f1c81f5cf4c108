"""What several metric readers take from a run's window."""

from __future__ import annotations


def untraced(run, t0: float, t1: float) -> bool:
    """Whether ``[t0, t1]`` misses the profiler's sub-window, whose own
    cost on the host would otherwise slow what a span measures."""
    return run.traced is None or t1 < run.traced[0] or t0 > run.traced[1]


def spans(run, name: str) -> list:
    """The benchmark's spans of ``name`` that started in the window, but for
    those that overlap the profiler's sub-window."""
    if run.rec is None:
        return []
    return [s for s in run.rec.within(name, run.w0, run.w1) if untraced(run, s[0], s[1])]


def untraced_seconds(run) -> float:
    """The window's length less the profiler's sub-window."""
    cut = run.traced[1] - run.traced[0] if run.traced is not None else 0.0
    return (run.w1 - run.w0) - cut


def tokens_in_window(run) -> int:
    """Tokens of every streamed delta that arrived in the window."""
    return sum(n for r in run.records for t, n in r.get("pieces", ()) if run.w0 <= t < run.w1)


def chunks(run, kind: str) -> list:
    """``(range, span fields)`` of each ``kind`` span that lies wholly in the
    profiler's sub-window: the span placed on the profiler's clock by its own
    start and end (``devtrace.Profile.place``)."""
    if run.profile is None or run.rec is None:
        return []
    t0, t1 = run.traced
    return [(run.profile.place(kind, s0, s1), f)
            for s0, s1, f in run.rec.spans.get(kind, []) if t0 <= s0 and s1 <= t1]


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))
