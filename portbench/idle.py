"""The device's idle stretches in a traced run's profiled sub-window, and how
much of them a set of host ranges covers (the idle readers and
``tools/port_spans.py``). Times are microseconds on the profiler's clock."""

from __future__ import annotations


def gaps(p) -> list[tuple[float, float]]:
    """The stretches of ``p``'s sub-window (a ``devtrace.Profile``) with
    nothing on the device, in order."""
    lo, hi = p.start_us, p.start_us + p.window_us
    out, end = [], lo
    for op in p.device:
        if op.start > end:
            out.append((end, min(op.start, hi)))
        end = max(end, op.end)
    if hi > end:
        out.append((end, hi))
    return [(s, e) for s, e in out if e > s]


def merge(ranges) -> list[list[float]]:
    """The union of ``(start, end)`` ranges, as disjoint ranges in order."""
    merged: list[list[float]] = []
    for s, e in sorted(ranges):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def covered(stretches, ranges) -> float:
    """The time of ``stretches`` that lies inside some of ``ranges``."""
    merged = merge(ranges)
    return sum(max(0.0, min(e, re) - max(s, rs)) for s, e in stretches for rs, re in merged)


def outside(p, ranges) -> tuple[float, float]:
    """(idle time in ``p``'s sub-window, the part of it outside every range)."""
    idle = gaps(p)
    total = sum(e - s for s, e in idle)
    return total, total - covered(idle, ranges)
