"""Median, over every chat sent in the window, of the time from its sending
to its first content delta."""

from portbench.stats import percentile


def read(run):
    limit = run.w1 + run.drain_s
    lat = [(r.get("first", limit) - r["start"]) * 1e3 for r in run.in_window("chat")]
    return percentile(lat, 50)
