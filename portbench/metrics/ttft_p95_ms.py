"""95th percentile, over every chat sent in the window, of the time from
its sending (before its retrieval) to its first content delta; a chat that
failed or sent nothing counts at the longest wait the run allows."""

from portbench.stats import percentile


def read(run):
    limit = run.w1 + run.drain_s
    lat = [(r.get("first", limit) - r["start"]) * 1e3 for r in run.in_window("chat")]
    return percentile(lat, 95)
