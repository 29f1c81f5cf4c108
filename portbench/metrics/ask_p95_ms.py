"""95th percentile, over every ask due in the window, of the time from when
it was due to its reranked chunks on the host; an ask that failed or never
came back counts at the longest wait the run allows."""

from portbench.stats import percentile


def read(run):
    asks = run.in_window("ask")
    limit = run.w1 + run.drain_s
    lat = [((r["done"] if r.get("result") is not None else limit) - r["start"]) * 1e3
           for r in asks]
    return percentile(lat, 95)
