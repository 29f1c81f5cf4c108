"""95th percentile, over the chats sent in the window, of their retrieval:
from sending to the reranked chunks from ``QueryBatcher.retrieve``."""

from portbench.stats import percentile


def read(run):
    lat = [(r["retrieved"] - r["start"]) * 1e3 for r in run.in_window("chat") if "retrieved" in r]
    return percentile(lat, 95)
