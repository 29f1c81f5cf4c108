"""Median time an ask waits in ``QueryBatcher``: the port's ``batcher.wait``
spans (from ``QueryBatcher.retrieve`` to the start of the ask's batch on a
worker thread: the batch window, the wait for an in-flight slot, the hand-off)
that started in the window, but for those that overlap the profiler's
sub-window. None on a port that records no spans."""

from portbench.stats import percentile
from portbench.window import untraced


def read(run):
    from outline_rag_tpu_torch.utils import profiling

    if not hasattr(profiling.metrics, "spans"):
        return None
    got = [s for s in profiling.metrics.spans("batcher.wait", run.w0) if s.t0 < run.w1]
    if not got:
        raise RuntimeError("the port recorded no batcher.wait span in the window")
    return percentile([1e3 * (s.t1 - s.t0) for s in got if untraced(run, s.t0, s.t1)], 50)
