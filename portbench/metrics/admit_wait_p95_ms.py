"""95th percentile of a chat's wait in ``DecodeBatcher``'s queue: the port's
``decode.queue`` spans (from ``submit`` until the worker stages the request's
admission, held and backpressured time included) that started in the window,
but for those that overlap the profiler's sub-window. None on a port that
records no spans."""

from portbench.stats import percentile
from portbench.window import untraced


def read(run):
    from outline_rag_tpu_torch.utils import profiling

    if not hasattr(profiling.metrics, "spans"):
        return None
    got = [s for s in profiling.metrics.spans("decode.queue", run.w0) if s.t0 < run.w1]
    if not got:
        raise RuntimeError("the port recorded no decode.queue span in the window")
    return percentile([1e3 * (s.t1 - s.t0) for s in got if untraced(run, s.t0, s.t1)], 95)
