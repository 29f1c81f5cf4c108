"""95th percentile of a chat's admission in ``DecodeBatcher``: the port's
``decode.admit`` spans (from staging to the first token sampled: the paged
prefill chunks and the decode chunks between them) that started in the
window, but for those that overlap the profiler's sub-window. None on a port
that records no spans."""

from portbench.stats import percentile
from portbench.window import untraced


def read(run):
    from outline_rag_tpu_torch.utils import profiling

    if not hasattr(profiling.metrics, "spans"):
        return None
    got = [s for s in profiling.metrics.spans("decode.admit", run.w0) if s.t0 < run.w1]
    if not got:
        raise RuntimeError("the port recorded no decode.admit span in the window")
    return percentile([1e3 * (s.t1 - s.t0) for s in got if untraced(run, s.t0, s.t1)], 95)
