"""Share of the device's idle time in the profiler's sub-window during which
no retrieval batch was open: idle stretches (nothing on the device) less the
port's ``batcher.batch`` spans of every worker thread, placed on the
profiler's clock (``devtrace.Profile.place``), over all idle time. None
without a card or a profile, or on a port that records no spans."""

from portbench.idle import outside


def read(run):
    from outline_rag_tpu_torch.utils import profiling

    p = run.profile
    if p is None or run.device.type != "cuda" or not hasattr(profiling.metrics, "spans"):
        return None
    t0, t1 = run.traced
    cover = [p.place(s.name, s.t0, s.t1) for s in profiling.metrics.spans("batcher.batch", run.w0)
             if s.t1 >= t0 and s.t0 <= t1]
    if not cover:
        raise RuntimeError("no batcher.batch span overlaps the profiler's sub-window")
    idle, out = outside(p, [(r.start, r.end) for r in cover])
    return 100.0 * out / idle if idle > 0 else 0.0
