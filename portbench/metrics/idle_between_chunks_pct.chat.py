"""Share of the device's idle time in the profiler's sub-window that lies
outside the decode worker's chunks: idle stretches (nothing on the device)
less the port's ``decode.launch`` and ``decode.prefill`` spans, placed on the
profiler's clock (``devtrace.Profile.place``), over all idle time: the
worker's scheduling, fetches and emits, and its waits. None without a card
or a profile, or on a port that records no spans."""

from portbench.idle import outside


def read(run):
    from outline_rag_tpu_torch.utils import profiling

    p = run.profile
    if p is None or run.device.type != "cuda" or not hasattr(profiling.metrics, "spans"):
        return None
    t0, t1 = run.traced
    cover = [p.place(s.name, s.t0, s.t1)
             for name in ("decode.launch", "decode.prefill")
             for s in profiling.metrics.spans(name, run.w0) if s.t1 >= t0 and s.t0 <= t1]
    if not cover:
        raise RuntimeError("no decode.launch or decode.prefill span overlaps the sub-window")
    idle, out = outside(p, [(r.start, r.end) for r in cover])
    return 100.0 * out / idle if idle > 0 else 0.0
