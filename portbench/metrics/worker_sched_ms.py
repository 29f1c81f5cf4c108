"""Host time the decode worker spends a loop pass on scheduling: over the
passes that started in the window, but for those that overlap the profiler's
sub-window, the self time of the port's ``decode.stage`` spans (staging and
advancing admissions, less the ``decode.prefill`` chunks inside them) plus
the ``decode.emit`` spans (the host state, each row's tokens, finishes and
cancels), over the number of passes. None on a port that records no spans."""

import bisect

from portbench.window import untraced


def read(run):
    from outline_rag_tpu_torch.utils import profiling

    m = profiling.metrics
    if not hasattr(m, "spans"):
        return None

    def kept(name):
        got = [s for s in m.spans(name, run.w0) if s.t0 < run.w1]
        return got, [s for s in got if untraced(run, s.t0, s.t1)]

    every, stages = kept("decode.stage")
    if not every:
        raise RuntimeError("the port recorded no decode.stage span in the window")
    if not stages:
        return None
    prefills = sorted((s.t0, s.t1, s.thread) for s in m.spans("decode.prefill", run.w0))
    starts = [p[0] for p in prefills]
    busy = 0.0
    for s in stages:
        inside = prefills[bisect.bisect_left(starts, s.t0):bisect.bisect_right(starts, s.t1)]
        busy += (s.t1 - s.t0) - sum(t1 - t0 for t0, t1, th in inside
                                    if th == s.thread and t1 <= s.t1)
    busy += sum(s.t1 - s.t0 for s in kept("decode.emit")[1])
    return 1e3 * busy / len(stages)
