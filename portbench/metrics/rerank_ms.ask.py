"""Mean time of the cross-encoder's forward on the device's stream, from
CUDA events that hooks on the reranker record around it, over the calls
that ended in the window outside the profiler's sub-window (traced runs
only)."""

from portbench.window import untraced


def read(run):
    events = [(s, e) for t, s, e in run.info.get("rerank_events", ())
              if run.w0 <= t < run.w1 and untraced(run, t, t)]
    if not events:
        return None
    return sum(s.elapsed_time(e) for s, e in events) / len(events)
