"""Wall time of a decode step: the batcher's decode chunks started in the
window (host clock around a chunk that ends synchronised) over their steps
(traced runs only)."""

from portbench.window import spans


def read(run):
    chunks = spans(run, "decode_chunk")
    steps = sum(f["steps"] for _, _, f in chunks)
    return 1e3 * sum(t1 - t0 for t0, t1, _ in chunks) / steps if steps else None
