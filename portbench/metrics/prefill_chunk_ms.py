"""Mean wall time of one paged prefill chunk started in the window (host
clock around a chunk that ends synchronised; traced runs only)."""

from portbench.window import spans


def read(run):
    chunks = spans(run, "prefill_chunk")
    return 1e3 * sum(t1 - t0 for t0, t1, _ in chunks) / len(chunks) if chunks else None
