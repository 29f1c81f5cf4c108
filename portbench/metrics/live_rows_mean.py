"""Mean live rows of the decode batcher (its ``active`` rows) at each decode
chunk started in the window (traced runs only)."""

from portbench.window import spans


def read(run):
    chunks = spans(run, "decode_chunk")
    return sum(len(f["lengths"]) for _, _, f in chunks) / len(chunks) if chunks else None
