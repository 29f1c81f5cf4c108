"""Kernels a decode step launches: the fewest kernel launches the decode
worker made inside a decode chunk the profiler saw, over the chunk's steps.
The count repeats exactly from chunk to chunk; only the worker's own
launches are counted, so retrieval batches on other threads do not add to
it. A decode chunk in which the worker launched nothing means the
profiler's clock or thread was placed wrong, and raises."""

from portbench.window import chunks


def read(run):
    if run.profile is None or not run.profile.launch_calls:  # no card
        return None
    got = chunks(run, "decode_chunk")
    if any(rng.launches == 0 for rng, _ in got):
        raise RuntimeError("a traced decode chunk holds no launch of the worker's")
    counts = [rng.launches / f["steps"] for rng, f in got]
    return min(counts) if counts else None
