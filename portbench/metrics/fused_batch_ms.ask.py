"""Mean wall time of one ``RetrievalService.retrieve_batch`` call (the fused
query, which returns host rows), over the batches started in the window."""

from portbench.window import spans


def read(run):
    batches = spans(run, "retrieve_batch")
    return 1e3 * sum(t1 - t0 for t0, t1, _ in batches) / len(batches) if batches else None
