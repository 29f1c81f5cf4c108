"""Mean asks in a batch the query batcher handed to
``RetrievalService.retrieve_batch``, over the batches started in the window."""

from portbench.window import spans


def read(run):
    batches = spans(run, "retrieve_batch")
    return sum(f["n"] for _, _, f in batches) / len(batches) if batches else None
