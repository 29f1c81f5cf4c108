"""Model FLOPs of the retrieval batches started in the window over the
window (both without the profiler's sub-window), as a share of the card's bf16 peak: the query encoder at B x query
width tokens, the cross-encoder at B x top_k pairs of query width + token
width, and the int8 scan's 2 x B x N x D operations counted at the bf16
peak's share of the int8 peak."""

from portbench import roofline
from portbench.window import spans, untraced_seconds


def read(run):
    batches = spans(run, "retrieve_batch")
    if not batches:
        return None
    cfg = run.config["retrieval_stack"]
    enc, rr, ix, r = cfg["encoder"], cfg["reranker"], cfg["index"], cfg["retrieval"]
    pair = r["query_width"] + ix["token_width"]
    flops = 0.0
    for _, _, f in batches:
        b = f["n"]
        flops += roofline.xlmr_flops(enc, b, r["query_width"])
        flops += roofline.xlmr_flops(rr, b * r["top_k"], pair)
        flops += (roofline.scan_ops(b, ix["rows"], ix["dim"])
                  * roofline.PEAK_BF16 / roofline.PEAK_INT8)
    return 100.0 * flops / untraced_seconds(run) / roofline.PEAK_BF16
