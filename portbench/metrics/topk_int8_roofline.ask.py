"""``csrc/topk_int8.cu``'s share of its roofline in the traced window: the
least time its calls could take (the q1 plane, scales and penalty of every
row read once, ``roofline.int8_scan_bytes``, or its operations at the int8
peak, whichever is longer) over the device time of its two kernels (the
scan and the merge, one of each a call)."""

from portbench import roofline
from portbench.window import spans


def read(run):
    if run.profile is None:
        return None
    scans = [op for op in run.profile.device if "scan_kernel(" in op.name]
    merges = [op for op in run.profile.device if "merge_kernel(" in op.name]
    device_us = sum(op.end - op.start for op in scans + merges)
    if not scans or device_us <= 0:
        return None
    cfg = run.config["retrieval_stack"]
    ix, r = cfg["index"], cfg["retrieval"]
    batches = spans(run, "retrieve_batch")
    b = sum(f["n"] for _, _, f in batches) / len(batches) if batches else 1
    one = roofline.bound_s(roofline.int8_scan_bytes(b, ix["rows"], ix["dim"], ix["rescore_m"]),
                           roofline.scan_ops(b, ix["rows"], ix["dim"]), roofline.PEAK_INT8)
    return 100.0 * len(scans) * one * 1e6 / device_us
