"""``csrc/paged_attention.cu``'s share of its roofline in the traced window:
for the decode and prefill chunks the profiler saw whole, the least time
their launches could take (each live row's K and V read once at its length,
q read and the output written, or the causal products at the bf16 peak,
``roofline.paged_attention_cost``, one launch a layer a step) over the
device time of the paged kernels inside them."""

from portbench import roofline
from portbench.window import chunks


def read(run):
    cfg = run.config
    layers = cfg["num_hidden_layers"]
    bound = device_us = 0.0
    for rng, f in chunks(run, "decode_chunk"):
        for s in range(f["steps"]):
            n_bytes, flops = roofline.paged_attention_cost(cfg, [p + s + 1 for p in f["lengths"]], 1)
            bound += layers * roofline.bound_s(n_bytes, flops)
        device_us += sum(op.end - op.start
                         for op in run.profile.kernels_in(rng, lambda n: "paged_kernel" in n))
    for rng, f in chunks(run, "prefill_chunk"):
        n_bytes, flops = roofline.paged_attention_cost(cfg, [f["start"] + f["tokens"]], f["tokens"])
        bound += layers * roofline.bound_s(n_bytes, flops)
        device_us += sum(op.end - op.start
                         for op in run.profile.kernels_in(rng, lambda n: "paged_kernel" in n))
    return 100.0 * bound * 1e6 / device_us if device_us > 0 else None
