"""The grouped expert product's share of its roofline in the traced window:
for the decode and prefill chunks the profiler saw whole, the least time
their routed experts could take (``arch/<model_type>.py::expert_cost`` of
the port's ``moe.route`` record of each chunk: each distinct expert's
weights read once, the pairs' activations in and out, or their FLOPs at the
bf16 peak) over the device time of the grouped product's kernels launched
inside the chunk. Those are ``torch._grouped_mm``'s CUTLASS kernels on sm_90,
named ``cutlass::device_kernel<...GroupProblemShape...>``. None without a
profile of the card, on an architecture without routed experts, or on a port
that records no ``moe.route``."""

from portbench import roofline


def grouped(name: str) -> bool:
    return "GroupProblemShape" in name


def read(run):
    from outline_rag_tpu_torch.utils import profiling

    cost = getattr(run.arch, "expert_cost", None)
    if run.profile is None or cost is None or not hasattr(profiling.metrics, "spans"):
        return None
    t0, t1 = run.traced
    bound = device_us = 0.0
    for s in profiling.metrics.spans("moe.route", run.w0):
        if t0 <= s.t0 and s.t1 <= t1:
            n_bytes, flops = cost(run.config, s.fields["experts_hit"], s.fields["pairs"])
            bound += roofline.bound_s(n_bytes, flops)
            rng = run.profile.place("moe.route", s.t0, s.t1)
            device_us += sum(op.end - op.start for op in run.profile.kernels_in(rng, grouped))
    return 100.0 * bound * 1e6 / device_us if device_us > 0 else None
