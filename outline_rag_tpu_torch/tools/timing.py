"""Timing on the card for the port's measurement tools: CUDA events around
a call or around a run of many launches, and the card's name and power limit
to print beside every number."""

from __future__ import annotations

import itertools
import statistics
import subprocess

import torch

# Bytes a ring of inputs must span so that each launch finds its input cold:
# three times the card's 50 MB L2 cache; and the fewest and the most copies.
COLD_RING_BYTES = 150_000_000
COLD_RING_COPIES = (4, 64)


def cuda_ms(fn, runs: int = 10) -> float:
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event timings, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_many(fn, launches: int = 100, runs: int = 5) -> dict:
    """Milliseconds a call of ``fn`` on the device, for kernels of a few
    microseconds, where two events around one launch read the host. After
    three warm-up calls, ``runs`` timings of ``launches`` back-to-back calls
    between two events, each divided by ``launches``; the median is
    ``queued_ms``. Python enqueues a launch in some 5-20 us, so for a
    shorter kernel the queue still drains and ``queued_ms`` is the host's
    pace: so the same run of calls is also captured once into a
    ``torch.cuda.CUDAGraph`` (``fn`` must neither synchronize nor read a
    result on the host) and its replays are timed the same way, as
    ``graph_ms``. ``device_ms`` is the smaller reading; their ratio says how
    far the host held the queued run back. ``fn`` may walk a ring of inputs
    (a new weight each call) to keep what it reads out of the L2 cache."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(launches):
            fn()

    def timed(body) -> float:
        body()  # the run itself warm: allocator, graph upload
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            body()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / launches)
        return statistics.median(times)

    queued_ms = timed(run)
    captured = torch.cuda.CUDAGraph()
    with torch.cuda.graph(captured):
        run()
    graph_ms = timed(captured.replay)
    return {"launches": launches, "queued_ms": queued_ms, "graph_ms": graph_ms,
            "device_ms": min(queued_ms, graph_ms)}


def cold_ring(*tensors):
    """An endless cycle over copies of ``tensors`` (one tuple a step): as
    many as span ``COLD_RING_BYTES``, within ``COLD_RING_COPIES``, so that a
    run of launches that takes the next tuple each time finds its operand in
    device memory and not in the L2 cache, as a decode step finds its
    weights."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    least, most = COLD_RING_COPIES
    copies = min(most, max(least, -(-COLD_RING_BYTES // max(size, 1))))
    return itertools.cycle([tuple(t.clone() for t in tensors) for _ in range(copies)])


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
