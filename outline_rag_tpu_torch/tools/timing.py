"""Timing on the card for the port's measurement tools: CUDA events around
a call, and the card's name and power limit to print beside every number."""

from __future__ import annotations

import statistics
import subprocess

import torch


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


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
