"""What an int4 linear costs at decode shapes on the card, variant by variant.

    python -m outline_rag_tpu_torch.tools.bench_int4_kernel [shape ...]
    BENCH_M=1 python -m outline_rag_tpu_torch.tools.bench_int4_kernel 7b_wgu

The port's counterpart of the JAX package's ``tools/bench_int4_kernel.py``.
Run it on a machine with one CUDA card and ``nvcc``. Variants a shape:

  floor — ``int4_stream_floor``: every packed byte read once, no products:
          the packed-byte stream as the card delivers it (its outputs are
          allocated once, so a timing pays for the launch alone)
  w4a16 — ``_w4a16_matmul_as``: bf16 activations, weights decoded on the
          chip, one launch writing bf16 (the decoder's call)
  w4a8  — ``w4a8_matmul``: int8 activations, int8 tensor-core dots (two
          launches: the row quantizer and the product, as the decoder pays it)
  int8  — ``w8a8_matmul`` on the same ``[K, N]``, at twice the weight bytes

Shapes: the decode matmuls of the 7B / 13B rungs the JAX tool times, and
TinyLlama-1.1B's four projections. Two times a variant at ``BENCH_M`` rows
(default 32): ``{variant}_ms``, the median of 10 CUDA-event timings
(``BENCH_RUNS``) of one call, which for a kernel of a few microseconds is the
host's time to launch it; and ``{variant}_device_ms``, events around 100
back-to-back calls or a CUDA-graph replay of them (the smaller), each call on
the next of a ring of weights that spans three times the L2 cache, so that
every call streams its weights from device memory as a decode step does. One
JSON line a shape, with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
import zlib

import torch

from outline_rag_tpu_torch.ops.int4_linear import (
    _w4a16_matmul_as,
    int4_stream_floor,
    quantize_int4_weight,
    w4a8_matmul,
)
from outline_rag_tpu_torch.ops.int8_linear import quantize_linear_weight, w8a8_matmul
from outline_rag_tpu_torch.tools.timing import card, cold_ring, cuda_ms, cuda_ms_many

SHAPES = {  # name -> (K, N)
    "7b_wqkv": (4096, 6144),
    "7b_wo": (4096, 4096),
    "7b_wgu": (4096, 22016),
    "7b_wd": (11008, 4096),
    "13b_wgu": (5120, 27648),
    "13b_wd": (13824, 5120),
    "tinyllama_wqkv": (2048, 2560),
    "tinyllama_wo": (2048, 2048),
    "tinyllama_wgu": (2048, 11264),
    "tinyllama_wd": (5632, 2048),
}
VARIANTS = ("floor", "w4a16", "w4a8", "int8")


def bench_shape(name: str, k: int, n: int, m: int, dev, runs: int = 10, group_size: int = 128) -> dict:
    """Times of the four variants at ``[m, k] x [k, n]`` with seeded weights
    (the seed follows the shape's name): ``{variant}_ms`` (one call),
    ``{variant}_device_ms`` (many calls over a ring of cold weights) and the
    weight bytes a second each variant streams by the latter, in GB/s."""
    g = torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()) % 2**31)
    w = torch.randn((k, n), generator=g, device=dev) * 0.02
    q4, s4 = quantize_int4_weight(w, group_size)
    q8, s8 = quantize_linear_weight(w)
    del w
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    floor_out = int4_stream_floor(x, q4)
    calls = {  # variant -> (its call on given weights, the weights)
        "floor": (lambda q, s: int4_stream_floor(x, q, floor_out), (q4, s4)),
        "w4a16": (lambda q, s: _w4a16_matmul_as(x, q, s, torch.bfloat16), (q4, s4)),
        "w4a8": (lambda q, s: w4a8_matmul(x, q, s), (q4, s4)),
        "int8": (lambda q, s: w8a8_matmul(x, q, s), (q8, s8)),
    }
    row = {"shape": name, "K": k, "N": n, "M": m, "group_size": group_size}
    packed = n * k / 2
    for variant in VARIANTS:
        call, weights = calls[variant]
        ring = cold_ring(*weights)
        row[f"{variant}_ms"] = cuda_ms(lambda: call(*weights), runs)
        many = cuda_ms_many(lambda: call(*next(ring)))
        row[f"{variant}_device_ms"] = many["device_ms"]
        row[f"{variant}_weight_gb_per_s"] = (
            (2 if variant == "int8" else 1) * packed / many["device_ms"] / 1e6)
        del ring
    return row


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("bench_int4_kernel: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    m = int(os.environ.get("BENCH_M", 32))
    runs = int(os.environ.get("BENCH_RUNS", 10))
    smi = card()
    for name in argv or list(SHAPES):
        k, n = SHAPES[name]
        print(json.dumps({**bench_shape(name, k, n, m, dev, runs), "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
