"""What holds the w8a16 linear kernel: copies of it with one part of its
work taken out, timed beside the kernel as it is.

    python -m outline_rag_tpu_torch.tools.ablate_int8_linear

Run it on a machine with one CUDA card and ``nvcc``. Each variant is one
edit of a copy of ``csrc/int8_linear.cu`` or more, in a temporary directory,
built into a library of its own (``kernel_mutants.ablate``; the sources
in the package are never changed), and timed through ``int8_linear`` as
``device_ms``: 100 launches or their CUDA-graph replay over a ring of weights
that spans three times the L2 cache (``tools/timing.py``), at M = 64 and 256
at TinyLlama's five projection shapes. A variant without a part computes a
wrong result and is read for its time alone; ``base`` and ``ring_8`` are
also held to the twin (``ok_*``). One JSON line a variant, after the card's
name and power limit.

  base         the kernel as it is
  no_mma       the tensor-core instruction replaced by one add a call
  no_decode    the int8 decode, scale product and conversion replaced by
               the raw weight word
  no_fold      each block writes its own split's partial sums, no cluster
               reads
  no_x         the x tile neither loaded nor waited for
  ring_8       eight ring slots at one and two row tiles instead of six
"""

from __future__ import annotations

import sys

import torch

import outline_rag_tpu_torch.ops.int8_linear as lin
from outline_rag_tpu_torch.ops import _build
from outline_rag_tpu_torch.testing import flash_errors
from outline_rag_tpu_torch.tools.kernel_mutants import ablate
from outline_rag_tpu_torch.tools.timing import card, cold_ring

# {variant: [(old, new, occurrences)]}
VARIANTS = {
    "base": [],
    "no_mma": [(
        '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %37, 0;\\n"\n'
        '      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"',
        '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %37, 0;\\n"\n'
        '      "add.f32 %0, %0, 0f3F800000;\\n" "// {"', 1)],
    "no_decode": [(
        "  const uint32_t u = w ^ 0x80808080u;\n",
        "  return w ^ sel0 ^ __float_as_uint(sc);\n  const uint32_t u = w ^ 0x80808080u;\n", 1)],
    "no_fold": [("for (int p = 1; p < live_splits; ++p) {", "for (int p = 1; p < 1; ++p) {", 1),
                ("float4 v = ld_cluster(local, 0);",
                 "float4 v = *reinterpret_cast<const float4*>(part + r * PS + c);", 1)],
    "no_x": [("    tma_load(slot, &x_map, &full[st], c * KC, m0);\n", "", 1),
             ("mbar_arrive_expect_tx(&full[st], L::STAGE);",
              "mbar_arrive_expect_tx(&full[st], L::W_BYTES);", 1)],
    "ring_8": [("static constexpr int STAGES = RT == MAX_RT ? 5 : 6;",
                "static constexpr int STAGES = RT == MAX_RT ? 5 : 8;", 1)],
}
SHAPES = [(2048, 11264), (2048, 2560), (2048, 2048), (5632, 2048), (2048, 32000)]  # (K, N)
HELD_TO_THE_TWIN = ("base", "ring_8")


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_int8_linear: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    print(card(), flush=True)
    g = torch.Generator(device=dev).manual_seed(8)

    def within_bound(xm, q, s) -> bool:
        plain = lin.int8_linear_plain(xm, q, s)
        e = flash_errors(lin.int8_linear(xm, q, s), plain, 1e-5 * float(plain.abs().max()), 1.0)
        return e["worst_vs_bound"] <= 1.0

    runs = []
    for k, n in SHAPES:
        q, s = lin.quantize_linear_weight(torch.randn((k, n), generator=g, device=dev) * 0.02)
        x = torch.randn((256, k), generator=g, device=dev).to(torch.bfloat16)
        ring = cold_ring(q, s)
        for m in (64, 256):
            runs.append((f"{k}x{n}_m{m}",
                         lambda xm=x[:m], ring=ring: lin.int8_linear(xm, *next(ring)),
                         lambda xm=x[:m], q=q, s=s: within_bound(xm, q, s)))
    real = lin._launcher()

    def install(lib):
        fn = real if lib is None else lib.int8_linear_launch
        fn.argtypes, fn.restype = real.argtypes, real.restype
        lin._launch_fn = fn

    ablate(_build.CSRC_DIR / "int8_linear.cu", VARIANTS, install, runs, HELD_TO_THE_TWIN)
    return 0


if __name__ == "__main__":
    sys.exit(main())
