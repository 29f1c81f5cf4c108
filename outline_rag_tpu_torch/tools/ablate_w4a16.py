"""What holds the bf16 w4a16 kernel: copies of it with one part of its work
taken out, timed beside the kernel as it is.

    python -m outline_rag_tpu_torch.tools.ablate_w4a16

Run it on a machine with one CUDA card and ``nvcc``. Each variant is one
edit of a copy of ``csrc/int4_linear.cu`` in a temporary directory, built
into a library of its own (``kernel_mutants.ablate``; the sources in
the package are never changed), and timed through the decoder's call,
``_w4a16_matmul_as(x, q4, s4, bf16)``, as ``device_ms``: 100 launches or
their CUDA-graph replay over a ring of weights that spans three times the L2
cache (``tools/timing.py``), at M = 32 and 16 at TinyLlama's five
projection shapes. A variant without a part computes a wrong result and is
read for its time alone; ``base`` and ``cb32_wider`` are also held to the
twin (``ok_*``). One JSON line a variant, after the card's name and power
limit.

  base        the kernel as it is
  no_mma      the tensor-core instruction replaced by four dependent adds
  no_cvt      the two f32 -> bf16x2 conversions of a decoded word replaced
              by XORs
  no_decode   the nibble decode, scale product and conversion replaced by
              the raw packed word
  no_fold     the fold adds one warp's sums instead of sixteen
  no_x        the activations made from indices instead of loaded
  cb32_wider  items of 32 channels down to N = 2,112 (16 channels only
              where 32 would not give every SM one)
"""

from __future__ import annotations

import sys

import torch

import outline_rag_tpu_torch.ops.int4_linear as int4
from outline_rag_tpu_torch.ops import _build
from outline_rag_tpu_torch.testing import scaled_errors
from outline_rag_tpu_torch.tools.kernel_mutants import ablate
from outline_rag_tpu_torch.tools.timing import card, cold_ring

_MMA = '''  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''
_CVT = '''  b0 = pack_bf16(f[0], f[1]);
  b1 = pack_bf16(f[2], f[3]);'''
# {variant: [(old, new, occurrences)]}
VARIANTS = {
    "base": [],
    "no_mma": [(_MMA, "  c[0] += __uint_as_float(a[0] ^ b0); c[1] += __uint_as_float(a[1] ^ b1);\n"
                      "  c[2] += __uint_as_float(a[2] ^ b0); c[3] += __uint_as_float(a[3] ^ b1);", 1)],
    "no_cvt": [(_CVT, "  b0 = __float_as_uint(f[0]) ^ __float_as_uint(f[1]);\n"
                      "  b1 = __float_as_uint(f[2]) ^ __float_as_uint(f[3]);", 1)],
    "no_decode": [(
        "  const uint32_t u = hi ? ((w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u : w & 0x0f0f0f0fu;\n"
        "  float f[4];",
        "  b0 = w; b1 = w ^ __float_as_uint(s); return;\n  const uint32_t u = 0;\n  float f[4];", 1)],
    "no_fold": [(
        "          for (int w = 0; w < 2 * W8_CHUNKS; ++w) fsum[i] = __fadd_rn(fsum[i], p[w * ROWS * PS]);",
        "          fsum[i] = __fadd_rn(fsum[i], p[0]);", 1)],
    "no_x": [(
        "            const uint4 v = live ? ldg16(x + (long long)r * K + col + 128 * nib + 8 * h)\n"
        "                                 : make_uint4(0, 0, 0, 0);",
        "            const uint4 v = make_uint4(tid, r, col, nib + h);", 1)],
    "cb32_wider": [("const bool narrow = N / 32 < sm_count();",
                    "const bool narrow = N / 16 <= sm_count();", 1)],
}
SHAPES = [(2048, 11264), (2048, 2560), (2048, 2048), (5632, 2048), (2048, 32000)]  # (K, N)
HELD_TO_THE_TWIN = ("base", "cb32_wider")


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_w4a16: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    print(card(), flush=True)
    g = torch.Generator(device=dev).manual_seed(5)
    runs = []
    for k, n in SHAPES:
        q4, s4 = int4.quantize_int4_weight(torch.randn((k, n), generator=g, device=dev) * 0.02, 128)
        x = torch.randn((32, k), generator=g, device=dev).to(torch.bfloat16)
        ring = cold_ring(q4, s4)
        for m in (32, 16):
            runs.append((
                f"{k}x{n}_m{m}",
                lambda xm=x[:m], ring=ring: int4._w4a16_matmul_as(xm, *next(ring), torch.bfloat16),
                lambda xm=x[:m], q4=q4, s4=s4: scaled_errors(
                    int4.w4a16_matmul(xm, q4, s4),
                    int4.w4a16_matmul_plain(xm, q4, s4))["worst_vs_bound"] <= 1.0))
    real = int4._launcher("w4a16")

    def install(lib):
        fn = real if lib is None else lib.int4_w4a16_launch
        fn.argtypes, fn.restype = real.argtypes, real.restype
        int4._launch_fns["w4a16"] = fn

    ablate(_build.CSRC_DIR / "int4_linear.cu", VARIANTS, install, runs, HELD_TO_THE_TWIN)
    return 0


if __name__ == "__main__":
    sys.exit(main())
