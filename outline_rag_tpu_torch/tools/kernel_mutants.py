"""How strong are the checks that hold the decoder's kernels to their twins?

    python -m outline_rag_tpu_torch.tools.kernel_mutants

Run it on a machine with one CUDA card and ``nvcc``. It copies
``csrc/paged_attention.cu`` and ``csrc/int8_linear.cu`` into a temporary
directory, applies one fault at a time to the copy (a skipped key tile, a
missing rescale, a horizon off by one, a dropped scale, ...), builds each
mutant into a library of its own, runs it through the package's wrapper at
the decoder's shapes, and prints whether the comparison ``chip_smoke.py``
and the card tests use would have passed it. The sources in the package are
never changed. The unmutated copy must pass and every structural mutant must
fail; a mutant that only moves a rounding (``p_not_rounded``) is below what
a tolerance for bf16 rounding can see, and is listed to say so.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import outline_rag_tpu_torch.ops.int8_linear as int8_linear_module
import outline_rag_tpu_torch.ops.paged_attention as paged_module
from outline_rag_tpu_torch.ops import _build
from outline_rag_tpu_torch.testing import flash_errors, paged_attention_case

# (atol, bf16 ulps, error norm / output norm), as chip_smoke.py holds them
PAGED_BOUNDS = {"bf16": (2e-3, 2.0, 1e-2), "int8": (1e-4, 1.0, 1e-3)}

PAGED_MUTANTS = {
    "as_is": ("", ""),
    "skip_tile": ("    for (int k0 = 0; k0 < in_page; k0 += TK) {",
                  "    for (int k0 = 0; k0 < in_page; k0 += TK) {\n"
                  "      if (pi == 1 && k0 == 32) continue;"),
    "no_acc_rescale": ("for (int i = 0; i < DPT; ++i) acc[i] *= alpha;",
                       "for (int i = 0; i < DPT; ++i) acc[i] *= 1.f;"),
    "no_l_rescale": ("l[i] = __fadd_rn(__fmul_rn(l[i], alpha), sum);",
                     "l[i] = __fadd_rn(l[i], sum);"),
    "horizon_off_by_one": ("slot > horizon[i]) v = MASKED;", "slot >= horizon[i]) v = MASKED;"),
    "no_k_scale": ("if (kv_kind == KIND_INT8) v = __fmul_rn(v, Sc[lane]);", ""),
    "no_v_scale": ("if (kv_kind == KIND_INT8) pw = __fmul_rn(p, Sc[TK + lane]);", ""),
    "p_not_rounded": (
        "if (kv_kind == KIND_BF16) pw = __bfloat162float(__float2bfloat16_rn(p));", ""),
}
LINEAR_MUTANTS = {
    "as_is": ("", ""),
    "f32_scale": ("w_live ? __bfloat162float(__float2bfloat16_rn(s[n0 + wn])) : 0.f;",
                  "w_live ? s[n0 + wn] : 0.f;"),
    "drop_last_k_tile": ("for (int k0 = 0; k0 < K; k0 += BK) {",
                         "for (int k0 = 0; k0 < K - BK; k0 += BK) {"),
}


def build_mutant(tmp: Path, source: Path, name: str, old: str, new: str, symbol: str):
    text = source.read_text()
    if old:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the line to mutate occurs {text.count(old)} times")
        text = text.replace(old, new)
    cu, so = tmp / f"{source.stem}_{name}.cu", tmp / f"{source.stem}_{name}.so"
    cu.write_text(text)
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-shared", "-o", str(so), str(cu)]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{run.stderr}")
    return getattr(ctypes.CDLL(str(so)), symbol)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_mutants: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(1)
    unexpected = 0
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        cases = {kv: [paged_attention_case(dev, g, 64, 1, kv),
                      paged_attention_case(dev, g, 1, 256, kv, pos=[512])]
                 for kv in PAGED_BOUNDS}
        plains = {kv: [paged_module.paged_attention_plain(*a) for a in cases[kv]] for kv in cases}
        paged_module._launcher("attention")  # bind the real library first, then swap one entry
        real = paged_module._launch_fns["attention"]
        for name, (old, new) in PAGED_MUTANTS.items():
            fn = build_mutant(tmp, _build.CSRC_DIR / "paged_attention.cu", name, old, new,
                              "paged_attention_launch")
            fn.argtypes, fn.restype = real.argtypes, real.restype
            paged_module._launch_fns["attention"] = fn
            for kv, (atol, ulps, rms) in PAGED_BOUNDS.items():
                if name in ("no_k_scale", "no_v_scale") and kv != "int8":
                    continue  # the fault is in code a bf16 pool never runs
                for args, plain in zip(cases[kv], plains[kv]):
                    out = paged_module.paged_attention(*args)
                    torch.cuda.synchronize()
                    e = flash_errors(out, plain, atol, ulps)
                    ok = e["worst_vs_bound"] <= 1.0 and e["rel_rms_err"] <= rms
                    unexpected += ok != (name in ("as_is", "p_not_rounded"))
                    print(f"paged_attention {name:19s} {kv:4s} B={args[0].shape[0]:2d} "
                          f"T={args[0].shape[1]:3d} passes={ok} "
                          f"worst_vs_bound={e['worst_vs_bound']:.3g} "
                          f"rel_rms_err={e['rel_rms_err']:.3g}", flush=True)
        paged_module._launch_fns["attention"] = real

        x = torch.randn((64, 2048), generator=g, device=dev).to(torch.bfloat16)
        q, s = int8_linear_module.quantize_linear_weight(
            torch.randn((2048, 2560), generator=g, device=dev) * 0.02)
        plain = int8_linear_module.int8_linear_plain(x, q, s)
        real = int8_linear_module._launcher()
        for name, (old, new) in LINEAR_MUTANTS.items():
            fn = build_mutant(tmp, _build.CSRC_DIR / "int8_linear.cu", name, old, new,
                              "int8_linear_launch")
            fn.argtypes, fn.restype = real.argtypes, real.restype
            int8_linear_module._launch_fn = fn
            out = int8_linear_module.int8_linear(x, q, s)
            torch.cuda.synchronize()
            e = flash_errors(out, plain, 1e-5 * float(plain.abs().max()), 1.0)
            ok = e["worst_vs_bound"] <= 1.0
            unexpected += ok != (name == "as_is")
            print(f"int8_linear     {name:19s} passes={ok} "
                  f"worst_vs_bound={e['worst_vs_bound']:.3g} rel_rms_err={e['rel_rms_err']:.3g}",
                  flush=True)
        int8_linear_module._launch_fn = real
    print(f"unexpected verdicts: {unexpected}")
    return 1 if unexpected else 0


if __name__ == "__main__":
    sys.exit(main())
