"""How strong are the checks that hold the decoder's kernels to their twins?

    python -m outline_rag_tpu_torch.tools.kernel_mutants

Run it on a machine with one CUDA card and ``nvcc``. It copies
``csrc/paged_attention.cu``, ``csrc/int8_linear.cu`` and
``csrc/int4_linear.cu`` into a temporary directory, applies one fault at a
time to the copy (a skipped key tile, a missing rescale, a horizon off by
one, a dropped scale, swapped nibbles, a missing sign extension, ...), builds each
mutant into a library of its own, runs it through the package's wrapper at
the decoder's shapes, and prints whether the comparison ``chip_smoke.py``
and the card tests use would have passed it. The sources in the package are
never changed. The unmutated copy must pass and every structural mutant must
fail; a mutant that only moves a rounding (``p_not_rounded``) is below what
a tolerance for bf16 rounding can see, and is listed to say so. The
speculative decoding path has no kernel of its own and so no mutant.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import outline_rag_tpu_torch.ops.int4_linear as int4_linear_module
import outline_rag_tpu_torch.ops.int8_linear as int8_linear_module
import outline_rag_tpu_torch.ops.paged_attention as paged_module
from outline_rag_tpu_torch.ops import _build
from outline_rag_tpu_torch.testing import flash_errors, paged_attention_case, scaled_errors

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
# int4: one fault may need an edit in each kernel: [(old, new, occurrences)]
_K_LOOP = "for (int k0 = 0; k0 < K; k0 += BK) {"
INT4_MUTANTS = {
    "as_is": [],
    "nibbles_swapped": [("(hi ? w >> 4 : w) & 0x0f0f0f0fu", "(hi ? w : w >> 4) & 0x0f0f0f0fu", 1)],
    "hi_not_sign_extended": [("hi ? nib ^ 0x08080808u : nib;", "hi ? nib + 0x08080808u : nib;", 1)],
    "lo_not_debiased": [("hi ? nib ^ 0x08080808u : nib;",
                         "hi ? nib ^ 0x08080808u : nib + 0x08080808u;", 1)],
    "scale_from_next_group": [
        ("const float s0 = sc0[grp], s1 = sc1[grp];",
         "const float s0 = sc0[grp ^ 1], s1 = sc1[grp ^ 1];", 1),
        ("out.s = srow[k0 / gsz];", "out.s = srow[(k0 / gsz) ^ 1];", 1)],
    "dropped_k_chunk": [
        ("for (int c = 0; c < chunks; ++c) {", "for (int c = 0; c < chunks - 1; ++c) {", 1),
        (_K_LOOP, _K_LOOP.replace("k0 < K;", "k0 < K - BK;"), 2)],
}


def build_mutant(tmp: Path, source: Path, name: str, old, new: str = "", symbol: str | None = None):
    """Build a copy of ``source`` with ``old`` replaced by ``new`` (or with
    every ``(old, new, occurrences)`` edit of a list) into a library of its
    own; returns its ``symbol``, or the library."""
    text = source.read_text()
    edits = old if isinstance(old, list) else ([(old, new, 1)] if old else [])
    for old_text, new_text, count in edits:
        if text.count(old_text) != count:
            raise RuntimeError(
                f"{name}: the line to mutate occurs {text.count(old_text)} times, not {count}")
        text = text.replace(old_text, new_text)
    cu, so = tmp / f"{source.stem}_{name}.cu", tmp / f"{source.stem}_{name}.so"
    cu.write_text(text)
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-shared", "-o", str(so), str(cu)]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{run.stderr}")
    lib = ctypes.CDLL(str(so))
    return getattr(lib, symbol) if symbol else lib


def int4_mutants(tmp: Path, dev, g) -> int:
    """Every int4 mutant through ``w4a8_matmul`` and ``w4a16_matmul`` (bf16
    and f32) at M = 32, at a TinyLlama projection with groups of 128 and at a
    small shape with groups of 256 (the neighbouring group's scale is another
    one there); the bound is chip_smoke.py's: 1e-5 of the output's scale plus
    1e-5 relative. Returns the number of unexpected verdicts."""
    m = int4_linear_module
    cases = []
    for k, n, gsz in ((2048, 2560, 128), (512, 384, 256)):
        q4, s4 = m.quantize_int4_weight(torch.randn((k, n), generator=g, device=dev) * 0.02, gsz)
        x = torch.randn((32, k), generator=g, device=dev)
        cases.append((k, n, gsz, x, q4, s4))
    real = {which: m._launcher(which) for which in ("w4a8", "w4a16")}
    unexpected = 0
    for name, edits in INT4_MUTANTS.items():
        lib = build_mutant(tmp, _build.CSRC_DIR / "int4_linear.cu", name, edits)
        for which, fn in real.items():
            mutant = getattr(lib, f"int4_{which}_launch")
            mutant.argtypes, mutant.restype = fn.argtypes, fn.restype
            m._launch_fns[which] = mutant
        for k, n, gsz, x, q4, s4 in cases:
            runs = {"w4a8": (m.w4a8_matmul(x, q4, s4), m.w4a8_matmul_plain(x, q4, s4))}
            for label, dt in (("w4a16_bf16", torch.bfloat16), ("w4a16_f32", torch.float32)):
                runs[label] = (m.w4a16_matmul(x.to(dt), q4, s4), m.w4a16_matmul_plain(x.to(dt), q4, s4))
            torch.cuda.synchronize()
            for label, (out, plain) in runs.items():
                e = scaled_errors(out, plain)
                ok = e["worst_vs_bound"] <= 1.0
                # a neighbouring group's scale is the same fault at every gsz;
                # all mutants must fail at every shape
                unexpected += ok != (name == "as_is")
                print(f"int4 {label:10s} {name:21s} K={k:4d} N={n:4d} gsz={gsz:3d} passes={ok} "
                      f"worst_vs_bound={e['worst_vs_bound']:.3g}", flush=True)
    m._launch_fns.update(real)
    return unexpected


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
        unexpected += int4_mutants(tmp, dev, g)
    print(f"unexpected verdicts: {unexpected}")
    return 1 if unexpected else 0


if __name__ == "__main__":
    sys.exit(main())
