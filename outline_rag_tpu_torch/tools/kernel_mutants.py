"""How strong are the checks that hold the kernels to their twins?

    python -m outline_rag_tpu_torch.tools.kernel_mutants [kernel ...]
    python -m outline_rag_tpu_torch.tools.kernel_mutants --ablate paged_attention|topk_int8

Run it on a machine with one CUDA card and ``nvcc`` (all kernels, or those
named among ``paged_attention``, ``int8_linear``, ``int4``,
``flash_attention``, ``topk_float``, ``topk_int8``). It copies
``csrc/flash_attention.cu``, ``csrc/paged_attention.cu``,
``csrc/int8_linear.cu``, ``csrc/int4_linear.cu``, ``csrc/topk_float.cu`` and
``csrc/topk_int8.cu`` (with their headers) into a temporary
directory, applies one fault at a time to the copy (a skipped key tile, a
missing rescale, an unswizzled tile, a horizon off by one, a dropped scale,
splits folded out of order, a ring slot read before it landed, swapped
nibbles, a missing sign extension, a group combined out of order, a dropped
k-step or compensation term, a missing penalty, scales in another order, ...),
builds each mutant into a library of its own, runs it through the package's
wrapper at the model's shapes, and prints whether the comparison
``chip_smoke.py`` and the card tests use would have passed it. The sources
in the package are never changed. The unmutated copy must pass and every
structural mutant must fail (a paged mutant in at least one of its cases on
each pool: some faults show only where a tile straddles a split boundary, or
in the fold-order row); a mutant that only moves a rounding
(``p_not_rounded``) is below what a tolerance for bf16 rounding can see, and
is listed to say so. ``--ablate paged_attention`` times the copies of
``PAGED_VARIANTS`` instead, ``--ablate topk_int8`` those of ``INT8_VARIANTS``. The speculative decoding path has no kernel of
its own and so no mutant.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import outline_rag_tpu_torch.ops.attention as attention_module
import outline_rag_tpu_torch.ops.int4_linear as int4_linear_module
import outline_rag_tpu_torch.ops.int8_linear as int8_linear_module
import outline_rag_tpu_torch.ops.paged_attention as paged_module
import outline_rag_tpu_torch.ops.topk as topk_module
from outline_rag_tpu_torch.ops import _build
from outline_rag_tpu_torch.testing import (
    flash_errors,
    paged_attention_case,
    paged_order_case,
    quantizer_rows,
    scaled_errors,
    tie_aware_mismatches,
)
from outline_rag_tpu_torch.tools.timing import cuda_ms_many

# (atol, bf16 ulps, error norm / output norm), as chip_smoke.py holds them
PAGED_BOUNDS = {"bf16": (2e-3, 2.0, 1e-2), "int8": (1e-4, 1.0, 1e-3)}

FLASH_BOUNDS = (2e-3, 2.0, 1e-2)  # bf16, as chip_smoke.py holds it

FLASH_MUTANTS = {
    "as_is": ("", ""),
    "skip_tile": ("if (__any_sync(0xffffffffu, live)) {",
                  "if (__any_sync(0xffffffffu, live) && key0 != 2 * BK) {"),
    "no_acc_rescale": ("if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {",
                       "if (alpha0 < 0.f) {"),
    "no_l_rescale": ("    l0 = l0 * alpha0 + sum0;\n    l1 = l1 * alpha1 + sum1;",
                     "    l0 = l0 + sum0;\n    l1 = l1 + sum1;"),
    "unswizzled_tile": ("CU_TENSOR_MAP_SWIZZLE_128B,", "CU_TENSOR_MAP_SWIZZLE_NONE,"),
    "v_step_not_advanced": ("wgmma_pv(o, p[kk], v_desc + kk * (16 * HD * 2 >> 4));",
                            "wgmma_pv(o, p[kk], v_desc);"),
    "padding_not_masked": ("x[i] = key < S ? brow[key] : NEG_BIAS;", "x[i] = 0.f;"),
}

_FOLD_LOOP = ("    for (int c = 0; c < CLUSTER; ++c) {\n      if (c < live_blocks) {\n"
              "        const float w")
_REQUEST = "    request(k + STAGES - 1);  // into the slot tile k - 1 held"
PAGED_MUTANTS = {
    "as_is": ("", ""),
    "skip_tile": (_REQUEST, _REQUEST + "\n    if (k == 1) continue;"),
    "no_acc_rescale": ("for (int x = 0; x < DPL; ++x) acc[i][x] *= alpha[i];",
                       "for (int x = 0; x < DPL; ++x) acc[i][x] *= 1.f;"),
    "no_l_rescale": ("l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), sum);",
                     "l[i] = __fadd_rn(l[i], sum);"),
    "horizon_off_by_one": ("const bool live = lane < cnt && slot <= horizon[i];",
                           "const bool live = lane < cnt && slot < horizon[i];"),
    "no_k_scale": ("if (KV == KIND_INT8) v = __fmul_rn(v, sc[lane]);", ""),
    "no_v_scale": ("if (KV == KIND_INT8) pw = __fmul_rn(p, sc[TK + lane]);", ""),
    "p_not_rounded": (
        "if (KV == KIND_BF16) pw = __bfloat162float(__float2bfloat16_rn(p));", ""),
    "last_split_not_folded": ("const int live_blocks = min(n_splits, CLUSTER);",
                              "const int live_blocks = max(min(n_splits, CLUSTER) - 1, 1);"),
    "splits_folded_out_of_order": (
        _FOLD_LOOP, _FOLD_LOOP.replace("int c = 0; c < CLUSTER; ++c", "int c = CLUSTER - 1; c >= 0; --c")),
    # a key the row may not see counted as exp(-1e9 - m) (its logit masked as
    # the twin masks it): 0 once the row has a real max, +inf in a tile that
    # opens a split past the row's horizon
    "empty_split_counts": ("const float p = live ? expf(v - m_new) : 0.f;",
                           "const float p = expf((live ? v : -1e9f) - m_new);"),
    "split_boundary_off_by_one": ("const int s_end = min((sp + 1) * SPLIT, n_slots);",
                                  "const int s_end = min((sp + 1) * SPLIT - 1, n_slots);"),
    # a tile read before this thread's copies of it have landed
    "ring_not_waited": ("cp_async_wait<STAGES - 2>();  // this thread's copies of tile k are there",
                        "cp_async_wait<STAGES - 1>();"),
}
# mutants that only move a rounding: below what a bound for bf16 rounding sees
PAGED_ROUNDING_ONLY = ("p_not_rounded",)
# copies of csrc/paged_attention.cu timed by ``--ablate``: two other designs
# (a two-tile ring; blocks without a split wait at the cluster barriers and
# every block folds R / 8 rows) and one part taken out (the arithmetic:
# loads, barriers and the fold alone)
_EXIT = "  if (rank >= n_splits) return;\n"
_FOLD_ROWS = ("  const int my_rows = (R - rank + live_blocks - 1) / live_blocks;\n"
              "  for (int i = tid; i < my_rows * (DH / 4); i += THREADS) {\n"
              "    const int r = rank + live_blocks * (i / (DH / 4)), d = 4 * (i % (DH / 4));")
PAGED_VARIANTS = {
    "as_is": [],
    "stages_2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;", 1)],
    "loads_only": [(_REQUEST, _REQUEST + "\n    continue;", 1)],
    "idle_blocks_wait": [
        (_EXIT, "", 1),
        (_FOLD_ROWS, "  for (int i = tid; i < (R / CLUSTER) * (DH / 4); i += THREADS) {\n"
                     "    const int r = rank + CLUSTER * (i / (DH / 4)), d = 4 * (i % (DH / 4));", 1)],
}
PAGED_HELD = ("as_is", "stages_2", "idle_blocks_wait")  # the variants that must stay right
LINEAR_MUTANTS = {
    "as_is": ("", ""),
    "f32_scale": ("sc[r] = n < N ? __bfloat162float(__float2bfloat16_rn(s[n])) : 0.f;",
                  "sc[r] = n < N ? s[n] : 0.f;"),
    "drop_last_k_tile": ("const int steps = min(KC, K - (c0 + p) * KC) / 16;",
                         "const int steps = c0 + p + 1 == chunks ? 0 "
                         ": min(KC, K - (c0 + p) * KC) / 16;"),
    "scale_of_neighbour_channel": ("const int n = n0 + wg * CH + row + 8 * r;",
                                   "const int n = (n0 + wg * CH + row + 8 * r) ^ 1;"),
    "row_tile_at_wrong_offset": ("tile_desc(xtile + rt * (ROWS * KC * 2)) + 2 * s",
                                 "tile_desc(xtile + rt * (ROWS * KC * 2) + 8 * 128) + 2 * s"),
    "last_split_not_folded": ("for (int p = 1; p < live_splits; ++p) {",
                              "for (int p = 1; p < live_splits - 1; ++p) {"),
    "k_step_not_advanced": ("tile_desc(xtile + rt * (ROWS * KC * 2)) + 2 * s",
                            "tile_desc(xtile + rt * (ROWS * KC * 2))"),
    "weights_unswizzled": ("const int sw = (ch >> 1) & 3;", "const int sw = 0;"),
    "pair_of_the_other_thread": ("0x7440u + 2 * (t & 1)", "0x7440u + 2 * ((t & 1) ^ 1)"),
}
# (M, K, N, output type) of the w8a16 mutants: the q/k/v projection at a decode
# step of 64 and 8 rows, gate/up (two warpgroups a block), the down projection
# at a prefill chunk of 256 rows, and a K that ends in a partial chunk with an
# N that ends in a partial channel tile
LINEAR_CASES = [(64, 2048, 2560, "bf16"), (8, 2048, 2560, "f32"), (64, 2048, 11264, "bf16"),
                (256, 5632, 2048, "bf16"), (24, 2064, 40, "f32")]
# int4: a fault is one edit or more, each keyed by the runs it reaches:
# {label: {runs: (old, new, occurrences)}}, a run being one of "w4a8",
# "w4a16_bf16", "w4a16_f32" (the f32 instantiation has its own decoder and
# loop; the bf16 one shares w4a8's loader). w4a8 is held to bit-equality
# (exact integer group sums, one f32 order), w4a16 to 1e-5 of the output's
# scale plus 1e-5 relative.
_K_LOOP = "for (int k0 = 0; k0 < K; k0 += BK) {"
_BF16_HI = "const uint32_t u = hi ? ((w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u : w & 0x0f0f0f0fu;"
_DECODE4 = ("w4a8", "w4a16_f32")
INT4_MUTANTS = {
    "as_is": {},
    "nibbles_swapped": {
        _DECODE4: ("(hi ? w >> 4 : w) & 0x0f0f0f0fu", "(hi ? w : w >> 4) & 0x0f0f0f0fu", 1),
        ("w4a16_bf16",): (_BF16_HI, _BF16_HI.replace("(w >> 4) & 0x0f0f0f0fu) ^", "w & 0x0f0f0f0fu) ^")
                          .replace(": w & 0x0f0f0f0fu;", ": (w >> 4) & 0x0f0f0f0fu;"), 1)},
    "hi_not_sign_extended": {
        _DECODE4: ("hi ? nib ^ 0x08080808u : nib;", "hi ? nib + 0x08080808u : nib;", 1),
        ("w4a16_bf16",): (_BF16_HI, _BF16_HI.replace(") ^ 0x08080808u", ") + 0x08080808u"), 1)},
    "lo_not_debiased": {
        _DECODE4: ("hi ? nib ^ 0x08080808u : nib;",
                   "hi ? nib ^ 0x08080808u : nib + 0x08080808u;", 1),
        ("w4a16_bf16",): (_BF16_HI, _BF16_HI.replace(": w & 0x0f0f0f0fu;",
                                                     ": (w & 0x0f0f0f0fu) + 0x08080808u;"), 1)},
    "scale_from_next_group": {
        ("w4a8", "w4a16_bf16"): (
            "const int grp = min((slab * W8_HALVES + hh) * 128 / gsz, G - 1);",
            "const int grp = min(((slab * W8_HALVES + hh) * 128 / gsz) ^ 1, G - 1);", 1),
        ("w4a16_f32",): ("out.s = srow[k0 / gsz];", "out.s = srow[(k0 / gsz) ^ 1];", 1)},
    "scale_of_neighbour_channel": {("w4a16_bf16",): (
        "gscale[2 * wc * CB + ch], gscale[(2 * wc + 1) * CB + ch]",
        "gscale[2 * wc * CB + (ch ^ 1)], gscale[(2 * wc + 1) * CB + (ch ^ 1)]", 1)},
    "dropped_k_chunk": {
        ("w4a8",): ("    if (slab * W8_CHUNKS + wc < chunks) {\n"
                    "      const uint8_t* wsm = slot + (wh * 16 + g) * W8_WROW + 128 * wc + 16 * t;\n"
                    "      const uint8_t* xsm",
                    "    if (slab * W8_CHUNKS + wc < chunks && wc != 1) {\n"
                    "      const uint8_t* wsm = slot + (wh * 16 + g) * W8_WROW + 128 * wc + 16 * t;\n"
                    "      const uint8_t* xsm", 1),
        ("w4a16_bf16",): ("    if (wc < cs) {", "    if (wc < cs && wc != 1) {", 1),
        ("w4a16_f32",): (_K_LOOP, _K_LOOP.replace("k0 < K;", "k0 < K - BK;"), 1)},
    # the last slab's sums when it is partial (K % 2,048 != 0): never folded
    "partial_slab_dropped": {("w4a16_bf16",): (
        "for (int w = 0; w < parts; ++w) fsum[i]", "for (int w = 0; w < 0; ++w) fsum[i]", 1)},
    "group_out_of_order": {
        ("w4a8",): ("for (int hh = 0; hh < W8_HALVES; ++hh) fold(hh);",
                    "for (int hh = W8_HALVES - 1; hh >= 0; --hh) fold(hh);", 1),
        ("w4a8", "partial slab"): ("for (int hh = 0; hh < hn; ++hh) fold(hh);",
                                   "for (int hh = hn - 1; hh >= 0; --hh) fold(hh);", 1)},
    "row_scale_of_wrong_row": {("w4a8",): (
        "const float val = __fmul_rn(fsum[i], rscale[r]);",
        "const float val = __fmul_rn(fsum[i], rscale[r ^ 1]);", 1)},
    "quantizer_rounds_half_up": {("w4a8",): (
        "rintf(__fdiv_rn(v[4 * i + b], s))", "floorf(__fdiv_rn(v[4 * i + b], s) + 0.5f)", 1)},
    "quantizer_multiplies_by_reciprocal": {("w4a8",): (
        "const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);",
        "const float s = fmaxf(__fmul_rn(amax, 1.f / 127.f), 1e-12f);", 1)},
}


# the float scan: {label: ({file: [(old, new, occurrences)]}, modes it reaches)};
# topk_float.cu and the headers of its score pass (topk_float_tile.cuh) and
# selection (topk_common.cuh)
_TILE, _SCAN, _COMMON = "topk_float_tile.cuh", "topk_float.cu", "topk_common.cuh"
_DOT = "return COMP ? __fadd_rn(__fadd_rn(run[j][e], hl[j][e]), lh[j][e]) : run[j][e];"
_CHUNK_END = "end = begin + rows_per_chunk < N ? begin + rows_per_chunk : N;"
_PRODUCT = "acc.product(ring + slot * slot_bytes<MODE>(), min(S::DC, sc.D - ds * S::DC) / 16);"
_ALL = ("fp32", "bf16", "f32x2")
TOPK_MUTANTS = {
    "as_is": ({}, _ALL),
    # the last 16-dimension step of every tile's dimensions never multiplied
    "last_k_step_dropped": ({_TILE: [(_PRODUCT, _PRODUCT.replace("/ 16);", "/ 16 - (ds == slabs - 1));"), 1)]},
                            ("bf16", "f32x2")),
    "lo_hi_dropped": ({_TILE: [(_DOT, _DOT.replace("__fadd_rn(__fadd_rn(run[j][e], hl[j][e]), lh[j][e])",
                                                   "__fadd_rn(run[j][e], hl[j][e])"), 1)]}, ("f32x2",)),
    "hi_lo_dropped": ({_TILE: [(_DOT, _DOT.replace("__fadd_rn(__fadd_rn(run[j][e], hl[j][e]), lh[j][e])",
                                                   "__fadd_rn(run[j][e], lh[j][e])"), 1)]}, ("f32x2",)),
    "penalty_not_added": ({_SCAN: [("row < row_end ? __fadd_rn(dot, penalty[row]) : NEG;",
                                    "row < row_end ? dot : NEG;", 1)]}, _ALL),
    "last_row_of_chunk_skipped": ({_TILE: [(_CHUNK_END, _CHUNK_END.replace(" : N;", " : N;\n  --end;"), 1)]},
                                  _ALL),
    # the tile-max test against entry k - 1 of the list's 0 .. k - 1 taken as
    # entry k - 2, and a tie let in
    "tile_max_test_wrong_slot": ({_COMMON: [("k - 1 < 32 ? L.x[0].v : L.x[1].v, (k - 1) & 31",
                                             "k - 2 < 32 ? L.x[0].v : L.x[1].v, (k - 2) & 31", 1),
                                            ("unsigned win = __ballot_sync(0xffffffffu, va > kth[b]);",
                                             "unsigned win = __ballot_sync(0xffffffffu, va >= kth[b]);", 1)]},
                                 _ALL),
    # slab s read with one group fewer waited for: the block's first slab is
    # read right after it was requested
    "ring_not_waited": ({_TILE: [("cp_async_wait<STAGES - 2>();  // this thread's copies of slab s are there",
                                  "cp_async_wait<STAGES - 1>();", 1)]}, _ALL),
}


# the int8 scan: {label: {file: [(old, new, occurrences)]}}; topk_int8.cu and
# the headers it shares with the float scan
_INT8 = "topk_int8.cu"
_SCALED = "__fmul_rn(__fmul_rn(__int2float_rn(dot), csc), qsc[qq])"
_EPILOGUE = f"s = __fadd_rn({_SCALED}, penalty[row]);"
TOPK_INT8_MUTANTS = {
    "as_is": {},
    "scales_swapped": {_INT8: [(_SCALED, "__fmul_rn(__fmul_rn(__int2float_rn(dot), qsc[qq]), csc)", 1)]},
    # exact below 2^24, so only the wide case (D = 4,096) can see it
    "int2float_rz": {_INT8: [(_SCALED, _SCALED.replace("_rn(dot)", "_rz(dot)"), 1)]},
    "cscale_dropped": {_INT8: [(_SCALED, "__fmul_rn(__int2float_rn(dot), qsc[qq])", 1)]},
    "penalty_dropped": {_INT8: [(_EPILOGUE, f"s = {_SCALED};", 1)]},
    # the last 32-byte k-step of every tile's dimensions never multiplied
    "last_k_step_dropped": {_TILE: [(_PRODUCT, _PRODUCT.replace("/ 16);", "/ 16 - 2 * (ds == slabs - 1));"),
                                     1)]},
    "last_row_of_chunk_skipped": {_TILE: [(_CHUNK_END, _CHUNK_END.replace(" : N;", " : N;\n  --end;"), 1)]},
    # the k-th value a score must beat read from entry k - 2 of the list
    "kth_slot_read_one_early": {_COMMON: [("k - 1 < 32 ? L.x[0].v : L.x[1].v, (k - 1) & 31",
                                           "k - 2 < 32 ? L.x[0].v : L.x[1].v, (k - 2) & 31", 1)]},
    "ring_not_waited": TOPK_MUTANTS["ring_not_waited"][0],
}


# copies of the int8 scan with a part taken out, timed by ``--ablate
# topk_int8``: {variant: {file: [(old, new, occurrences)]}}
_OFFER = "    sel.offer<TN, TN + STW>(st, buf_v, buf_i, tile, live, K);\n"
INT8_VARIANTS = {
    "as_is": {},
    "no_selection": {_INT8: [(_OFFER, "", 1)]},
    "no_products": {_TILE: [(_PRODUCT, "", 1)]},
    "loads_only": {_INT8: [(_OFFER, "", 1)], _TILE: [(_PRODUCT, "", 1)]},
}
INT8_HELD = ("as_is",)  # the variants held to the twin


def _edited(text: str, edits, name: str) -> str:
    for old_text, new_text, count in edits:
        if text.count(old_text) != count:
            raise RuntimeError(
                f"{name}: the line to mutate occurs {text.count(old_text)} times, not {count}")
        text = text.replace(old_text, new_text)
    return text


def build_mutant(tmp: Path, source: Path, name: str, old, new: str = "", symbol: str | None = None,
                 headers: dict | None = None):
    """Build a copy of ``source`` with ``old`` replaced by ``new`` (or with
    every ``(old, new, occurrences)`` edit of a list) into a library of its
    own; returns its ``symbol``, or the library. ``headers`` maps a header
    of ``csrc/`` to a list of edits of its own: the copy is then built in a
    directory of its own beside copies of every header, edited or not, and
    its quoted includes find those first."""
    edits = old if isinstance(old, list) else ([(old, new, 1)] if old else [])
    text = _edited(source.read_text(), edits, name)
    work = tmp
    if headers:
        work = tmp / name
        work.mkdir(exist_ok=True)
        for header in _build.CSRC_DIR.glob("*.cuh"):
            (work / header.name).write_text(
                _edited(header.read_text(), headers.get(header.name, []), name))
    cu, so = work / f"{source.stem}_{name}.cu", work / f"{source.stem}_{name}.so"
    cu.write_text(text)
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
           "-I", str(_build.CSRC_DIR), "-shared", "-o", str(so), str(cu)]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{run.stderr}")
    lib = ctypes.CDLL(str(so))
    return getattr(lib, symbol) if symbol else lib


def ablate(source: Path, variants: dict, install, runs, held_to_the_twin) -> None:
    """Time copies of ``source``, each with one variant's edits
    (``{variant: [(old, new, occurrences)]}``), through the package's
    wrapper; prints one JSON line a variant. ``install(lib)`` binds a
    variant's library in the wrapper, and ``install(None)`` the package's own
    again. ``runs`` holds ``(label, call, check)``: ``call()`` launches the
    wrapper once and is timed as ``device_ms`` (``tools/timing.py``), and
    ``check()`` says whether its result is within the twin's bound; only the
    variants in ``held_to_the_twin`` are checked, since one without a part of
    its work computes a wrong result and is read for its time alone."""
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, edits in variants.items():
                if isinstance(edits, dict):  # {file: edits}, the source's and its headers'
                    headers = {h: e for h, e in edits.items() if h != source.name}
                    install(build_mutant(Path(tmp), source, name, edits.get(source.name, []),
                                         headers=headers or None))
                else:
                    install(build_mutant(Path(tmp), source, name, edits))
                row = {"variant": name}
                for label, call, check in runs:
                    if name in held_to_the_twin:
                        row[f"ok_{label}"] = check()
                    row[label] = cuda_ms_many(call)["device_ms"]
                print(json.dumps(row), flush=True)
    finally:
        install(None)


def int4_mutants(tmp: Path, dev, g) -> int:
    """Every int4 mutant through ``w4a8_matmul`` (which runs the row quantizer
    too) and ``w4a16_matmul`` (bf16 and f32) at M = 32, at two TinyLlama
    projections with groups of 128 (the down projection's K = 5,632 ends in a
    partial slab) and at a small shape with groups of 256 (the neighbouring
    group's scale is another one there); the bounds are
    chip_smoke.py's: w4a8 bit-equal to its twin, w4a16 within 1e-5 of the
    output's scale plus 1e-5 relative. A mutant is run through the kernels its
    fault is in. The two quantizer mutants differ from the twin only on a row
    that holds an exact .5 tie, or whose maximum over 127 is not the product
    with f32(1/127): rows 2 and 3 of the activations are such rows. Returns
    the number of unexpected verdicts."""
    m = int4_linear_module
    cases = []
    for k, n, gsz in ((2048, 2560, 128), (512, 384, 256), (5632, 2048, 128)):
        q4, s4 = m.quantize_int4_weight(torch.randn((k, n), generator=g, device=dev) * 0.02, gsz)
        cases.append((k, n, gsz, quantizer_rows(dev, g, 32, k, torch.float32), q4, s4))
    names = ("quant_rows", "w4a8", "w4a16")
    real = {which: m._launcher(which) for which in names}
    unexpected = 0
    for name, faults in INT4_MUTANTS.items():
        edits = list(faults.values())
        affected = {label for labels in faults for label in labels}
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
                if faults and label not in affected:
                    continue  # the fault is in another kernel
                if name == "group_out_of_order" and k // gsz <= 2:
                    continue  # two groups add to the same sum in either order
                if name == "partial_slab_dropped" and k % 2048 == 0:
                    continue  # no partial slab at this K
                e = scaled_errors(out, plain)
                ok = bool(torch.equal(out, plain)) if label == "w4a8" else e["worst_vs_bound"] <= 1.0
                # a neighbouring group's scale is the same fault at every gsz;
                # all mutants must fail at every shape
                unexpected += ok != (name == "as_is")
                print(f"int4 {label:10s} {name:34s} K={k:4d} N={n:4d} gsz={gsz:3d} passes={ok} "
                      f"worst_vs_bound={e['worst_vs_bound']:.3g}", flush=True)
    m._launch_fns.update(real)
    return unexpected


def flash_mutants(tmp: Path, dev, g) -> int:
    """Every flash mutant through ``flash_attention`` in bf16 at H = 16: S =
    2,048 unmasked, and a B = 2 batch at S = 4,096 with a 3,000-token row and
    a row of no live key, under chip_smoke.py's bounds (each element within
    2e-3 + 2 bf16 ulps of the twin's, error norm within 1e-2 of the
    output's). Returns the number of unexpected verdicts."""
    m = attention_module
    cases = []
    for b, s, lengths in ((1, 2048, [2048]), (2, 4096, [3000, 0])):
        q, k, v = (torch.randn((b, s, 16, 64), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        bias = torch.full((b, s), m.NEG_BIAS, device=dev)
        for i, n in enumerate(lengths):
            bias[i, :n] = 0.0
        cases.append((q, k, v, bias))
    plains = [m.flash_attention_plain(*args) for args in cases]
    real = m._launcher()
    atol, ulps, rms = FLASH_BOUNDS
    unexpected = 0
    for name, (old, new) in FLASH_MUTANTS.items():
        fn = build_mutant(tmp, _build.CSRC_DIR / "flash_attention.cu", name, old, new,
                          "flash_attention_launch")
        fn.argtypes, fn.restype = real.argtypes, real.restype
        m._launch_fn = fn
        for args, plain in zip(cases, plains):
            out = m.flash_attention(*args)
            torch.cuda.synchronize()
            e = flash_errors(out, plain, atol, ulps)
            ok = e["worst_vs_bound"] <= 1.0 and e["rel_rms_err"] <= rms
            if name == "padding_not_masked" and bool((args[3] == 0).all()):
                continue  # no padding in this case
            unexpected += ok != (name == "as_is")
            print(f"flash_attention {name:19s} B={args[0].shape[0]} S={args[0].shape[1]:4d} "
                  f"passes={ok} worst_vs_bound={e['worst_vs_bound']:.3g} "
                  f"rel_rms_err={e['rel_rms_err']:.3g}", flush=True)
    m._launch_fn = real
    return unexpected


def paged_mutants(tmp: Path, dev, g) -> int:
    """Every paged-attention mutant on a bf16 and an int8 pool at the
    decoder's shapes (B = 64 decode at row lengths 1-2,047 and with every
    row at the capacity, where the memory is busiest; a 256-token prefill
    chunk from 512), a speculative window (B = 8, T = 4) and a prefill chunk
    from 254 whose query tiles straddle a split boundary (rows whose horizon
    lies before a split their tile walks), each under chip_smoke.py's bound;
    and the fold-order row of ``paged_order_case``, which must be exact."""
    window = [253, 254, 255, 509, 510, 511, 1021, 2044]
    cases = {kv: [paged_attention_case(dev, g, 64, 1, kv),
                  paged_attention_case(dev, g, 64, 1, kv, pos=[2047] * 64),
                  paged_attention_case(dev, g, 1, 256, kv, pos=[512]),
                  paged_attention_case(dev, g, 8, 4, kv, pos=window),
                  paged_attention_case(dev, g, 1, 256, kv, pos=[254])]
             for kv in PAGED_BOUNDS}
    plains = {kv: [paged_module.paged_attention_plain(*a) for a in cases[kv]] for kv in cases}
    orders = {kv: paged_order_case(dev, kv) for kv in PAGED_BOUNDS}
    paged_module._launcher("attention")  # bind the real library first, then swap one entry
    real = paged_module._launch_fns["attention"]
    unexpected = 0
    for name, (old, new) in PAGED_MUTANTS.items():
        fn = build_mutant(tmp, _build.CSRC_DIR / "paged_attention.cu", name, old, new,
                          "paged_attention_launch")
        fn.argtypes, fn.restype = real.argtypes, real.restype
        paged_module._launch_fns["attention"] = fn
        for kv, (atol, ulps, rms) in PAGED_BOUNDS.items():
            if name in ("no_k_scale", "no_v_scale") and kv != "int8":
                continue  # the fault is in code a bf16 pool never runs
            verdicts = []
            for args, plain in zip(cases[kv], plains[kv]):
                out = paged_module.paged_attention(*args)
                torch.cuda.synchronize()
                e = flash_errors(out, plain, atol, ulps)
                ok = e["worst_vs_bound"] <= 1.0 and e["rel_rms_err"] <= rms
                verdicts.append(ok)
                print(f"paged_attention {name:26s} {kv:4s} B={args[0].shape[0]:2d} "
                      f"T={args[0].shape[1]:3d} pos0={int(args[4][0]):4d} passes={ok} "
                      f"worst_vs_bound={e['worst_vs_bound']:.3g} "
                      f"rel_rms_err={e['rel_rms_err']:.3g}", flush=True)
            args, want = orders[kv]
            out = paged_module.paged_attention(*args)
            torch.cuda.synchronize()
            ok = bool((out.float() == want).all())
            verdicts.append(ok)
            print(f"paged_attention {name:26s} {kv:4s} fold order exact={ok} "
                  f"got={float(out.float().flatten()[0])!r} want={want!r}", flush=True)
            # a mutant fails if any case catches it; as_is must pass every case
            caught = not all(verdicts)
            expect_caught = name not in ("as_is", *PAGED_ROUNDING_ONLY)
            unexpected += caught != expect_caught
    paged_module._launch_fns["attention"] = real
    return unexpected


def paged_ablation(dev, g) -> None:
    """Each of ``PAGED_VARIANTS`` timed through ``paged_attention`` at the
    decoder's three shapes (B = 64, T = 1 at row lengths 1-2,047; B = 8,
    T = 4; B = 1, T = 256 from 512) on a bf16 and an int8 pool; the variants
    of ``PAGED_HELD`` are also held to the twin under chip_smoke.py's bound."""
    m = paged_module
    m._launcher("attention")
    real = m._launch_fns["attention"]

    def install(lib):
        fn = real if lib is None else lib.paged_attention_launch
        fn.argtypes, fn.restype = real.argtypes, real.restype
        m._launch_fns["attention"] = fn

    runs = []
    for kv, (atol, ulps, rms) in PAGED_BOUNDS.items():
        lens = torch.randint(1, 2048, (64,), generator=g, device=dev)
        for label, (b, t, pos) in (("b64_t1", (64, 1, lens - 1)), ("b8_t4", (8, 4, None)),
                                   ("b1_t256_512", (1, 256, [512]))):
            args = paged_attention_case(dev, g, b, t, kv, pos=pos)
            plain = m.paged_attention_plain(*args)

            def check(args=args, plain=plain, atol=atol, ulps=ulps, rms=rms):
                e = flash_errors(m.paged_attention(*args), plain, atol, ulps)
                return e["worst_vs_bound"] <= 1.0 and e["rel_rms_err"] <= rms

            runs.append((f"{kv}_{label}", lambda args=args: m.paged_attention(*args), check))
    ablate(_build.CSRC_DIR / "paged_attention.cu", PAGED_VARIANTS, install, runs, PAGED_HELD)


def int8_ablation(dev, g) -> None:
    """Each of ``INT8_VARIANTS`` timed through ``topk_int8`` over a seeded
    1,048,576 x 1024 corpus (1% rows tombstoned) at B = 32 and 128, K = 64,
    and at B = 32, K = 12; the variants of ``INT8_HELD`` are also held
    bit-equal to the twin."""
    m = topk_module
    real = m._launcher()

    def install(lib):
        fn = real if lib is None else lib.topk_int8_launch
        fn.argtypes, fn.restype = real.argtypes, real.restype
        m._launch_fn = fn

    n, d = 1 << 20, 1024
    corpus = torch.randint(-127, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
    cscale = (torch.rand(n, generator=g, device=dev) + 0.5) / 127
    penalty = torch.where(torch.rand(n, generator=g, device=dev) < 0.01, m.NEG, 0.0).float()
    runs = []
    for b, k in ((32, 64), (128, 64), (32, 12)):
        q = torch.randint(-127, 128, (b, d), generator=g, device=dev, dtype=torch.int8)
        qscale = (torch.rand(b, generator=g, device=dev) + 0.5) / 127
        args = (q, qscale, corpus, cscale, k, penalty)
        plain = m.topk_int8_plain(*args)

        def check(args=args, plain=plain):
            vals, idx = m.topk_int8(*args)
            return bool(torch.equal(vals, plain[0]) and torch.equal(idx, plain[1]))

        runs.append((f"b{b}_k{k}", lambda args=args: m.topk_int8(*args), check))
    ablate(_build.CSRC_DIR / _INT8, INT8_VARIANTS, install, runs, INT8_HELD)


ABLATIONS = {"paged_attention": paged_ablation, "topk_int8": int8_ablation}


def linear_mutants(tmp: Path, dev, g) -> int:
    """Every w8a16 linear mutant at each of ``LINEAR_CASES``, under the bound
    of ``chip_smoke.py`` and the card tests: 1e-5 of the output's scale, plus
    one ulp for a bf16 output. Every mutant but ``as_is`` must fail in every
    case."""
    m = int8_linear_module
    cases = []
    for rows, k, n, out in LINEAR_CASES:
        x = torch.randn((rows, k), generator=g, device=dev).to(
            torch.bfloat16 if out == "bf16" else torch.float32)
        q, s = m.quantize_linear_weight(torch.randn((k, n), generator=g, device=dev) * 0.02)
        cases.append((x, q, s, m.int8_linear_plain(x, q, s)))
    real = m._launcher()
    unexpected = 0
    for name, (old, new) in LINEAR_MUTANTS.items():
        fn = build_mutant(tmp, _build.CSRC_DIR / "int8_linear.cu", name, old, new,
                          "int8_linear_launch")
        fn.argtypes, fn.restype = real.argtypes, real.restype
        m._launch_fn = fn
        for x, q, s, plain in cases:
            out = m.int8_linear(x, q, s)
            torch.cuda.synchronize()
            ulps = 1.0 if x.dtype == torch.bfloat16 else 0.0
            e = flash_errors(out, plain, 1e-5 * float(plain.abs().max()), ulps)
            ok = e["worst_vs_bound"] <= 1.0
            unexpected += ok != (name == "as_is")
            print(f"int8_linear     {name:26s} M={x.shape[0]:3d} K={x.shape[1]:4d} "
                  f"N={q.shape[0]:5d} {str(x.dtype)[6:]:8s} passes={ok} "
                  f"worst_vs_bound={e['worst_vs_bound']:.3g} rel_rms_err={e['rel_rms_err']:.3g}",
                  flush=True)
    m._launch_fn = real
    return unexpected


def float_scan_case(dev, g, n: int, d: int, b: int, mode: str, copies: list[int]):
    """Unit rows in ``mode``'s storage, 1% tombstoned, and ``copies`` of one
    row (the first of them is the original); query 0 is that row, so the
    copies tie at its top. Returns (queries, corpus, penalty)."""
    corpus = torch.nn.functional.normalize(torch.randn((n, d), generator=g, device=dev), dim=1)
    corpus[copies] = corpus[copies[0]].clone()
    penalty = torch.where(torch.rand(n, generator=g, device=dev) < 0.01, topk_module.NEG, 0.0)
    penalty[copies] = 0.0
    q = torch.nn.functional.normalize(torch.randn((b, d), generator=g, device=dev), dim=1)
    q[0] = corpus[copies[0]]
    store = {"fp32": lambda x: x, "bf16": lambda x: x.to(torch.bfloat16),
             "f32x2": topk_module.split_f32_bf16x2}[mode]
    return store(q), store(corpus), penalty.float()


def float_threshold_case(dev, g, mode: str):
    """256 rows x 128, one chunk, K = 4: query 0 is the first axis and row
    i scores exactly its first element, 1, 15/16, 7/8 and 13/16 for rows 0-3,
    under 1/2 for the others but row 100, which scores 27/32: once the first
    64 rows fill a list, row 100 must still beat its 4th entry (13/16) and
    come out 4th. Returns (queries, corpus, penalty, k, the rows query 0
    must get)."""
    n, d, b = 256, 128, 8
    corpus = torch.randn((n, d), generator=g, device=dev) / 16
    corpus[:, 0] = (torch.arange(n, device=dev) % 7).float() / 16
    corpus[:4, 0] = torch.tensor([1.0, 15 / 16, 7 / 8, 13 / 16], device=dev)
    corpus[100, 0] = 27 / 32
    q = torch.nn.functional.normalize(torch.randn((b, d), generator=g, device=dev), dim=1)
    q[0] = 0.0
    q[0, 0] = 1.0
    store = {"fp32": lambda x: x, "bf16": lambda x: x.to(torch.bfloat16),
             "f32x2": topk_module.split_f32_bf16x2}[mode]
    return store(q), store(corpus), torch.zeros(n, device=dev), 4, [0, 1, 2, 100]


def topk_mutants(tmp: Path, dev, g) -> int:
    """Every float-scan mutant through ``topk_float`` in the modes it reaches,
    under the check of ``chip_smoke.py`` and the card tests: values within
    1e-5 of the twin's, no tie-aware mismatch, and query 0's first rows as
    the case wants them (the copies of its row tied bit for bit, lowest row
    first). Cases: 200,003 rows x 1024 at B = 33,
    K = 64, with copies at positions 0, 7, 8 and 15 of an MMA fragment, in a
    second warp, across a tile edge and across the edge of chunk 0; 256 rows x
    96 at B = 8, K = 64, one chunk (its list is the result), D not a multiple
    of a 64-dimension slab; 20,000 rows x 1056 at B = 128, K = 12; and 256
    rows x 128 at B = 33, K = 4, one chunk, where a list's k-th entry is the
    result's; and ``float_threshold_case``. The L2 cache is overwritten
    before each launch."""
    m = topk_module
    shapes = [(200_003, 1024, 33, 64), (256, 96, 8, 64), (20_000, 1056, 128, 12), (256, 128, 33, 4)]
    cases = {}
    for mode in _ALL:
        for n, d, b, k in shapes:
            chunk = m._float_kernel_plan(b, n, dev, mode)[1]
            copies = sorted(r for r in {0, 7, 8, 15, 16 + 3, 127, 128, 255, chunk - 1, chunk} if r < n)
            q, c, pen = float_scan_case(dev, g, n, d, b, mode, copies)
            pv, pi = m.topk_float_plain(q, c, k + 1, pen, mode)
            cases.setdefault(mode, []).append((q, c, pen, k, copies, True, pv, pi))
        q, c, pen, k, want = float_threshold_case(dev, g, mode)
        pv, pi = m.topk_float_plain(q, c, k + 1, pen, mode)
        cases[mode].append((q, c, pen, k, want, False, pv, pi))
    # written before each launch: the kernel finds its rows in device memory,
    # not in the L2 cache, so a slot read before its copies land shows
    flush_l2 = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    real = m._float_launcher()
    unexpected = 0
    for name, (headers, modes) in TOPK_MUTANTS.items():
        fn = build_mutant(tmp, _build.CSRC_DIR / _SCAN, name, headers.get(_SCAN, []),
                          symbol="topk_float_launch",
                          headers={h: e for h, e in headers.items() if h != _SCAN} or {_TILE: []})
        fn.argtypes, fn.restype = real.argtypes, real.restype
        m._float_launch_fn = fn
        caught = False
        for mode in modes:
            for q, c, pen, k, rows, tie, pv, pi in cases[mode]:
                flush_l2.zero_()
                vals, idx = m.topk_float(q, c, k, pen, mode)
                torch.cuda.synchronize()
                err = float((vals - pv[:, :k]).abs().max())
                mism = tie_aware_mismatches(vals, idx, pv, pi, 1e-5)
                head = min(k, len(rows))
                first = (idx[0, :head].tolist() == rows[:head]
                         and (not tie or bool((vals[0, :head] == vals[0, 0]).all())))
                ok = err <= 1e-5 and mism == 0 and first
                caught |= not ok
                print(f"topk_float      {name:26s} {mode:5s} N={c.shape[0]:6d} D={q.shape[1]:4d} "
                      f"B={q.shape[0]:3d} K={k:2d} passes={ok} max_abs_err={err:.3g} "
                      f"mismatches={mism} query0_rows={first}", flush=True)
        unexpected += caught != (name != "as_is")
    m._float_launch_fn = real
    return unexpected


def int8_scan_case(dev, g, n: int, d: int, b: int, copies: list[int]):
    """Seeded int8 codes and scales, 1% rows tombstoned, and ``copies`` of
    one row (the first of them is the original) at the largest row scale;
    query 0 is that row, so the copies tie at its top. Returns the wrapper's
    arguments but K: (queries, query scales, corpus, row scales, penalty)."""
    corpus = torch.randint(-127, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
    cscale = (torch.rand(n, generator=g, device=dev) + 0.5) / 127
    penalty = torch.where(torch.rand(n, generator=g, device=dev) < 0.01, topk_module.NEG, 0.0)
    corpus[copies] = corpus[copies[0]].clone()
    cscale[copies] = 1.5 / 127
    penalty[copies] = 0.0
    q = torch.randint(-127, 128, (b, d), generator=g, device=dev, dtype=torch.int8)
    q[0] = corpus[copies[0]]
    qscale = (torch.rand(b, generator=g, device=dev) + 0.5) / 127
    return q, qscale, corpus, cscale, penalty.float()


def int8_threshold_case(dev, g):
    """``float_threshold_case`` in codes: 256 rows x 128, one chunk, K = 4,
    every scale 1. Query 0 is 127 on the first axis, so row i scores 127
    times its first code: 127, 120, 112 and 104 for rows 0-3, at most 48 for
    the others but row 100, with 108: once the first 64 rows fill a list,
    row 100 must still beat its 4th entry and come out 4th. Returns (the
    wrapper's arguments but K, k, the rows query 0 must get)."""
    n, d, b = 256, 128, 8
    corpus = torch.randint(-8, 9, (n, d), generator=g, device=dev, dtype=torch.int8)
    corpus[:, 0] = ((torch.arange(n, device=dev) % 7) * 8).to(torch.int8)
    corpus[:4, 0] = torch.tensor([127, 120, 112, 104], device=dev, dtype=torch.int8)
    corpus[100, 0] = 108
    q = torch.randint(-127, 128, (b, d), generator=g, device=dev, dtype=torch.int8)
    q[0] = 0
    q[0, 0] = 127
    ones = torch.ones(n, device=dev)
    return (q, torch.ones(b, device=dev), corpus, ones, torch.zeros(n, device=dev)), 4, [0, 1, 2, 100]


def int8_wide_case(dev, g):
    """3,000 rows x 4,096 (wider than the plain twin's exact 1,040), B = 8,
    K = 64: every row a copy of one row of large codes (100-127 in size)
    moved by up to 20, and query 0 that row, so its int32 sums pass 2^24
    and converting them to f32 rounds. Returns the wrapper's arguments but
    K."""
    n, d, b = 3000, 4096, 8
    sign = torch.randint(0, 2, (d,), generator=g, device=dev) * 2 - 1
    base = sign * torch.randint(100, 128, (d,), generator=g, device=dev)
    noise = torch.randint(-20, 21, (n, d), generator=g, device=dev)
    corpus = (base + noise).clamp(-127, 127).to(torch.int8)
    cscale = (torch.rand(n, generator=g, device=dev) + 0.5) / 127
    q = torch.randint(-127, 128, (b, d), generator=g, device=dev, dtype=torch.int8)
    q[0] = base.to(torch.int8)
    qscale = (torch.rand(b, generator=g, device=dev) + 0.5) / 127
    return q, qscale, corpus, cscale, torch.zeros(n, device=dev)


def int8_exact_topk(q_queries, q_scale, corpus, c_scale, k, penalty):
    """The int8 scan's function at any width: the int32 dot in float64
    (exact), rounded once to f32, then ``topk_int8_plain``'s order and
    selection. Equals the twin wherever the twin is exact (D <= 1,040)."""
    raw = (q_queries.double() @ corpus.double().T).float()
    scores = raw * c_scale[None, :] * q_scale[:, None] + penalty[None, :]
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
    dead = vals <= topk_module.NEG / 2
    return vals.masked_fill(dead, topk_module.NEG), idx.masked_fill(dead, 0)


def topk_int8_mutants(tmp: Path, dev, g) -> int:
    """Every int8-scan mutant through ``topk_int8``, under the check of
    ``chip_smoke.py`` and the card tests: values and rows bit-equal to the
    twin's, and query 0's first rows as the case wants them. Cases: 200,003
    rows x 1024 at B = 33, K = 64, with copies at positions 0, 7, 8 and 15
    of an MMA fragment, in a second warp, across a tile edge and across the
    edge of chunk 0; 256 rows x 96 at B = 8, K = 64, one chunk (its list is
    the result), D not a multiple of a 128-byte slab; 20,000 rows x 1040
    (half a last k-step) at B = 128, K = 12; 256 rows x 48 at B = 33, K = 4,
    one chunk; ``int8_threshold_case``; and ``int8_wide_case``, held to
    ``int8_exact_topk``. The L2 cache is overwritten before each launch."""
    m = topk_module
    cases = []
    for n, d, b, k in [(200_003, 1024, 33, 64), (256, 96, 8, 64), (20_000, 1040, 128, 12),
                       (256, 48, 33, 4)]:
        chunk = m._int8_kernel_plan(b, n, dev)[1]
        copies = sorted(r for r in {0, 7, 8, 15, 16 + 3, 127, 128, 255, chunk - 1, chunk} if r < n)
        args = int8_scan_case(dev, g, n, d, b, copies)
        cases.append((args, k, copies, m.topk_int8_plain(*args[:4], k, args[4])))
    args, k, want = int8_threshold_case(dev, g)
    cases.append((args, k, want, m.topk_int8_plain(*args[:4], k, args[4])))
    args = int8_wide_case(dev, g)
    cases.append((args, 64, None, int8_exact_topk(*args[:4], 64, args[4])))
    flush_l2 = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    real = m._launcher()
    unexpected = 0
    for name, files in TOPK_INT8_MUTANTS.items():
        fn = build_mutant(tmp, _build.CSRC_DIR / _INT8, f"int8_{name}", files.get(_INT8, []),
                          symbol="topk_int8_launch",
                          headers={h: e for h, e in files.items() if h != _INT8} or {_TILE: []})
        fn.argtypes, fn.restype = real.argtypes, real.restype
        m._launch_fn = fn
        caught = False
        for args, k, rows, (pv, pi) in cases:
            flush_l2.zero_()
            vals, idx = m.topk_int8(*args[:4], k, args[4])
            torch.cuda.synchronize()
            bit_equal = bool(torch.equal(vals, pv) and torch.equal(idx, pi))
            first = rows is None or idx[0, : min(k, len(rows))].tolist() == rows[:k]
            ok = bit_equal and first
            caught |= not ok
            q, c = args[0], args[2]
            print(f"topk_int8       {name:26s} N={c.shape[0]:6d} D={q.shape[1]:4d} B={q.shape[0]:3d} "
                  f"K={k:2d} passes={ok} bit_equal={bit_equal} "
                  f"max_abs_err={float((vals - pv).abs().max()):.3g} query0_rows={first}", flush=True)
        unexpected += caught != (name != "as_is")
    m._launch_fn = real
    return unexpected


KERNELS = {"paged_attention": paged_mutants, "int8_linear": linear_mutants,
           "int4": int4_mutants, "flash_attention": flash_mutants,
           "topk_float": topk_mutants, "topk_int8": topk_int8_mutants}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_mutants: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if argv[:1] == ["--ablate"] and len(argv) == 2 and argv[1] in ABLATIONS:
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", torch.cuda.current_device())
        ABLATIONS[argv[1]](dev, torch.Generator(device=dev).manual_seed(1))
        return 0
    chosen = argv or list(KERNELS)
    if set(chosen) - set(KERNELS):
        print(f"kernel_mutants: choose among {', '.join(KERNELS)}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(1)
    with tempfile.TemporaryDirectory() as tmp_name:
        unexpected = sum(KERNELS[kernel](Path(tmp_name), dev, g) for kernel in chosen)
    print(f"unexpected verdicts: {unexpected}")
    return 1 if unexpected else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
