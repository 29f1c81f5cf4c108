"""The port's CUDA kernels on the card, held to their plain PyTorch twins.

These tests need an NVIDIA GPU (sm_90a) with ``nvcc``; elsewhere they skip.
This file imports no jax, so it runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from outline_rag_tpu_torch.ops import _build
from outline_rag_tpu_torch.ops.attention import NEG_BIAS, flash_attention, flash_attention_plain
from outline_rag_tpu_torch.ops.topk import (
    NEG,
    split_f32_bf16x2,
    topk_float,
    topk_float_plain,
    topk_int8,
    topk_int8_plain,
)
from outline_rag_tpu_torch.testing import (
    flash_errors,
    paged_attention_case,
    paged_order_case,
    split_boundary_mismatches,
    tie_aware_mismatches,
)

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain twins run true fp32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def test_kernel_library_builds(cuda):
    built = _build.build_library()
    assert built.path.exists()
    lib = _build.load_library()
    for name in ("topk_int8_launch", "topk_float_launch", "flash_attention_launch",
                 "paged_attention_launch", "paged_kv_write_launch", "int8_linear_launch",
                 "int4_quant_rows_launch", "int4_w4a8_launch", "int4_w4a16_launch",
                 "int4_stream_floor_launch",
                 "topk_floor_launch"):
        assert getattr(lib, name) is not None


def _case(dev, n, d, b, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    corpus = torch.randint(-127, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
    cscale = (torch.rand(n, generator=g, device=dev) + 0.5) / 127
    cscale[0] = 1.5 / 127  # row 0 (and its copies) tops query 0 at any width
    penalty = torch.where(torch.rand(n, generator=g, device=dev) < 0.01, NEG, 0.0)
    dups = torch.randperm(n - 1, generator=g, device=dev)[:9] + 1
    corpus[dups] = corpus[0].clone()
    cscale[dups] = cscale[0].clone()
    penalty[dups] = 0.0
    penalty[0] = 0.0
    q = torch.randint(-127, 128, (b, d), generator=g, device=dev, dtype=torch.int8)
    q[0] = corpus[0].clone()
    qscale = (torch.rand(b, generator=g, device=dev) + 0.5) / 127
    return q, qscale, corpus, cscale, penalty.float()


@pytest.mark.parametrize(
    "n,d,b,k", [(5000, 64, 1, 12), (70_001, 1024, 33, 64), (131_072, 1024, 128, 64)]
)
def test_topk_int8_kernel_matches_plain(cuda, n, d, b, k):
    q, qscale, corpus, cscale, penalty = _case(cuda, n, d, b, seed=n + b)
    args = (q, qscale, corpus, cscale, k, penalty)
    before = topk_int8.launches
    vals, idx = topk_int8(*args)
    torch.cuda.synchronize()
    assert topk_int8.launches == before + 1
    pv, pi = topk_int8_plain(*args)
    assert torch.equal(idx, pi)
    assert torch.equal(vals, pv)
    assert idx[0, :10].tolist() == sorted(idx[0, :10].tolist())  # ties: low row first
    tied = vals[:, 1:] == vals[:, :-1]
    assert (idx[:, 1:][tied] > idx[:, :-1][tied]).all()


def test_topk_int8_kernel_dead_slots(cuda):
    q, qscale, corpus, cscale, _ = _case(cuda, 20_000, 128, 8, seed=1)
    penalty = torch.full((20_000,), NEG, device=cuda)
    penalty[torch.arange(5, 20_000, 2000, device=cuda)] = 0.0  # 10 live rows
    vals, idx = topk_int8(q, qscale, corpus, cscale, 64, penalty)
    pv, pi = topk_int8_plain(q, qscale, corpus, cscale, 64, penalty)
    assert torch.equal(idx, pi) and torch.equal(vals, pv)
    assert (vals[:, 10:] == NEG).all() and (idx[:, 10:] == 0).all()


def test_topk_int8_kernel_refuses_bad_shapes(cuda):
    q, qscale, corpus, cscale, penalty = _case(cuda, 4096, 64, 2, seed=2)
    with pytest.raises(ValueError):
        topk_int8(q, qscale, corpus, cscale, 65, penalty)  # K > 64
    with pytest.raises(ValueError):
        topk_int8(q[:, :40], qscale, corpus[:, :40], cscale, 12, penalty)  # D % 16


@pytest.mark.parametrize(
    "n,d,b,k",
    [(5_003, 1024, 1, 1), (70_001, 1040, 128, 12), (20_000, 96, 33, 64), (9_000, 48, 128, 1),
     (3_001, 80, 1, 64), (100, 1040, 33, 64), (255, 96, 128, 12), (64, 48, 1, 64),
     (130_001, 1024, 128, 64), (40_000, 80, 33, 1)],
)
def test_topk_int8_kernel_bit_equal_at_the_new_tiles(cuda, n, d, b, k):
    """D = 1024, 1040 (the twin's widest exact width), 96, and 48 and 80 (a
    half k-step of zeros); B = 1, 33, 128; K = 1, 12, 64; N that no tile
    divides and N under one tile: values and rows bit-equal to the twin,
    ties lowest row first, two runs bit-equal."""
    q, qscale, corpus, cscale, penalty = _case(cuda, n, d, b, seed=n + d + b + k)
    args = (q, qscale, corpus, cscale, k, penalty)
    vals, idx = topk_int8(*args)
    torch.cuda.synchronize()
    pv, pi = topk_int8_plain(*args)
    assert torch.equal(idx, pi) and torch.equal(vals, pv)
    tied = vals[:, 1:] == vals[:, :-1]
    assert (idx[:, 1:][tied] > idx[:, :-1][tied]).all()
    again = topk_int8(*args)
    assert torch.equal(vals, again[0]) and torch.equal(idx, again[1])


@pytest.mark.parametrize("n,b", [(300_007, 33), (40_000, 128)])
def test_topk_int8_copies_tie_in_every_position(cuda, n, b):
    """Copies of one row at positions 0, 7, 8 and 15 of a 16-row MMA
    fragment, in a second warp's fragment, on both sides of a tile edge and
    of the first chunk's edge score alike and come out lowest row first."""
    from outline_rag_tpu_torch.ops.topk import _int8_kernel_plan
    from outline_rag_tpu_torch.tools.kernel_mutants import int8_scan_case

    chunk = _int8_kernel_plan(b, n, cuda)[1]
    copies = sorted({0, 7, 8, 15, 16 + 0, 16 + 7, 16 + 8, 16 + 15, 127, 128, 255, 256,
                     chunk - 1, chunk})
    assert chunk < n
    g = torch.Generator(device=cuda).manual_seed(n + b)
    q, qscale, corpus, cscale, penalty = int8_scan_case(cuda, g, n, 1024, b, copies)
    vals, idx = topk_int8(q, qscale, corpus, cscale, 64, penalty)
    torch.cuda.synchronize()
    assert idx[0, : len(copies)].tolist() == copies
    assert (vals[0, : len(copies)] == vals[0, 0]).all()
    pv, pi = topk_int8_plain(q, qscale, corpus, cscale, 64, penalty)
    assert torch.equal(idx, pi) and torch.equal(vals, pv)


def test_topk_int8_threshold_is_the_lists_kth_entry(cuda):
    """A row that arrives after a list is full and scores between its
    (k-1)-th and k-th entries still enters."""
    from outline_rag_tpu_torch.tools.kernel_mutants import int8_threshold_case

    g = torch.Generator(device=cuda).manual_seed(5)
    args, k, want = int8_threshold_case(cuda, g)
    vals, idx = topk_int8(*args[:4], k, args[4])
    torch.cuda.synchronize()
    assert idx[0].tolist() == want
    assert vals[0].tolist() == [127.0 * 127, 127.0 * 120, 127.0 * 112, 127.0 * 108]
    pv, pi = topk_int8_plain(*args[:4], k, args[4])
    assert torch.equal(idx, pi) and torch.equal(vals, pv)


def test_topk_int8_kernel_wide_rows_match_an_exact_reference(cuda):
    """D = 4,096, past the twin's exact width: int32 sums above 2^24 are
    converted to f32 once, rounding to nearest, as the float64 reference
    does."""
    from outline_rag_tpu_torch.tools.kernel_mutants import int8_exact_topk, int8_wide_case

    g = torch.Generator(device=cuda).manual_seed(7)
    args = int8_wide_case(cuda, g)
    vals, idx = topk_int8(*args[:4], 64, args[4])
    torch.cuda.synchronize()
    ev, ei = int8_exact_topk(*args[:4], 64, args[4])
    assert torch.equal(idx, ei) and torch.equal(vals, ev)
    assert float(vals[0, 0] / (args[3][idx[0, 0]] * args[1][0])) > 1 << 24  # the sums do round


@pytest.mark.parametrize("d,b", [(48, 33), (1040, 128)])
def test_topk_int8_kernel_few_live_rows(cuda, d, b):
    """Fewer live rows than K, spread over several chunks: the unfilled
    slots are (NEG, 0)."""
    q, qscale, corpus, cscale, _ = _case(cuda, 50_000, d, b, seed=d + b)
    penalty = torch.full((50_000,), NEG, device=cuda)
    penalty[torch.arange(11, 50_000, 5000, device=cuda)] = 0.0  # 10 live rows
    vals, idx = topk_int8(q, qscale, corpus, cscale, 64, penalty)
    pv, pi = topk_int8_plain(q, qscale, corpus, cscale, 64, penalty)
    assert torch.equal(idx, pi) and torch.equal(vals, pv)
    assert (vals[:, 10:] == NEG).all() and (idx[:, 10:] == 0).all()
    assert (vals[:, :10] > NEG / 2).all()


def _float_case(dev, n, d, b, mode, seed):
    """Unit rows in the mode's storage, 1% tombstoned, row 0 and 9 copies
    of it; query 0 is row 0, so the copies tie at its top."""
    g = torch.Generator(device=dev).manual_seed(seed)
    corpus = torch.randn((n, d), generator=g, device=dev)
    corpus /= corpus.norm(dim=1, keepdim=True)
    penalty = torch.where(torch.rand(n, generator=g, device=dev) < 0.01, NEG, 0.0)
    dups = torch.randperm(n - 1, generator=g, device=dev)[:9] + 1
    corpus[dups] = corpus[0].clone()
    penalty[dups] = 0.0
    penalty[0] = 0.0
    q = torch.randn((b, d), generator=g, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    q[0] = corpus[0].clone()
    if mode == "fp32":
        return q, corpus, penalty.float()
    if mode == "bf16":
        return q.to(torch.bfloat16), corpus.to(torch.bfloat16), penalty.float()
    return split_f32_bf16x2(q), split_f32_bf16x2(corpus), penalty.float()


@pytest.mark.parametrize("mode", ["fp32", "bf16", "f32x2"])
@pytest.mark.parametrize(
    "n,d,b,k,orientation",
    [(5000, 64, 1, 12, "qmajor"), (70_001, 1024, 33, 64, "cmajor"), (20_000, 96, 130, 64, "qmajor")],
)
def test_topk_float_kernel_matches_plain(cuda, mode, n, d, b, k, orientation):
    q, corpus, penalty = _float_case(cuda, n, d, b, mode, seed=n + b)
    before = topk_float.launches[mode]
    vals, idx = topk_float(q, corpus, k, penalty, mode, orientation)
    torch.cuda.synchronize()
    assert topk_float.launches[mode] == before + 1
    assert tuple(vals.shape) == (b, k) and idx.dtype == torch.int32
    pv, pi = topk_float_plain(q, corpus, k + 1, penalty, mode)
    assert tie_aware_mismatches(vals, idx, pv, pi, 1e-5) == 0
    # the copies of row 0 tie exactly (one instruction sequence per row)
    # and come lowest row first
    assert idx[0, :10].tolist() == sorted(idx[0, :10].tolist())
    assert (vals[0, :10] == vals[0, 0]).all()
    tied = vals[:, 1:] == vals[:, :-1]
    assert (idx[:, 1:][tied] > idx[:, :-1][tied]).all()


@pytest.mark.parametrize("mode", ["fp32", "bf16", "f32x2"])
def test_topk_float_kernel_dead_slots(cuda, mode):
    q, corpus, _ = _float_case(cuda, 20_000, 128, 8, mode, seed=1)
    penalty = torch.full((20_000,), NEG, device=cuda)
    penalty[torch.arange(5, 20_000, 2000, device=cuda)] = 0.0  # 10 live rows
    vals, idx = topk_float(q, corpus, 64, penalty, mode)
    pv, pi = topk_float_plain(q, corpus, 64, penalty, mode)
    assert tie_aware_mismatches(vals, idx, pv, pi, 1e-5) == 0
    assert (vals[:, 10:] == NEG).all() and (idx[:, 10:] == 0).all()


def test_topk_float_kernel_refuses_bad_shapes(cuda):
    q, corpus, penalty = _float_case(cuda, 4096, 64, 2, "fp32", seed=2)
    with pytest.raises(ValueError):
        topk_float(q, corpus, 65, penalty)  # K > 64
    with pytest.raises(ValueError):
        topk_float(q[:, :48].contiguous(), corpus[:, :48].contiguous(), 12, penalty)  # D % 32
    with pytest.raises(ValueError):
        topk_float(q, corpus.to(torch.bfloat16), 12, penalty, "bf16")  # f32 queries
    with pytest.raises(ValueError):
        topk_float(q, corpus, 12, penalty, "f32x2")  # f32 pairs


@pytest.mark.parametrize("mode", ["fp32", "bf16", "f32x2"])
@pytest.mark.parametrize("n,b", [(300_007, 33), (40_000, 128)])
def test_topk_float_copies_tie_in_every_position(cuda, mode, n, b):
    """Copies of one row at positions 0, 7, 8 and 15 of a 16-row MMA
    fragment, in a second warp's fragment, on both sides of a tile edge and
    of the first chunk's edge all score bit for bit alike and come out lowest
    row first (every output element sums in one order fixed by d)."""
    from outline_rag_tpu_torch.ops.topk import _float_kernel_plan
    from outline_rag_tpu_torch.tools.kernel_mutants import float_scan_case

    chunk = _float_kernel_plan(b, n, cuda, mode)[1]
    copies = sorted({0, 7, 8, 15, 16 + 0, 16 + 7, 16 + 8, 16 + 15, 127, 128, 255, 256,
                     chunk - 1, chunk})
    assert chunk < n
    g = torch.Generator(device=cuda).manual_seed(n + b)
    q, corpus, penalty = float_scan_case(cuda, g, n, 1024, b, mode, copies)
    vals, idx = topk_float(q, corpus, 64, penalty, mode)
    torch.cuda.synchronize()
    assert idx[0, : len(copies)].tolist() == copies
    assert (vals[0, : len(copies)] == vals[0, 0]).all()
    pv, pi = topk_float_plain(q, corpus, 65, penalty, mode)
    assert tie_aware_mismatches(vals, idx, pv, pi, 1e-5) == 0
    assert float((vals - pv[:, :64]).abs().max()) <= 1e-5


@pytest.mark.parametrize("mode", ["fp32", "bf16", "f32x2"])
def test_topk_float_threshold_is_the_lists_kth_entry(cuda, mode):
    """A row that arrives after a list is full and scores between its
    (k-1)-th and k-th entries still enters: the test a score must pass is
    the k-th entry, exactly."""
    from outline_rag_tpu_torch.tools.kernel_mutants import float_threshold_case

    g = torch.Generator(device=cuda).manual_seed(5)
    q, corpus, penalty, k, want = float_threshold_case(cuda, g, mode)
    vals, idx = topk_float(q, corpus, k, penalty, mode)
    torch.cuda.synchronize()
    assert idx[0].tolist() == want
    assert vals[0].tolist() == [1.0, 15 / 16, 7 / 8, 27 / 32]
    pv, pi = topk_float_plain(q, corpus, k + 1, penalty, mode)
    assert tie_aware_mismatches(vals, idx, pv, pi, 1e-5) == 0


@pytest.mark.parametrize("mode", ["fp32", "bf16", "f32x2"])
@pytest.mark.parametrize(
    "n,d,b,k,orientation",
    [(70_001, 96, 1, 64, "qmajor"), (9_000, 1056, 33, 64, "cmajor"), (5_003, 1056, 128, 12, "qmajor"),
     (255, 96, 33, 64, "cmajor"), (130_000, 1024, 128, 64, "cmajor")],
)
def test_topk_float_kernel_shapes_of_the_new_tiles(cuda, mode, n, d, b, k, orientation):
    """D that a 64-dimension slab does not divide (96, 1056), N that no tile
    divides, B of 1, 33 and 128 and both orientations: within 1e-5 of the
    twin, no tie-aware mismatch, and two runs bit-equal."""
    q, corpus, penalty = _float_case(cuda, n, d, b, mode, seed=n + d + b)
    vals, idx = topk_float(q, corpus, k, penalty, mode, orientation)
    torch.cuda.synchronize()
    pv, pi = topk_float_plain(q, corpus, k + 1, penalty, mode)
    assert float((vals - pv[:, :k]).abs().max()) <= 1e-5
    assert tie_aware_mismatches(vals, idx, pv, pi, 1e-5) == 0
    again = topk_float(q, corpus, k, penalty, mode, orientation)
    assert torch.equal(vals, again[0]) and torch.equal(idx, again[1])


@pytest.mark.parametrize("mode", ["fp32", "bf16", "f32x2"])
@pytest.mark.parametrize("d,b", [(96, 33), (1056, 128)])
def test_topk_float_kernel_few_live_rows(cuda, mode, d, b):
    """Fewer live rows than K, spread over several chunks: the unfilled
    slots are (NEG, 0)."""
    q, corpus, _ = _float_case(cuda, 50_000, d, b, mode, seed=d + b)
    penalty = torch.full((50_000,), NEG, device=cuda)
    penalty[torch.arange(11, 50_000, 5000, device=cuda)] = 0.0  # 10 live rows
    vals, idx = topk_float(q, corpus, 64, penalty, mode, "cmajor")
    pv, pi = topk_float_plain(q, corpus, 64, penalty, mode)
    assert tie_aware_mismatches(vals, idx, pv, pi, 1e-5) == 0
    assert (vals[:, 10:] == NEG).all() and (idx[:, 10:] == 0).all()
    assert (vals[:, :10] > NEG / 2).all()


def _attention_case(dev, b, s, h, lengths, seed, dtype=torch.bfloat16):
    """A row's live keys: the first n for an int, else a list of (from, to)
    spans (a bias that is no prefix mask)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, 64), generator=g, device=dev).to(dtype) for _ in range(3))
    bias = torch.full((b, s), NEG_BIAS, device=dev)
    for i, live in enumerate(lengths):
        for lo, hi in ([(0, live)] if isinstance(live, int) else live):
            bias[i, lo:hi] = 0.0
    return q, k, v, bias


# bf16: each element within 2e-3 + 2 bf16 ulps of the twin and the error's
# norm within 1e-2 of the output's (P is rounded against a running max over
# 64-key tiles in the kernel, the row max in the twin; a dropped key tile,
# a missing rescale or an unswizzled tile breaks both:
# ``tools/kernel_mutants.py``). f32: 1e-5, the sums' order only.
FLASH_BOUNDS = {torch.bfloat16: (2e-3, 2.0, 1e-2), torch.float32: (1e-5, 0.0, 1e-5)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,s,h,lengths",
    [(1, 64, 1, [64]), (2, 200, 3, [200, 131]), (3, 1000, 2, [1000, 77, 0]), (1, 2048, 16, [1500]),
     (1, 256 + 37, 2, [256 + 37]),  # S no multiple of the query or the key tile
     (1, 1024, 2, [[(0, 100), (700, 800)]]),  # no prefix mask: all-padding tiles in between
     (3, 600, 2, [600, 0, [(5, 70)]])],
)
def test_flash_kernel_matches_plain(cuda, dtype, b, s, h, lengths):
    """Within ``FLASH_BOUNDS``; a row with no live key is exactly zero; two
    runs are bit-equal."""
    args = _attention_case(cuda, b, s, h, lengths, seed=s + b, dtype=dtype)
    before = flash_attention.launches
    out = flash_attention(*args)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.equal(out, flash_attention(*args))
    assert out.dtype == dtype and out.shape == args[0].shape
    atol, ulps, rel_rms = FLASH_BOUNDS[dtype]
    err = flash_errors(out, flash_attention_plain(*args), atol, ulps)
    assert err["worst_vs_bound"] <= 1.0 and err["rel_rms_err"] <= rel_rms, err
    for i, n in enumerate(lengths):
        if n == 0:
            assert (out[i] == 0).all()


def test_flash_kernel_refuses_bad_shapes(cuda):
    q, k, v, bias = _attention_case(cuda, 1, 64, 2, [64], seed=3)
    with pytest.raises(ValueError):
        flash_attention(q.half(), k.half(), v.half(), bias)  # f16
    with pytest.raises(ValueError):
        flash_attention(q.float(), k, v, bias)  # mixed dtypes
    with pytest.raises(ValueError):
        flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous(), bias)  # D != 64
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), bias)
    off = torch.zeros(k.numel() + 1, dtype=k.dtype, device=cuda)[1:].reshape(k.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, off, v, bias)  # contiguous, two bytes off a 16-byte boundary


# ----------------------------------------------------------------------
# the decoder's kernels: paged attention, the KV page write, w8a16 linear
# ----------------------------------------------------------------------


def _paged_case(dev, b, t, kv, seed, h=32, kvh=4, dh=64):
    from outline_rag_tpu_torch.ops.paged_attention import paged_attention, paged_attention_plain

    g = torch.Generator(device=dev).manual_seed(seed)
    args = list(paged_attention_case(dev, g, b, t, "int8" if kv == "int8" else "bf16", heads=h,
                                     kv_heads=kvh, hd=dh, pages=300,
                                     inactive_every=7 if b > 2 else 0))
    if kv == "f32":
        args[:3] = [x.float() for x in args[:3]]
    if b > 2:
        args[4][2] = 0  # a row that sees a single slot
    return tuple(args), paged_attention, paged_attention_plain


# (atol, bf16 ulps, error norm / output norm) of the paged kernel against its
# twin: bf16 the flash bound's form (the kernel rounds p against a running max
# over key tiles, the twin against the row max); int8 pool f32 products, 1e-4
# plus one bf16 ulp of the bf16 output; f32 1e-5
PAGED_BOUNDS = {"bf16": (2e-3, 2.0, 1e-2), "int8": (1e-4, 1.0, 1e-3), "f32": (1e-5, 0.0, 1e-5)}


@pytest.mark.parametrize("kv", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("b,t,dh", [(1, 1, 64), (8, 1, 64), (5, 3, 64), (1, 256, 64), (3, 40, 128)])
def test_paged_attention_kernel_matches_plain(cuda, kv, b, t, dh):
    """bf16: the flash bound's form (the kernel rounds p against a running
    max over key tiles, the twin against the row max). int8 pool: f32
    products, 1e-4 plus one bf16 ulp of the bf16 output. f32: 1e-5."""
    args, kernel, plain = _paged_case(cuda, b, t, kv, seed=b * 1000 + t, dh=dh,
                                      h=8 if dh == 128 else 32, kvh=2 if dh == 128 else 4)
    before = kernel.launches
    out = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(out, kernel(*args))  # no dependence on block order
    atol, ulps, rms = PAGED_BOUNDS[kv]
    errs = flash_errors(out, plain(*args), atol, ulps)
    assert errs["worst_vs_bound"] <= 1.0 and errs["rel_rms_err"] <= rms, errs
    assert bool(torch.isfinite(out.float()).all())


def test_paged_attention_row_is_independent_of_batch_and_chunk(cuda):
    """A position's output is bit-equal whether it is computed alone (T = 1),
    inside a 64-token chunk, or beside other rows: what warm == cold needs."""
    from outline_rag_tpu_torch.ops.paged_attention import paged_attention

    args, *_ = _paged_case(cuda, 4, 64, "bf16", seed=9)
    q, pk, pv, table, pos = args
    pos = torch.tensor([100, 0, 700, 1500], device=cuda, dtype=torch.int32)
    full = paged_attention(q, pk, pv, table, pos)
    for r, t in ((0, 0), (2, 17), (3, 63)):
        one = paged_attention(q[r : r + 1, t : t + 1].contiguous(), pk, pv,
                              table[r : r + 1].contiguous(), pos[r : r + 1] + t)
        assert torch.equal(one[0, 0], full[r, t])


@pytest.mark.parametrize("kv", ["bf16", "int8", "f32"])
def test_paged_attention_split_boundaries_are_bit_equal_across_t_and_batch(cuda, kv):
    """Positions on either side of the 256-slot split boundaries (and the
    last slot of the capacity) give the same bits inside a 64-token chunk,
    alone and beside other rows."""
    from outline_rag_tpu_torch.ops.paged_attention import paged_attention

    g = torch.Generator(device=cuda).manual_seed(11)
    fn = paged_attention
    if kv == "f32":
        def fn(q, pk, pv, *rest):
            return paged_attention(q.float(), pk.float(), pv.float(), *rest)
    assert split_boundary_mismatches(fn, cuda, g, "int8" if kv == "int8" else "bf16") == []


@pytest.mark.parametrize("kv", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("start", [200, 1900, 254, 1790])
def test_paged_attention_chunk_across_a_split_boundary(cuda, kv, start):
    """A 256-token prefill chunk that crosses a split boundary (from 200 and
    1,790) or the capacity (from 1,900); from 254 and 1,790 a tile of four
    positions straddles a boundary, so some of its rows' horizons lie before
    a split the tile walks."""
    args, kernel, plain = _paged_case(cuda, 1, 256, kv, seed=start)
    args = (*args[:4], torch.tensor([start], device=cuda, dtype=torch.int32), *args[5:])
    out = kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, kernel(*args))
    atol, ulps, rms = PAGED_BOUNDS[kv]
    errs = flash_errors(out, plain(*args), atol, ulps)
    assert errs["worst_vs_bound"] <= 1.0 and errs["rel_rms_err"] <= rms, errs


@pytest.mark.parametrize("kv", ["bf16", "int8", "f32"])
def test_paged_attention_every_live_split_count(cuda, kv):
    """Rows of every live-split count from 1 to 8, at lengths on both sides
    of each boundary (1, 256, 257, ..., 1,793, 2,048)."""
    lengths = [1, 256] + [n for k in range(1, 8) for n in (256 * k + 1, 256 * (k + 1))]
    args, kernel, plain = _paged_case(cuda, len(lengths), 1, kv, seed=17)
    pos = torch.tensor(lengths, device=cuda, dtype=torch.int32) - 1
    g = torch.Generator(device=cuda).manual_seed(5)
    table = (torch.randperm(299, generator=g, device=cuda)[: len(lengths) * 16] + 1).reshape(-1, 16)
    args = (*args[:3], table.to(torch.int32), pos, *args[5:])
    out = kernel(*args)
    torch.cuda.synchronize()
    atol, ulps, rms = PAGED_BOUNDS[kv]
    errs = flash_errors(out, plain(*args), atol, ulps)
    assert errs["worst_vs_bound"] <= 1.0 and errs["rel_rms_err"] <= rms, errs


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_attention_folds_splits_in_order(cuda, kv):
    """A row whose f32 sums are exact only when its three splits are folded
    in order 0, 1, 2 gives exactly bf16(256 / 768)."""
    from outline_rag_tpu_torch.ops.paged_attention import paged_attention

    args, want = paged_order_case(cuda, kv)
    out = paged_attention(*args)
    torch.cuda.synchronize()
    assert bool((out.float() == want).all()), float(out.float().flatten()[0])


@pytest.mark.parametrize("kv", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("b,t,start", [(64, 1, None), (1, 256, 100), (2, 256, 1900), (3, 7, 125)])
def test_paged_kv_write_kernel_matches_plain(cuda, kv, b, t, start):
    from outline_rag_tpu_torch.ops.paged_attention import paged_kv_write, paged_kv_write_plain

    g = torch.Generator(device=cuda).manual_seed(b + t)
    dt = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}[kv]
    pages, kvh, page, dh, maxp = 1200, 4, 128, 64, 16

    def draw(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=cuda).to(dt)

    pools = [draw(pages, kvh, page, dh), draw(pages, kvh, page, dh)]
    new = [draw(b, t, kvh, dh), draw(b, t, kvh, dh)]
    table = (torch.randperm(pages - 1, generator=g, device=cuda)[: b * maxp] + 1).reshape(b, maxp)
    table = table.to(torch.int32)
    pos = (torch.randint(0, maxp * page - t, (b,), generator=g, device=cuda) if start is None
           else torch.full((b,), start, device=cuda)).to(torch.int32)
    scales = []
    if kv == "int8":
        scales = [torch.rand(s, generator=g, device=cuda)
                  for s in ((pages, kvh, page), (pages, kvh, page), (b, t, kvh), (b, t, kvh))]
    want = paged_kv_write_plain(*(p.clone() for p in pools), table, pos, *new,
                                *(s.clone() for s in scales))
    before = paged_kv_write.launches
    got = paged_kv_write(*pools, table, pos, *new, *scales)
    torch.cuda.synchronize()
    assert paged_kv_write.launches == before + 1 and got[0] is pools[0]
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):  # page 0 is garbage by contract
        assert torch.equal(g_[1:], w_[1:])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(8, 2048, 2560), (64, 2048, 11264), (64, 5632, 2048),
                                   (256, 2048, 32000), (24, 2064, 40), (64, 2048, 2048)])
def test_int8_linear_kernel_matches_plain(cuda, m, k, n, dtype):
    """Products are exact in f32 in both; the sums run in another order:
    f32 outputs within 1e-5 of the output's scale, bf16 within one ulp."""
    from outline_rag_tpu_torch.ops.int8_linear import (
        int8_linear, int8_linear_plain, quantize_linear_weight)

    g = torch.Generator(device=cuda).manual_seed(m + n)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    q, s = quantize_linear_weight(torch.randn((k, n), generator=g, device=cuda) * 0.02)
    before = int8_linear.launches
    out = int8_linear(x, q, s)
    torch.cuda.synchronize()
    assert int8_linear.launches == before + 1 and out.dtype == dtype
    ref = int8_linear_plain(x, q, s)
    errs = flash_errors(out, ref, 1e-5 * float(ref.abs().max()), 1.0 if dtype == torch.bfloat16 else 0.0)
    assert errs["worst_vs_bound"] <= 1.0, errs
    with pytest.raises(ValueError, match="K % 16"):
        int8_linear(x[:, :24].contiguous(), q[:, :24].contiguous(), s)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", [(2048, 2560), (5632, 2048), (2064, 40)])
def test_int8_linear_rows_do_not_depend_on_m(cuda, k, n, dtype):
    """Rows at M = 8 are bit-equal to the same rows inside M = 64 and M =
    256 (other row tiles, other block shapes), and two runs are bit-equal:
    what chunked prefill and warm == cold rest on."""
    from outline_rag_tpu_torch.ops.int8_linear import int8_linear, quantize_linear_weight

    g = torch.Generator(device=cuda).manual_seed(k + n)
    x = torch.randn((256, k), generator=g, device=cuda).to(dtype)
    q, s = quantize_linear_weight(torch.randn((k, n), generator=g, device=cuda) * 0.02)
    whole = int8_linear(x, q, s)
    assert torch.equal(int8_linear(x, q, s), whole)
    at_64 = int8_linear(x[:64], q, s)
    assert torch.equal(at_64, whole[:64])
    for row in (0, 40, 200):
        at_8 = int8_linear(x[row : row + 8], q, s)
        assert torch.equal(at_8, whole[row : row + 8])
        if row < 64:
            assert torch.equal(at_8, at_64[row : row + 8])


@pytest.mark.parametrize("k,n,what", [(64, 44, "N % 8"), (72, 48, "K % 16")])
def test_kernel_mode_refuses_a_width_the_kernel_cannot_take(cuda, monkeypatch, k, n, what):
    """``_mm`` in ``kernel`` mode on the card: an N or K the kernel cannot
    take raises and launches nothing, it never gives way to the plain
    product."""
    import outline_rag_tpu_torch.models.decoder as dec
    from outline_rag_tpu_torch.ops.int8_linear import int8_linear

    monkeypatch.setattr(dec, "_INT8_MODE", "kernel")
    g = torch.Generator(device=cuda).manual_seed(k + n)
    w = {"q": torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8),
         "s": torch.rand(n, generator=g, device=cuda) / 127}
    x = torch.randn((2, 3, k), generator=g, device=cuda).bfloat16()
    before = int8_linear.launches
    with pytest.raises(ValueError, match=what):
        dec._mm(x, w, torch.bfloat16)
    assert int8_linear.launches == before


def test_w8a8_matmul_on_the_card_is_exact(cuda):
    from outline_rag_tpu_torch.ops.int8_linear import quantize_linear_weight, w8a8_matmul

    g = torch.Generator(device=cuda).manual_seed(1)
    for m, k, n in ((5, 2048, 72), (64, 5632, 2048), (300, 64, 24)):
        x = torch.randn((m, k), generator=g, device=cuda)
        q, s = quantize_linear_weight(torch.randn((k, n), generator=g, device=cuda) * 0.02)
        got = w8a8_matmul(x, q, s)
        want = w8a8_matmul(x.cpu(), q.cpu(), s.cpu())
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-9)


def _small_decoder(dev, dtype=torch.bfloat16):
    from outline_rag_tpu_torch.models.decoder import DecoderConfig, init_decoder

    cfg = DecoderConfig(vocab_size=512, hidden=256, layers=2, heads=4, kv_heads=2,
                        intermediate=512, max_cache=512, dtype=dtype)
    return cfg, init_decoder(cfg, torch.Generator(device=dev).manual_seed(0), dev)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_decoder_forward_kernels_against_twins(cuda, kv_dtype, monkeypatch):
    """One paged forward with the kernels and the same forward with the
    plain twins patched in: bf16 logits within 2e-2 of logits of order 1."""
    import outline_rag_tpu_torch.models.decoder as dec
    from outline_rag_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_plain, paged_kv_write, paged_kv_write_plain)

    cfg, params = _small_decoder(cuda)
    toks = torch.randint(1, 512, (2, 40), generator=torch.Generator(device=cuda).manual_seed(1),
                         device=cuda)
    zero = torch.zeros(2, dtype=torch.int32, device=cuda)

    def run():
        cache = dec.init_paged_cache(cfg, 2, 9, 128, kv_dtype=kv_dtype, device=cuda)
        cache.table[:] = torch.tensor([[3, 5, 1, 7], [2, 4, 6, 8]], device=cuda)
        with torch.inference_mode():
            return dec.decoder_forward(params, toks, cache, zero, cfg)[0]

    a0, w0 = paged_attention.launches, paged_kv_write.launches
    got = run()
    assert (paged_attention.launches - a0, paged_kv_write.launches - w0) == (2, 2)
    monkeypatch.setattr(dec, "paged_attention", paged_attention_plain)
    monkeypatch.setattr(dec, "paged_kv_write", paged_kv_write_plain)
    want = run()
    assert float((got - want).abs().max()) <= 2e-2 * max(1.0, float(want.abs().max()))


def test_batcher_on_the_card_warm_equals_cold_and_reclaims_pages(cuda):
    from outline_rag_tpu_torch.serve.decode_batcher import DONE, DecodeBatcher

    cfg, params = _small_decoder(cuda)
    b = DecodeBatcher(params, cfg, slots=4, chunk_tokens=4, eos_id=0, kv_pages=17,
                      page_size=128, device=cuda)

    def collect(q):
        out = []
        while True:
            item = q.get(timeout=120)
            if item is DONE:
                return out
            if isinstance(item, Exception):
                raise item
            out.extend(item)

    try:
        prompt = [(7 * i) % 500 + 1 for i in range(300)]
        cold = collect(b.submit(prompt, 0.0, 1.0, 12))
        others = [b.submit([(11 * i + j) % 500 + 1 for i in range(150)], 0.9, 0.95, 12, seed=j + 1)
                  for j in range(3)]
        warm = collect(b.submit(prompt, 0.0, 1.0, 12))  # beside sampled neighbours
        assert all(len(collect(q)) > 0 for q in others)
        st = b.stats()
    finally:
        b.close()
    assert warm == cold and len(cold) > 0
    assert st["prefix_hits"] >= 2 and st["active"] == 0
    assert st["pages_free"] + st["pages_cached"] == st["pages_total"]


# ----------------------------------------------------------------------
# int4 linears and the floors
# ----------------------------------------------------------------------

INT4_SHAPES = [(2048, 2560, 128), (5632, 2048, 128), (2048, 32000, 128), (512, 384, 256),
               (2048, 512, 512), (768, 256, 384), (11008, 4096, 128)]


def _int4_case(dev, k, n, gsz, m, seed=0):
    import outline_rag_tpu_torch.ops.int4_linear as int4

    g = torch.Generator(device=dev).manual_seed(seed + k + n)
    q4, s4 = int4.quantize_int4_weight(torch.randn((k, n), generator=g, device=dev) * 0.02, gsz)
    return int4, torch.randn((m, k), generator=g, device=dev), q4, s4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 8, 32, 64, 256])
@pytest.mark.parametrize("k", [256, 2048, 5632, 11008])
def test_row_quantizer_kernel_is_byte_equal_to_its_twin(cuda, k, m, dtype):
    """Codes and the bits of the scales: true divisions, round half to even."""
    import outline_rag_tpu_torch.ops.int4_linear as int4
    from outline_rag_tpu_torch.testing import QUANTIZER_TIE_CODES, quantizer_rows

    x = quantizer_rows(cuda, torch.Generator(device=cuda).manual_seed(m + k), m, k, dtype)
    before = int4.quantize_rows.launches
    xq, xs = int4.quantize_rows(x)
    torch.cuda.synchronize()
    assert int4.quantize_rows.launches == before + 1
    want_q, want_s = int4._quantize_activations(x)
    assert xq.dtype == torch.int8 and tuple(xs.shape) == (m, 1)
    assert torch.equal(xq, want_q), int((xq != want_q).sum())
    assert torch.equal(xs.view(torch.int32), want_s.view(torch.int32))
    assert float(xs[0, 0]) == float(torch.tensor(1e-12, dtype=torch.float32)) and not xq[0].any()
    if m > 3:
        assert xq[2, :8].tolist() == QUANTIZER_TIE_CODES
        assert float(xs[3, 0]) == float(torch.tensor(3.25) / torch.tensor(127.0))  # a division
    with pytest.raises(ValueError, match="K % 16"):
        int4.quantize_rows(x[:, :24].contiguous())


@pytest.mark.parametrize("m", [1, 8, 32, 64, 256])
@pytest.mark.parametrize("k,n,gsz", INT4_SHAPES)
def test_w4a8_kernel_matches_plain(cuda, k, n, gsz, m):
    """Exact integer group sums, the f32 sum over groups in one order:
    bit-equal to the twin, also through the bf16 epilogue; two launches (the
    row quantizer and the product); two runs bit-equal."""
    int4, x, q4, s4 = _int4_case(cuda, k, n, gsz, m)
    xb = x.to(torch.bfloat16)
    before = int4.w4a8_matmul.launches, int4.quantize_rows.launches
    got = int4.w4a8_matmul(xb, q4, s4)
    torch.cuda.synchronize()
    assert (int4.w4a8_matmul.launches, int4.quantize_rows.launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert torch.equal(got, int4.w4a8_matmul_plain(xb, q4, s4))
    assert torch.equal(got, int4.w4a8_matmul(xb, q4, s4))
    as_bf16 = int4._w4a8_matmul_as(xb, q4, s4, torch.bfloat16)
    assert as_bf16.dtype == torch.bfloat16 and torch.equal(as_bf16, got.to(torch.bfloat16))
    launched = int4.w4a8_matmul.launches, int4.quantize_rows.launches
    with pytest.raises(ValueError, match="writes bf16 or f32"):  # no third output path
        int4._w4a8_matmul_as(xb, q4, s4, torch.float16)
    assert (int4.w4a8_matmul.launches, int4.quantize_rows.launches) == launched


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 8, 32, 64, 256])
@pytest.mark.parametrize("k,n,gsz", INT4_SHAPES)
def test_w4a16_kernel_matches_plain(cuda, k, n, gsz, m, dt):
    """The same decoded weights, f32 sums in another order (tensor cores in
    bf16, a thread's FMA chain in f32): 1e-5 of the output's scale + 1e-5
    relative, also at bf16 (the output is f32); a partial last slab of K
    (5,632, 11,008) too. The epilogue in the working type is the f32 result
    rounded once, one launch; two runs bit-equal."""
    from outline_rag_tpu_torch.testing import scaled_errors

    int4, x, q4, s4 = _int4_case(cuda, k, n, gsz, m)
    before = int4.w4a16_matmul.launches
    got = int4.w4a16_matmul(x.to(dt), q4, s4, variant="v2")
    torch.cuda.synchronize()
    assert int4.w4a16_matmul.launches == before + 1
    e = scaled_errors(got, int4.w4a16_matmul_plain(x.to(dt), q4, s4))
    assert got.dtype == torch.float32 and e["worst_vs_bound"] <= 1.0, e
    assert torch.equal(got, int4.w4a16_matmul(x.to(dt), q4, s4))
    as_dt = int4._w4a16_matmul_as(x.to(dt), q4, s4, dt)
    assert int4.w4a16_matmul.launches == before + 3
    assert as_dt.dtype == dt and torch.equal(as_dt, got.to(dt))


def test_int4_rows_do_not_depend_on_m(cuda):
    """A row at M = 1 is bit-equal to the same row inside M = 32 and M = 256
    (other row tiles, other instantiations): what warm == cold rests on."""
    int4, x, q4, s4 = _int4_case(cuda, 2048, 2560, 128, 256)
    for fn in (int4.w4a8_matmul, lambda *a: int4.w4a16_matmul(a[0].to(torch.bfloat16), *a[1:])):
        whole = fn(x, q4, s4)
        assert torch.equal(fn(x[:32], q4, s4), whole[:32])
        for row in (0, 17, 31):
            assert torch.equal(fn(x[row : row + 1], q4, s4)[0], whole[row])


def test_int4_kernels_refuse_what_they_cannot_take(cuda):
    int4, x, q4, s4 = _int4_case(cuda, 512, 256, 128, 4)
    with pytest.raises(ValueError, match="share a device"):
        int4.w4a8_matmul(x, q4.cpu(), s4)
    for k, n, gsz in ((384, 128, 128), (512, 192, 128), (512, 256, 64)):  # K % 256, N % 128, gsz % 128
        _, xb, qb, sb = _int4_case(cuda, k, n, gsz, 4)
        for fn in (int4.w4a8_matmul, int4.w4a16_matmul):
            with pytest.raises(ValueError, match="kernel needs"):
                fn(xb, qb, sb)
    with pytest.raises(ValueError, match="kernel needs"):
        int4.w4a8_matmul(torch.zeros((300, 512), device=cuda), q4, s4)


@pytest.mark.parametrize("mode", ["w4a8", "kernel", "xla"])
def test_mm_int4_dispatch_on_the_card(cuda, monkeypatch, mode):
    """Up to 32 rows of an eligible shape launch the mode's kernel; more rows,
    an ineligible shape and the ``xla`` mode take the grouped product."""
    import outline_rag_tpu_torch.models.decoder as dec

    monkeypatch.setattr(dec, "_INT4_MODE", mode)
    int4, x, q4, s4 = _int4_case(cuda, 512, 256, 128, 64)
    _, x2, q2, s2 = _int4_case(cuda, 384, 128, 128, 8)
    counts = lambda: (int4.w4a8_matmul.launches, int4.w4a16_matmul.launches)  # noqa: E731
    c0, quantized = counts(), int4.quantize_rows.launches
    small = dec._mm(x[:32].to(torch.bfloat16), {"q4": q4, "s4": s4}, torch.bfloat16)
    c1 = counts()
    dec._mm(x.to(torch.bfloat16), {"q4": q4, "s4": s4}, torch.bfloat16)  # M = 64
    dec._mm(x2.to(torch.bfloat16), {"q4": q2, "s4": s2}, torch.bfloat16)  # K % 256 != 0
    assert counts() == c1
    want = {"w4a8": (1, 0), "kernel": (0, 1), "xla": (0, 0)}[mode]
    assert (c1[0] - c0[0], c1[1] - c0[1]) == want and small.dtype == torch.bfloat16
    # a w4a8 projection is two launches: the row quantizer and the product
    assert int4.quantize_rows.launches - quantized == want[0]
    ref = int4.w4a16_matmul_plain(x[:32].to(torch.bfloat16), q4, s4)
    assert float((small.float() - ref).abs().max()) <= 0.03 * float(ref.abs().max())


@pytest.mark.parametrize("k,n", [(2048, 2560), (5632, 2048), (256, 8)])
def test_int4_stream_floor_kernel_is_exact(cuda, k, n):
    import outline_rag_tpu_torch.ops.int4_linear as int4

    g = torch.Generator(device=cuda).manual_seed(k)
    q4 = torch.randint(0, 256, (n, k // 2), generator=g, device=cuda, dtype=torch.uint8)
    x = torch.randn((3, k), generator=g, device=cuda).to(torch.bfloat16)
    before = int4.int4_stream_floor.launches
    value, fold = int4.int4_stream_floor(x, q4)
    torch.cuda.synchronize()
    assert int4.int4_stream_floor.launches == before + 1
    want_value, want_fold = int4.int4_stream_floor_plain(x, q4)
    assert torch.equal(value, want_value) and torch.equal(fold, want_fold)
    assert tuple(value.shape) == (n, 1) and fold.dtype == torch.int32


@pytest.mark.parametrize("mode,variant", [("fp32", "nomerge"), ("fp32", "matmul"),
                                          ("bf16", "nomerge"), ("bf16", "matmul"),
                                          ("f32x2", "nomerge")])
@pytest.mark.parametrize("n,b", [(5000, 3), (40_000, 33)])
def test_topk_floor_kernel_matches_plain(cuda, mode, variant, n, b):
    """The floor against its twin within 1e-5; `nomerge` bit-equal to the
    first column of the full scan (the same score pass; a maximum does not
    depend on order)."""
    from outline_rag_tpu_torch.ops.topk import topk_floor, topk_floor_plain

    q, c, _ = _float_case(cuda, n, 128, b, mode, seed=3)[:3]
    before = topk_floor.launches
    for tile_rows in (128, 1024):
        got = topk_floor(q, c, mode, variant, tile_rows)
        torch.cuda.synchronize()
        want = topk_floor_plain(q, c, mode, variant, tile_rows)
        assert float((got - want).abs().max()) <= 1e-5
        assert torch.equal(got, topk_floor(q, c, mode, variant, tile_rows))
    assert topk_floor.launches == before + 4
    if variant == "nomerge":
        vals, _ = topk_float(q, c, 4, None, mode)
        assert torch.equal(vals[:, 0], topk_floor(q, c, mode))


def test_int4_decoder_forward_kernels_against_twins(cuda, monkeypatch):
    """A 32-row decode step with int4 weights: the w4a8 kernel is bit-equal
    to its twin, so with the paged kernels kept the logits are equal; w4a16
    within 1e-2 of logits of order 1."""
    import outline_rag_tpu_torch.models.decoder as dec
    import outline_rag_tpu_torch.ops.int4_linear as int4

    cfg, params = _small_decoder(cuda)
    params = dec.quantize_decoder_params_int4(dec.fuse_decoder_params(params))
    toks = torch.randint(1, 512, (32, 1), generator=torch.Generator(device=cuda).manual_seed(1),
                         device=cuda)
    pos = torch.arange(32, dtype=torch.int32, device=cuda)

    def run():
        cache = dec.init_paged_cache(cfg, 32, 129, 128, device=cuda)
        cache.table[:] = torch.arange(1, 129, device=cuda).reshape(32, 4)
        with torch.inference_mode():
            return dec.decoder_forward(params, toks, cache, pos, cfg)[0]

    for mode, name, counter, twin, tol in (
            ("w4a8", "_w4a8_matmul_as", int4.w4a8_matmul, int4._w4a8_matmul_as_plain, 0.0),
            ("kernel", "_w4a16_matmul_as", int4.w4a16_matmul, int4._w4a16_matmul_as_plain,
             1e-2)):
        with monkeypatch.context() as mp:
            mp.setattr(dec, "_INT4_MODE", mode)
            before = counter.launches
            got = run()
            assert counter.launches == before + 4 * cfg.layers + 1
            mp.setattr(dec, name, twin)
            want = run()
        assert float((got - want).abs().max()) <= tol * max(1.0, float(want.abs().max()))


def test_spec_batcher_on_the_card_runs_windows_through_the_paged_kernels(cuda):
    """spec_k = 3 with int4 weights on the card: every stream ends, a
    repeated prompt is reproducible (warm == cold), the paged kernels saw
    T = 4 windows, the pages come back."""
    import outline_rag_tpu_torch.models.decoder as dec
    from outline_rag_tpu_torch.serve.decode_batcher import DONE, DecodeBatcher

    cfg, params = _small_decoder(cuda)
    params = dec.quantize_decoder_params_int4(dec.fuse_decoder_params(params))
    b = DecodeBatcher(params, cfg, slots=4, chunk_tokens=4, eos_id=0, kv_pages=17, page_size=128,
                      spec_k=3, spec_gram=2, device=cuda)

    def collect(q):
        out = []
        while True:
            item = q.get(timeout=120)
            if item is DONE:
                return out
            if isinstance(item, Exception):
                raise item
            out.extend(item)

    try:
        prompt = [(7 * i) % 500 + 1 for i in range(300)]
        cold = collect(b.submit(prompt, 0.8, 0.9, 12, seed=5))
        warm = collect(b.submit(prompt, 0.8, 0.9, 12, seed=5))
        st = b.stats()
    finally:
        b.close()
    assert warm == cold and 0 < len(cold) <= 12
    assert st["spec_tokens_per_step"] >= 1.0 and st["active"] == 0
    assert st["pages_free"] + st["pages_cached"] == st["pages_total"]


def _lifecycle(dev, tmp_path):
    """Growth, churn compaction and a snapshot round trip of a small int8r
    index with a ColBERT cache: the answers after each step."""
    import numpy as np

    from outline_rag_tpu_torch.index import VectorIndex

    index = VectorIndex(dim=64, capacity=1024, dtype="int8r", device=dev, token_width=8,
                        colbert_rank=4)
    index.colbert_proj = np.eye(16, 4, dtype=np.float32)
    rng = np.random.default_rng(0)

    def add(source, n):
        index.add_chunks(
            [f"{source}:{i}" for i in range(n)],
            rng.integers(-20, 21, (n, 64)).astype(np.float32), source,
            token_ids=rng.integers(3, 500, (n, 8)).astype(np.int32),
            colbert_codes=rng.integers(-127, 128, (n, 8, 4)).astype(np.int8),
            colbert_scales=rng.random((n, 8)).astype(np.float32),
        )

    queries = np.random.default_rng(1).integers(-20, 21, (6, 64)).astype(np.float32)
    answers = []
    for s in range(5):
        add(f"s{s}", 200)
    add("s1", 200)  # no free row: compacts at 1,024
    answers.append((index.capacity, index.query(queries, 12)))
    add("s9", 300)  # grows to 2,048
    answers.append((index.capacity, index.query(queries, 12)))
    index.save(str(tmp_path / "snap"))
    loaded = VectorIndex.load(str(tmp_path / "snap"), device=dev)
    index.adopt(loaded)
    answers.append((index.capacity, index.query(queries, 12)))
    codes = {c: index.tokens.colbert.codes[r].cpu() for c, r in index._by_chunk.items()}
    return answers, codes


def test_index_lifecycle_on_the_card_matches_the_cpu(cuda, tmp_path):
    before = topk_int8.launches
    got, got_codes = _lifecycle(cuda, tmp_path / "card")
    assert topk_int8.launches > before
    want, want_codes = _lifecycle(torch.device("cpu"), tmp_path / "cpu")
    assert [cap for cap, _ in got] == [cap for cap, _ in want] == [1024, 2048, 2048]
    for (_, (gids, gvals)), (_, (wids, wvals)) in zip(got, want):
        assert gids == wids
        assert abs(gvals - wvals).max() <= 1e-6
    assert got_codes.keys() == want_codes.keys()
    assert all(torch.equal(got_codes[c], want_codes[c]) for c in got_codes)


def _hybrid_run(dev):
    """The hybrid fused query of a tiny seeded encoder with both heads over
    an int8r index with lexical weights and ColBERT codes, cached and
    recompute forms."""
    import numpy as np

    from outline_rag_tpu_torch.engine import EncoderEmbedder, fused_query
    from outline_rag_tpu_torch.index import VectorIndex
    from outline_rag_tpu_torch.models import (
        EncoderConfig,
        init_colbert_head,
        init_encoder,
        init_reranker,
        init_sparse_head,
    )
    from outline_rag_tpu_torch.models.tokenizer import HashTokenizer

    cfg = EncoderConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    enc = init_encoder(cfg, gen, "cpu")
    with torch.no_grad():  # a trunk wider than the init's std 0.02, as the CPU tests use
        for p in enc.parameters():
            if p.dim() == 2:
                p.mul_(25)
    enc = init_colbert_head(init_sparse_head(enc, gen), gen).to(dev)
    rr = init_reranker(cfg, gen, "cpu").to(dev)
    tok = HashTokenizer(cfg.vocab_size)
    emb = EncoderEmbedder(enc, tok, max_tokens=64, seq_buckets=(32, 64))
    index = VectorIndex(dim=64, capacity=1024, dtype="int8r", device=dev, token_width=32,
                        colbert_rank=16)
    proj = index.colbert_projection_for(64)
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(40)]
    texts = [" ".join(rng.choice(words, rng.integers(4, 20))) for _ in range(200)]
    tb = tok.batch(texts, 32, buckets=(32,))
    codes, scales = emb.colbert_cache(tb.input_ids, tb.attention_mask, 16, proj)
    index.add_chunks([f"c{i}" for i in range(200)], emb.embed(texts), "s",
                     token_ids=tb.input_ids, token_mask=tb.attention_mask,
                     token_weights=emb.token_weights(tb.input_ids, tb.attention_mask),
                     colbert_codes=codes, colbert_scales=scales)
    q = tok.batch([" ".join(words[i : i + 5]) for i in range(0, 30, 6)], 64, buckets=(64,))
    state, _ = index.snapshot()
    t, cb = index.tokens.state, index.tokens.colbert
    out = {}
    with torch.no_grad():
        for form in ("cached", "recompute"):
            cached = form == "cached"
            out[form] = [x.cpu() for x in fused_query(
                enc, rr, torch.as_tensor(q.input_ids, device=dev),
                torch.as_tensor(q.attention_mask, device=dev), state.vectors, state.scales,
                state.penalty, t.ids, t.mask, state.residual, top_k=12, rerank_k=3,
                tok_weights=t.weights, tok_cvecs=cb.codes if cached else None,
                tok_cscale=cb.scales if cached else None,
                colbert_proj=torch.as_tensor(proj, device=dev) if cached else None,
                lex_weight=0.3, colbert_weight=0.2,
            )]
    return out


def test_hybrid_fused_query_on_the_card_matches_the_cpu(cuda):
    before = topk_int8.launches
    got = _hybrid_run(cuda)
    assert topk_int8.launches > before
    want = _hybrid_run(torch.device("cpu"))
    for form in ("cached", "recompute"):
        g, w = got[form], want[form]
        assert torch.equal(g[3], w[3])  # retrieval rows
        assert (g[4] - w[4]).abs().max() <= 1e-5
        assert torch.equal(g[0], w[0])  # rerank rows
        assert (g[1] - w[1]).abs().max() <= 1e-4 and (g[2] - w[2]).abs().max() <= 1e-4
