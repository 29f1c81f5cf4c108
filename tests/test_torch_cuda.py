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
from outline_rag_tpu_torch.testing import flash_errors, tie_aware_mismatches

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
    for name in ("topk_int8_launch", "topk_float_launch", "flash_attention_launch"):
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


def _attention_case(dev, b, s, h, lengths, seed, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, 64), generator=g, device=dev).to(dtype) for _ in range(3))
    bias = torch.zeros((b, s), device=dev)
    for i, n in enumerate(lengths):
        bias[i, n:] = NEG_BIAS
    return q, k, v, bias


# bf16: each element within 2e-3 + 2 bf16 ulps of the twin and the error's
# norm within 1e-2 of the output's (P is rounded against a running max over
# 64-key tiles in the kernel, the row max in the twin; a dropped key tile
# or a missing rescale breaks both). f32: 1e-5, the sums' order only.
FLASH_BOUNDS = {torch.bfloat16: (2e-3, 2.0, 1e-2), torch.float32: (1e-5, 0.0, 1e-5)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,s,h,lengths",
    [(1, 64, 1, [64]), (2, 200, 3, [200, 131]), (3, 1000, 2, [1000, 77, 0]), (1, 2048, 16, [1500])],
)
def test_flash_kernel_matches_plain(cuda, dtype, b, s, h, lengths):
    """Within ``FLASH_BOUNDS``; a row with no live key is exactly zero."""
    args = _attention_case(cuda, b, s, h, lengths, seed=s + b, dtype=dtype)
    before = flash_attention.launches
    out = flash_attention(*args)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
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
