"""The port's CUDA kernels on the card, held to their plain PyTorch twins.

These tests need an NVIDIA GPU (sm_90a) with ``nvcc``; elsewhere they skip.
This file imports no jax, so it runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from outline_rag_tpu_torch.ops import _build
from outline_rag_tpu_torch.ops.topk import NEG, topk_int8, topk_int8_plain

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def test_kernel_library_builds(cuda):
    built = _build.build_library()
    assert built.path.exists()
    assert _build.load_library().topk_int8_launch is not None


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
