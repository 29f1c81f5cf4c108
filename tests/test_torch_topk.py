"""Parity of the port's int8 scan top-K with the JAX package's Pallas
kernel (interpret mode on the CPU), and of its oracle and merge helpers.

Inputs come from numpy with a seed and go to both packages. On CPU tensors
``topk_int8`` runs its plain PyTorch twin; the CUDA kernel itself is held
to that twin on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from outline_rag_tpu.ops.quant import int8_topk as jax_int8_topk
from outline_rag_tpu.ops.topk import merge_topk as jax_merge_topk
from outline_rag_tpu.ops.topk import topk_xla
from outline_rag_tpu_torch.ops import topk as port_topk
from outline_rag_tpu_torch.ops.topk import (
    NEG,
    merge_topk,
    topk_int8,
    topk_int8_plain,
    topk_plain,
)

torch.set_num_threads(1)

N, D = 2048, 64
BLOCK_N = 256


def _int8_case(seed, b, n_dead_frac=0.05, n_live=None):
    """Seeded int8 codes and scales with tombstones, and 9 copies of one
    row (query 0 is that row, so the copies tie at its top)."""
    rng = np.random.default_rng(seed)
    corpus = rng.integers(-127, 128, (N, D), dtype=np.int8)
    cscale = (rng.uniform(0.5, 1.5, N) / 127).astype(np.float32)
    src, dups = 7, rng.choice(np.arange(8, N), 9, replace=False)
    corpus[dups] = corpus[src]
    cscale[dups] = cscale[src]
    q = rng.integers(-127, 128, (b, D), dtype=np.int8)
    q[0] = corpus[src]
    qscale = (rng.uniform(0.5, 1.5, b) / 127).astype(np.float32)
    penalty = np.where(rng.random(N) < n_dead_frac, NEG, 0.0).astype(np.float32)
    penalty[[src, *dups]] = 0.0
    if n_live is not None:
        penalty[:] = NEG
        penalty[rng.choice(N, n_live, replace=False)] = 0.0
    return q, qscale, corpus, cscale, penalty


def _jax_scan(q, qscale, corpus, cscale, penalty, k):
    v, i = jax_int8_topk(
        jnp.asarray(q), jnp.asarray(qscale), jnp.asarray(corpus),
        jnp.asarray(cscale), k, jnp.asarray(penalty), impl="pallas",
        block_n=BLOCK_N,
    )
    return np.asarray(v), np.asarray(i)


def _port_scan(fn, q, qscale, corpus, cscale, penalty, k):
    v, i = fn(
        torch.from_numpy(q), torch.from_numpy(qscale), torch.from_numpy(corpus),
        torch.from_numpy(cscale), k, torch.from_numpy(penalty),
    )
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("b", [5, 37])
@pytest.mark.parametrize("k", [12, 64])
def test_plain_scan_matches_pallas_interpret(b, k):
    case = _int8_case(b * 100 + k, b)
    jv, ji = _jax_scan(*case, k)
    pv, pi = _port_scan(topk_int8_plain, *case, k)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, jv)
    # the duplicated rows tie at query 0's top, lowest row first
    assert list(pi[0, :10]) == sorted(pi[0, :10])


def test_plain_scan_dead_slots_match_pallas_interpret():
    """Fewer live rows than K: the unfilled slots are (NEG, 0) in both."""
    case = _int8_case(3, 8, n_live=10)
    jv, ji = _jax_scan(*case, 64)
    pv, pi = _port_scan(topk_int8_plain, *case, 64)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, jv)
    assert (pv[:, 10:] == np.float32(NEG)).all() and (pi[:, 10:] == 0).all()


def test_topk_int8_on_cpu_runs_the_plain_twin():
    case = _int8_case(4, 6)
    before = topk_int8.launches
    pv, pi = _port_scan(topk_int8, *case, 12)
    qv, qi = _port_scan(topk_int8_plain, *case, 12)
    np.testing.assert_array_equal(pi, qi)
    np.testing.assert_array_equal(pv, qv)
    assert topk_int8.launches == before  # no kernel launch on the CPU


def test_topk_int8_refuses_other_devices():
    case = [torch.from_numpy(x).to("meta") for x in _int8_case(5, 2)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        topk_int8(case[0], case[1], case[2], case[3], 12, case[4])


def test_plain_scan_steps_merge_in_row_order(monkeypatch):
    """Scoring in several row steps (merged with merge_topk) gives the
    one-step answer, ties included."""
    case = _int8_case(6, 9)
    whole = _port_scan(topk_int8_plain, *case, 64)
    monkeypatch.setattr(port_topk, "PLAIN_ROWS_PER_STEP", 300)
    stepped = _port_scan(topk_int8_plain, *case, 64)
    np.testing.assert_array_equal(stepped[1], whole[1])
    np.testing.assert_array_equal(stepped[0], whole[0])


def test_topk_plain_matches_topk_xla():
    rng = np.random.default_rng(7)
    c = rng.standard_normal((N, D)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c[100] = c[5]  # a tie
    q = rng.standard_normal((6, D)).astype(np.float32)
    q[0] = c[5]
    pen = np.where(rng.random(N) < 0.1, NEG, 0.0).astype(np.float32)
    pen[[5, 100]] = 0.0
    jv, ji = topk_xla(jnp.asarray(q), jnp.asarray(c), 12, jnp.asarray(pen))
    pv, pi = topk_plain(torch.from_numpy(q), torch.from_numpy(c), 12, torch.from_numpy(pen))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    assert list(pi[0, :2].numpy()) == [5, 100]


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(8)
    va = np.sort(rng.integers(0, 5, (4, 6)).astype(np.float32), axis=1)[:, ::-1].copy()
    vb = np.sort(rng.integers(0, 5, (4, 6)).astype(np.float32), axis=1)[:, ::-1].copy()
    ia = rng.integers(0, 100, (4, 6)).astype(np.int32)
    ib = rng.integers(100, 200, (4, 6)).astype(np.int32)
    jv, ji = jax_merge_topk(*(jnp.asarray(x) for x in (va, ia, vb, ib)), 7)
    pv, pi = merge_topk(*(torch.from_numpy(x) for x in (va, ia, vb, ib)), 7)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


def test_plain_scan_refuses_inexact_width():
    q = torch.zeros((1, 1056), dtype=torch.int8)
    c = torch.zeros((4, 1056), dtype=torch.int8)
    with pytest.raises(ValueError, match="not exact"):
        topk_int8_plain(q, torch.ones(1), c, torch.ones(4), 2)
