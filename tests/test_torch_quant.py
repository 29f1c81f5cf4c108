"""Parity of the port's row quantizers and quantized top-K with the exact
rescore against the JAX package (``ops/quant.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from outline_rag_tpu.ops import quant as jq
from outline_rag_tpu_torch.ops import quant as pq
from outline_rag_tpu_torch.ops.topk import NEG

torch.set_num_threads(1)


def _unit_rows(seed, n, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_quantize_rows_int8_bytes_equal():
    x = _unit_rows(0, 300, 64)
    x[3] = 0.0  # a zero row gets scale 0
    x[4, :2] = [0.5, -0.5]  # exact .5 ties round half to even
    jcodes, jscale = jq.quantize_rows_int8(jnp.asarray(x))
    pcodes, pscale = pq.quantize_rows_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(pcodes.numpy(), np.asarray(jcodes))
    assert pscale.numpy().tobytes() == np.asarray(jscale).tobytes()


def test_quantize_rows_int8_residual_bytes_equal():
    x = _unit_rows(1, 300, 64)
    j1, js, j2 = jq.quantize_rows_int8_residual(jnp.asarray(x))
    p1, ps, p2 = pq.quantize_rows_int8_residual(torch.from_numpy(x))
    np.testing.assert_array_equal(p1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(p2.numpy(), np.asarray(j2))
    assert ps.numpy().tobytes() == np.asarray(js).tobytes()


def test_dequantize_rows_int8_matches():
    x = _unit_rows(2, 50, 64)
    codes, scale = jq.quantize_rows_int8(jnp.asarray(x))
    want = np.asarray(jq.dequantize_rows_int8(codes, scale))
    got = pq.dequantize_rows_int8(
        torch.from_numpy(np.array(codes)), torch.from_numpy(np.array(scale))
    )
    np.testing.assert_array_equal(got.numpy(), want)


def _rescore_case(seed, n=2048, d=64, b=7, n_live=None):
    rng = np.random.default_rng(seed)
    corpus = _unit_rows(seed, n, d)
    corpus[900] = corpus[40]  # exact duplicate: a tie after the rescore
    queries = _unit_rows(seed + 1, b, d)
    queries[0] = corpus[40]
    penalty = np.where(rng.random(n) < 0.05, NEG, 0.0).astype(np.float32)
    penalty[[40, 900]] = 0.0
    if n_live is not None:
        penalty[:] = NEG
        penalty[rng.choice(n, n_live, replace=False)] = 0.0
    return queries, corpus, penalty


def _both_int8_topk(queries, corpus, penalty, k, residual, impl):
    q1, cs, q2 = jq.quantize_rows_int8_residual(jnp.asarray(corpus))
    qq, qs = jq.quantize_rows_int8(jnp.asarray(queries))
    jv, ji = jq.int8_topk(
        qq, qs, q1, cs, k, jnp.asarray(penalty), impl=impl, block_n=256,
        rescore_queries=jnp.asarray(queries),
        rescore_residual=q2 if residual else None,
    )
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    pv, pi = pq.int8_topk(
        t(qq), t(qs), t(q1), t(cs), k, t(penalty), rescore_queries=t(queries),
        rescore_residual=t(q2) if residual else None,
    )
    return np.asarray(jv), np.asarray(ji), pv.numpy(), pi.numpy()


@pytest.mark.parametrize("residual", [False, True], ids=["int8", "int8r"])
def test_int8_topk_rescore_matches_jax(residual):
    queries, corpus, penalty = _rescore_case(3)
    jv, ji, pv, pi = _both_int8_topk(queries, corpus, penalty, 12, residual, "pallas")
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-6)
    assert list(pi[0, :2]) == [40, 900]  # tie: lower row first


def test_int8_topk_few_live_rows_has_no_duplicates():
    """10 live rows of 1,024 and 64 scan candidates: the JAX Pallas path
    rescored the scan's (NEG, 0) slots as row 0 and could return row 0
    several times; the port returns each live row once, as JAX's XLA path
    does."""
    queries, corpus, penalty = _rescore_case(4, n=1024, n_live=10)
    xv, xi, pv, pi = _both_int8_topk(queries, corpus, penalty, 12, True, "xla")
    live = pv > NEG / 2
    assert live.sum(axis=1).tolist() == [10] * len(queries)
    for row_ids, row_live in zip(pi, live):
        assert len(set(row_ids[row_live])) == 10
    np.testing.assert_array_equal(pi[live], xi[live])
    np.testing.assert_allclose(pv[live], xv[live], rtol=0, atol=1e-6)
    assert (pv[~live] == np.float32(NEG)).all()


def test_rescore_fp32_matches():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((3, 64)).astype(np.float32)
    rows = rng.standard_normal((3, 9, 64)).astype(np.float32)
    want = np.asarray(jq.rescore_fp32(jnp.asarray(q), jnp.asarray(rows)))
    got = pq.rescore_fp32(torch.from_numpy(q), torch.from_numpy(rows)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
