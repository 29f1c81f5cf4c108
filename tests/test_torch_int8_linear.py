"""The port's int8 linears on the CPU against the JAX package on the same
numpy inputs: the weight quantizer byte for byte, the w8a8 product (exact
integers, so only the f32 rescale can differ: 1e-6 relative), and the
w8a16 kernel's plain twin against the Pallas kernel in interpret mode
(bf16 outputs within one bf16 ulp, f32 outputs within 1e-5 of the output's
scale: the f32 sums run in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outline_rag_tpu.ops import int8_linear as jlin
from outline_rag_tpu_torch.ops.int8_linear import (
    int8_linear,
    int8_linear_plain,
    quantize_linear_weight,
    w8a8_matmul,
)


def weights(k, n, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    w[:, 1] = 0.0  # an all-zero channel takes the 1e-12 floor
    return w


@pytest.mark.parametrize("k,n", [(64, 48), (96, 40), (128, 256)])
def test_quantize_linear_weight_byte_equal(k, n):
    w = weights(k, n, seed=k + n)
    jq, js = jlin.quantize_linear_weight(jnp.asarray(w))
    tq, ts = quantize_linear_weight(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and tuple(tq.shape) == (n, k) and tq.is_contiguous()
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("m", [1, 8, 37])
def test_w8a8_matmul_matches_jax(m):
    rng = np.random.default_rng(m)
    w = weights(96, 40, seed=m)
    x = rng.standard_normal((m, 96)).astype(np.float32)
    x[0] = 0.0  # an all-zero row takes the 1e-12 floor
    q, s = quantize_linear_weight(torch.from_numpy(w))
    want = np.asarray(jlin.w8a8_matmul(jnp.asarray(x), jnp.asarray(q.numpy()), jnp.asarray(s.numpy())))
    got = w8a8_matmul(torch.from_numpy(x), q, s)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)


def test_w8a8_rows_are_independent():
    """A token's result never depends on its neighbours (per-row scales),
    which chunked prefill and the prefix cache rely on."""
    rng = np.random.default_rng(3)
    q, s = quantize_linear_weight(torch.from_numpy(weights(64, 24, 3)))
    x = torch.from_numpy(rng.standard_normal((6, 64)).astype(np.float32))
    assert torch.equal(w8a8_matmul(x, q, s)[2:3], w8a8_matmul(x[2:3] * 1.0, q, s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(8, 64, 48), (16, 96, 40), (64, 128, 256)])
def test_int8_linear_plain_matches_pallas_interpret(m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    q, s = quantize_linear_weight(torch.from_numpy(weights(k, n, seed=n)))
    jx = jnp.asarray(x).astype(dtype)
    want = jlin.int8_linear(jx, jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), block_n=8,
                            interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = int8_linear(tx, q, s)
    assert got.dtype == tx.dtype and tuple(got.shape) == (m, n)
    assert torch.equal(got, int8_linear_plain(tx, q, s))  # on the CPU the wrapper is the twin
    scale = np.abs(want).max()
    tol = scale * 2.0**-8 if dtype == "bfloat16" else scale * 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_int8_linear_rounds_the_scale_to_bf16_first():
    """The kernel's weight is bf16(bf16(q) * bf16(s)), not a product with
    the f32 scale: a scale that bf16 cannot hold shows the difference."""
    q = torch.full((8, 16), 100, dtype=torch.int8)
    s = torch.full((8,), 1.0 + 2.0**-10)  # rounds to 1.0 in bf16
    x = torch.ones((8, 16))
    assert torch.equal(int8_linear(x, q, s), torch.full((8, 8), 1600.0))


@pytest.mark.parametrize(
    "m,n,err", [(7, 48, "M % 8"), (8, 44, "N % 8"), (0, 48, "M % 8")],
    ids=["ragged_m", "ragged_n", "empty"],
)
def test_int8_linear_refuses_partial_tiles(m, n, err):
    x = torch.zeros((m, 64))
    with pytest.raises(ValueError, match=err):
        int8_linear(x, torch.zeros((n, 64), dtype=torch.int8), torch.ones(n))
    if m == 0:
        return  # the JAX package has no such check for an empty batch
    with pytest.raises(ValueError):  # the JAX package refuses the same shapes
        jlin.int8_linear(jnp.zeros((m, 64)), jnp.zeros((n, 64), jnp.int8), jnp.ones((n,)),
                         block_n=8, interpret=True)


def test_int8_linear_checks_dtypes_and_shapes():
    x, q, s = torch.zeros((8, 64)), torch.zeros((48, 64), dtype=torch.int8), torch.ones(48)
    with pytest.raises(ValueError, match="do not agree"):
        int8_linear(x, q[:, :32], s)
    with pytest.raises(ValueError, match="int8 weights with f32 scales"):
        int8_linear(x, q.float(), s)
    with pytest.raises(ValueError, match="bf16 or f32 activations"):
        int8_linear(x.half(), q, s)
