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


def _int8_source_edits():
    from outline_rag_tpu_torch.tools import ablate_int8_linear, kernel_mutants

    for name, (old, new) in kernel_mutants.LINEAR_MUTANTS.items():
        if old:
            yield pytest.param((old, new, 1), id=f"mutant-{name}")
    for name, edits in ablate_int8_linear.VARIANTS.items():
        for i, edit in enumerate(edits):
            yield pytest.param(edit, id=f"ablation-{name}-{i}")


@pytest.mark.parametrize("edit", list(_int8_source_edits()))
def test_every_int8_mutant_and_ablation_edit_applies_to_the_source(edit):
    """The card tools edit a copy of ``csrc/int8_linear.cu`` and refuse an
    edit whose text occurs another number of times: each one still finds
    its line, and changes it."""
    from outline_rag_tpu_torch.ops import _build

    old, new, occurrences = edit
    assert old != new
    assert (_build.CSRC_DIR / "int8_linear.cu").read_text().count(old) == occurrences


def test_a_mutant_finds_the_shared_headers(tmp_path, monkeypatch):
    """A mutant is a copy built outside ``csrc/``: its ``#include`` of a
    shared header resolves through the include path, and every header the
    kernels include is there."""
    import re
    import subprocess

    from outline_rag_tpu_torch.ops import _build
    from outline_rag_tpu_torch.tools import kernel_mutants

    for cu in _build.CSRC_DIR.glob("*.cu"):
        for header in re.findall(r'#include "([^"]+)"', cu.read_text()):
            assert (_build.CSRC_DIR / header).exists(), (cu.name, header)
    commands = []
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernel_mutants.subprocess, "run", lambda cmd, **kw: (
        commands.append(cmd), subprocess.CompletedProcess(cmd, 1, "", "stop"))[1])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernel_mutants.build_mutant(tmp_path, _build.CSRC_DIR / "int8_linear.cu", "as_is", "")
    (cmd,) = commands
    assert cmd[cmd.index("-I") + 1] == str(_build.CSRC_DIR)
    assert (tmp_path / "int8_linear_as_is.cu").read_text() == (
        _build.CSRC_DIR / "int8_linear.cu").read_text()


def test_ablate_times_every_variant_and_checks_only_the_held_ones(tmp_path, monkeypatch, capsys):
    """The ablation driver builds each variant with its own edits, binds it,
    times every run, holds only the named variants to the twin, prints one
    JSON line a variant, and binds the package's library again at the end,
    also when a build fails."""
    import json

    from outline_rag_tpu_torch.tools import kernel_mutants

    built, bound, calls = [], [], []
    monkeypatch.setattr(kernel_mutants, "build_mutant",
                        lambda tmp, source, name, edits: built.append((name, edits)) or name)
    monkeypatch.setattr(kernel_mutants, "cuda_ms_many",
                        lambda fn: (fn(), {"device_ms": 0.5})[1])
    runs = [("a", lambda: calls.append("a"), lambda: True),
            ("b", lambda: calls.append("b"), lambda: False)]
    variants = {"base": [], "cut": [("x", "y", 1)]}
    kernel_mutants.ablate(tmp_path / "k.cu", variants, bound.append, runs, ("base",))
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert built == list(variants.items())
    assert bound == ["base", "cut", None]
    assert calls == ["a", "b"] * 2
    assert rows == [{"variant": "base", "ok_a": True, "a": 0.5, "ok_b": False, "b": 0.5},
                    {"variant": "cut", "a": 0.5, "b": 0.5}]

    def fails(tmp, source, name, edits):
        raise RuntimeError(f"{name}: nvcc failed")

    bound.clear()
    monkeypatch.setattr(kernel_mutants, "build_mutant", fails)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernel_mutants.ablate(tmp_path / "k.cu", variants, bound.append, runs, ("base",))
    assert bound == [None]
