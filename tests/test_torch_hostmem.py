"""Parity of the port's host-resident planes (``ops/hostmem.py``) with the
JAX package's, on the CPU.

The JAX side places its planes with ``to_pinned_host`` and gathers their
rows on its CPU backend, as ``tests/test_hostmem.py`` does; its append
needs a TPU-only placement call, so the port's append is held to the
scatter that JAX's append runs (``lax.scatter`` in ``FILL_OR_DROP`` mode)
and to ``.at[idx].set(rows, mode="drop")``. The port's host plane here is
``to_pinned_host(..., device="cpu")``: PyTorch page-locks only with a CUDA
device, and on a CPU tensor every wrapper runs its kernel's plain twin.
The kernels themselves are held to the twins on the card
(``tests/test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outline_rag_tpu.ops import hostmem as jh
from outline_rag_tpu.ops import quant as jq
from outline_rag_tpu_torch.ops import hostmem as ph
from outline_rag_tpu_torch.ops import quant as pq
from outline_rag_tpu_torch.ops.hostres import host_residual_topk
from outline_rag_tpu_torch.ops.topk import NEG

torch.set_num_threads(1)

N = 2048


def _plane(seed, n, d, dtype=np.int8):
    rng = np.random.default_rng(seed)
    if dtype == np.int8:
        return rng.integers(-127, 128, size=(n, d), dtype=np.int8)
    return rng.standard_normal((n, d)).astype(dtype)


def _port_plane(plane, where):
    return torch.from_numpy(plane.copy()) if where == "device" else ph.to_pinned_host(plane, "cpu")


@pytest.mark.parametrize("where", ["device", "host"])
@pytest.mark.parametrize("d,dtype", [(128, np.int8), (100, np.int8), (16, np.int8), (40, np.float32)],
                         ids=["int8-128", "int8-100", "int8-16", "f32-40"])
def test_gather_rows_matches_jax(where, d, dtype):
    plane = _plane(d, N, d, dtype)
    idx = np.random.default_rng(1).integers(0, N, size=(6, 64)).astype(np.int32)
    jplane = jnp.asarray(plane) if where == "device" else jh.to_pinned_host(plane)
    want = np.asarray(jax.jit(jh.gather_rows)(jplane, jnp.asarray(idx)))
    got = ph.gather_rows(_port_plane(plane, where), torch.from_numpy(idx))
    assert got.shape == (6, 64, d) and got.dtype == torch.from_numpy(plane).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("where", ["device", "host"])
def test_out_of_range_index_gives_a_zero_row(where):
    """JAX promises in-range indices; the port defines the rest: a row of
    zeros, and the plane is never read outside ``[0, N)``."""
    plane = _plane(3, N, 100)
    idx = np.array([[0, -1, N - 1, N], [N + 7, 5, -(2**31), 2**31 - 1]], dtype=np.int32)
    got = ph.gather_rows(_port_plane(plane, where), torch.from_numpy(idx)).numpy()
    ok = (idx >= 0) & (idx < N)
    np.testing.assert_array_equal(got[ok], plane[idx[ok]])
    assert not got[~ok].any()
    assert ph.gather_rows_plain(torch.from_numpy(plane[:0]), torch.from_numpy(idx)).shape == (2, 4, 100)


def test_out_of_range_rows_where_jax_defines_them_otherwise():
    """A deliberate divergence (ROADMAP Queue 3): JAX's device route is
    ``jnp.take``, which fills a row past the plane with the type's minimum
    and wraps a negative index to a row from the end; its host route
    promises in-range indices. The port's host route gives a row of zeros,
    in its kernel and twin alike (a CPU plane is a host plane); its route
    for a plane on the card is ``plane[idx]``, for in-range indices."""
    plane = _plane(13, 16, 8)
    idx = np.array([[16, -1, 2]], dtype=np.int32)
    jax_rows = np.asarray(jh.gather_rows(jnp.asarray(plane), jnp.asarray(idx)))
    assert (jax_rows[0, 0] == -128).all() and (jax_rows[0, 1] == plane[15]).all()
    port_rows = ph.gather_rows(torch.from_numpy(plane), torch.from_numpy(idx)).numpy()
    assert not port_rows[0, :2].any() and (port_rows[0, 2] == jax_rows[0, 2]).all()


def test_host_residency():
    plane = _plane(4, 64, 16)
    assert jh.is_host_resident(jh.to_pinned_host(plane)) and not jh.is_host_resident(jnp.asarray(plane))
    host = ph.to_pinned_host(plane, device="cpu")
    assert ph.is_host_resident(host) and host.device.type == "cpu"
    assert not ph.is_host_resident(torch.empty((64, 16), device="meta"))
    assert not ph.is_host_resident(plane)  # a numpy array is not a placed plane


def test_to_pinned_host_on_the_cpu_is_a_copy():
    plane = _plane(5, 64, 16)
    for src in (plane, torch.from_numpy(plane)):
        host = ph.to_pinned_host(src, device="cpu")
        assert host.dtype == torch.int8 and tuple(host.shape) == (64, 16) and host.is_contiguous()
        host[0] = 0
        assert plane[0].any()  # the caller's array is untouched
    strided = ph.to_pinned_host(plane[:, ::2], device="cpu")
    np.testing.assert_array_equal(strided.numpy(), plane[:, ::2])


def test_to_pinned_host_defaults_to_the_card():
    """Page-locking needs a CUDA device: without one the default placement
    raises instead of quietly handing back pageable memory."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py pins for it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ph.to_pinned_host(_plane(6, 8, 16))


def _jax_append(plane, rows, idx):
    """The scatter of JAX's ``make_host_append`` (``FILL_OR_DROP``), on the
    CPU backend's default memory."""
    dnums = jax.lax.ScatterDimensionNumbers(
        update_window_dims=(1,), inserted_window_dims=(0,), scatter_dims_to_operand_dims=(0,))
    out = jax.lax.scatter(jnp.asarray(plane), jnp.asarray(idx)[:, None], jnp.asarray(rows), dnums,
                          mode=jax.lax.GatherScatterMode.FILL_OR_DROP)
    return np.asarray(out)


@pytest.mark.parametrize("d", [128, 100, 16, 8])
def test_host_append_matches_jax_drop_scatter(d):
    plane = _plane(7, N, d)
    rows = _plane(8, 40, d)
    rng = np.random.default_rng(9)
    idx = rng.choice(N, size=40, replace=False).astype(np.int32)
    idx[[3, 17]] = [N, N + 100]  # past the plane: dropped
    host = ph.to_pinned_host(plane, device="cpu")
    append = ph.make_host_append()
    out = append(host, torch.from_numpy(rows), torch.from_numpy(idx))
    assert out is host  # written in place, the same tensor returned
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jnp.asarray(plane).at[jnp.asarray(idx)].set(rows, mode="drop")))
    np.testing.assert_array_equal(out.numpy(), _jax_append(plane, rows, idx))
    # negative indices: JAX's append drops them (lax.scatter), as the port does
    idx[[5, 9]] = [-1, -(2**31)]
    host = ph.to_pinned_host(plane, device="cpu")
    append(host, torch.from_numpy(rows), idx)
    np.testing.assert_array_equal(host.numpy(), _jax_append(plane, rows, idx))


def test_host_append_refuses_a_plane_on_no_host():
    with pytest.raises(ValueError, match="host plane"):
        ph.host_scatter_rows(torch.empty((4, 16), dtype=torch.int8, device="meta"),
                             torch.zeros((1, 16), dtype=torch.int8), torch.zeros(1, dtype=torch.int32))
    host = ph.to_pinned_host(_plane(10, 4, 16), device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        ph.make_host_append()(host, torch.zeros((1, 8), dtype=torch.int8), [0])


def _int8r_case(seed, n=N, d=128, b=7):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    corpus[900] = corpus[40]  # an exact tie after the rescore
    queries = rng.standard_normal((b, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    queries[0] = corpus[40]
    penalty = np.where(rng.random(n) < 0.05, NEG, 0.0).astype(np.float32)
    penalty[[40, 900]] = 0.0
    return corpus, queries, penalty


def test_int8_topk_with_host_residual_matches_jax():
    """The product path: the int8r rescore reading q2 from a host plane ranks
    as JAX's does with its q2 in pinned host memory, and bit for bit as the
    port's own rescore with q2 beside q1."""
    corpus, queries, penalty = _int8r_case(11)
    q1, cs, q2 = jq.quantize_rows_int8_residual(jnp.asarray(corpus))
    qq, qs = jq.quantize_rows_int8(jnp.asarray(queries))
    jv, ji = jq.int8_topk(qq, qs, q1, cs, 12, jnp.asarray(penalty), impl="xla",
                          rescore_queries=jnp.asarray(queries), rescore_m=64,
                          rescore_residual=jh.to_pinned_host(np.asarray(q2)))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    args = (t(qq), t(qs), t(q1), t(cs), 12, t(penalty))
    kw = {"rescore_queries": t(queries), "rescore_m": 64}
    pv, pi = pq.int8_topk(*args, **kw, rescore_residual=ph.to_pinned_host(np.asarray(q2), "cpu"))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    assert list(pi[0, :2]) == [40, 900]  # tie: lower row first
    dv, di = pq.int8_topk(*args, **kw, rescore_residual=t(q2))
    assert torch.equal(pi, di) and torch.equal(pv, dv)


def test_host_tier_on_the_host_planes_view_matches_the_device_rescore():
    """The host tier as the card runs it: the device's candidates, then
    ``host_residual_topk`` on the host plane's numpy view (no second copy)."""
    corpus, queries, penalty = _int8r_case(12)
    q1, cs, q2 = pq.quantize_rows_int8_residual(torch.from_numpy(corpus))
    qq, qs = pq.quantize_rows_int8(torch.from_numpy(queries))
    host = ph.to_pinned_host(q2, "cpu")
    pen, qf = torch.from_numpy(penalty), torch.from_numpy(queries)
    dv, di = pq.int8_topk(qq, qs, q1, cs, 12, pen, rescore_queries=qf, rescore_residual=host)
    scores, idx, scale = pq.int8_topk_candidates(qq, qs, q1, cs, 64, qf, pen)
    view = host.numpy()
    assert np.shares_memory(view, host.numpy())
    hv, hi = host_residual_topk(scores.numpy(), idx.numpy(), scale.numpy(), queries, view, 12)
    np.testing.assert_array_equal(hi, di.numpy())
    np.testing.assert_allclose(hv, dv.numpy(), rtol=0, atol=1e-6)


def _hostmem_mutants():
    from outline_rag_tpu_torch.tools import kernel_mutants

    return [pytest.param(old, new, id=name)
            for name, (old, new) in kernel_mutants.HOSTMEM_MUTANTS.items() if old]


@pytest.mark.parametrize("old,new", _hostmem_mutants())
def test_every_hostmem_mutant_edit_applies_to_the_source(old, new):
    """The card tool edits copies of ``csrc/hostmem.cu`` by text and refuses
    an edit whose text occurs another number of times: each one still finds
    its line, and changes it."""
    from outline_rag_tpu_torch.ops import _build

    assert old != new
    assert (_build.CSRC_DIR / "hostmem.cu").read_text().count(old) == 1


def test_hostmem_mutants_are_listed():
    from outline_rag_tpu_torch.tools import kernel_mutants

    assert kernel_mutants.KERNELS["hostmem"] is kernel_mutants.hostmem_mutants
    assert {"as_is", "row_offset_in_32_bits", "tail_dropped"} <= set(kernel_mutants.HOSTMEM_MUTANTS)
