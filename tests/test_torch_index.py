"""The port's VectorIndex (every dtype: float32, bfloat16, f32x2, int8,
int8r) against the JAX package's: the same adds, deletes and queries return
the same chunk ids, and scores within 1e-5 (1e-6 in the int8 modes)."""

import numpy as np
import pytest
import torch

from outline_rag_tpu.index.store import VectorIndex as JaxIndex
from outline_rag_tpu_torch.index import VectorIndex
from outline_rag_tpu_torch.index.shard import DeviceShard
from outline_rag_tpu_torch.ops.topk import NEG

torch.set_num_threads(1)

DIM, CAP = 64, 2048
DTYPES = ["float32", "bfloat16", "f32x2", "int8", "int8r"]


def _vectors(seed, n):
    return np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)


def _fill(index, seed=0, sources=6, per_source=40):
    for s in range(sources):
        vecs = _vectors(seed * 100 + s, per_source)
        index.add_chunks([f"d{s}:{i}" for i in range(per_source)], vecs, source_id=f"d{s}")


def _pair(dtype):
    jax_index = JaxIndex(dim=DIM, capacity=CAP, dtype=dtype)
    port_index = VectorIndex(dim=DIM, capacity=CAP, dtype=dtype, device="cpu")
    _fill(jax_index)
    _fill(port_index)
    return jax_index, port_index


def _assert_same_answers(jax_index, port_index, queries, k):
    """Same ids and scores. Float modes sum in another order than the JAX
    package's XLA dot: 1e-5; the int8 modes' exact rescore: 1e-6."""
    jids, jvals = jax_index.query(queries, k)
    pids, pvals = port_index.query(queries, k)
    assert pids == jids
    live = pvals > NEG / 2
    tol = 1e-6 if port_index.dtype in ("int8", "int8r") else 1e-5
    np.testing.assert_allclose(pvals[live], np.asarray(jvals)[live], rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_add_and_query_match_jax(dtype):
    jax_index, port_index = _pair(dtype)
    queries = _vectors(99, 9)
    queries[0] = _vectors(3, 40)[7]  # an indexed vector: finds itself first
    _assert_same_answers(jax_index, port_index, queries, 12)
    assert port_index.query(queries[:1], 1)[0] == [["d3:7"]]
    assert port_index.size == jax_index.size == 240


@pytest.mark.parametrize("dtype", DTYPES)
def test_delete_and_replace_match_jax(dtype):
    jax_index, port_index = _pair(dtype)
    for index in (jax_index, port_index):
        assert index.delete_source("d1") == 40
        assert index.delete_chunks(["d2:0", "d2:5", "missing"]) == 2
        # replace: the source's old chunks are tombstoned first
        index.add_chunks(["d4:new"], _vectors(7, 1), source_id="d4")
    queries = _vectors(98, 8)
    _assert_same_answers(jax_index, port_index, queries, 12)
    ids, _ = port_index.query(queries, 64)
    flat = {c for row in ids for c in row}
    assert not {c for c in flat if c.startswith("d1:")}
    assert not flat & {"d2:0", "d2:5", "d4:0"}
    assert port_index.size == jax_index.size == 240 - 40 - 2 - 40 + 1


def test_fewer_live_rows_than_k_returns_each_once():
    _assert_fewer_live_rows_than_k_returns_each_once("int8r")


def test_fewer_live_rows_than_k_returns_each_once_f32x2():
    _assert_fewer_live_rows_than_k_returns_each_once("f32x2")


def _assert_fewer_live_rows_than_k_returns_each_once(dtype):
    index = VectorIndex(dim=DIM, capacity=1024, dtype=dtype, device="cpu")
    index.add_chunks([f"c{i}" for i in range(10)], _vectors(5, 10), source_id="s")
    ids, vals = index.query(_vectors(6, 3), 12)
    for row in ids:
        assert len(row) == len(set(row)) == 10
    assert (vals[:, 10:] == np.float32(NEG)).all()


def test_add_past_capacity_raises_and_changes_nothing(monkeypatch):
    """An add that needs a growth the device cannot hold (the memory check
    patched to refuse) raises before it tombstones anything."""
    index = VectorIndex(dim=DIM, capacity=1024, dtype="int8", device="cpu")
    index.add_chunks([f"a{i}" for i in range(1000)], _vectors(1, 1000), source_id="a")
    monkeypatch.setattr(index, "_growth_would_fit", lambda cap: False)
    with pytest.raises(RuntimeError, match="terminal capacity"):
        index.add_chunks([f"b{i}" for i in range(1100)], _vectors(2, 1100), source_id="a")
    assert index.size == 1000  # the refused replace tombstoned nothing
    assert index.capacity == 1024
    assert index.query(_vectors(1, 1000)[:1], 1)[0] == [["a0"]]


def test_shard_state_layout():
    """Storage as the JAX package's init_state lays it out."""
    int8 = DeviceShard(1024, DIM, "int8", "cpu").state
    int8r = DeviceShard(1024, DIM, "int8r", "cpu").state
    assert tuple(int8.residual.shape) == (1024, 0)
    assert tuple(int8r.residual.shape) == (1024, DIM)
    assert int8.vectors.dtype == torch.int8 and int8.penalty.dtype == torch.float32
    assert (int8.penalty == NEG).all()
    for dtype, storage, width in (
        ("float32", torch.float32, DIM),
        ("bfloat16", torch.bfloat16, DIM),
        ("f32x2", torch.bfloat16, 2 * DIM),
    ):
        state = DeviceShard(1024, DIM, dtype, "cpu").state
        assert state.vectors.dtype == storage and tuple(state.vectors.shape) == (1024, width)
        assert tuple(state.residual.shape) == (1024, 0) and (state.scales == 1).all()
    with pytest.raises(ValueError, match="index dtype"):
        DeviceShard(1024, DIM, "float16", "cpu")


def test_default_dtype_matches_jax():
    """Both packages default to a float32 index, with the same answers."""
    jax_index = JaxIndex(dim=DIM, capacity=CAP)
    port_index = VectorIndex(dim=DIM, capacity=CAP, device="cpu")
    assert port_index.dtype == jax_index.dtype == "float32"
    assert port_index.snapshot()[0].vectors.dtype == torch.float32
    _fill(jax_index)
    _fill(port_index)
    _assert_same_answers(jax_index, port_index, _vectors(97, 6), 12)


def test_f32x2_rows_are_split_once_at_ingest():
    """The f32x2 index stores the normalized rows as the JAX package's
    split_f32_bf16x2 lays them out (the norms themselves may round 1 ulp
    apart between numpy and torch)."""
    from outline_rag_tpu.ops.topk import split_f32_bf16x2 as jax_split
    from outline_rag_tpu_torch.index.store import normalize_rows

    index = VectorIndex(dim=DIM, capacity=1024, dtype="f32x2", device="cpu")
    vecs = _vectors(8, 5)
    rows = index.add_chunks([f"c{i}" for i in range(5)], vecs, source_id="s")
    unit = normalize_rows(torch.from_numpy(vecs)).numpy()
    want = np.asarray(jax_split(unit)).view(np.uint16)
    got = index.snapshot()[0].vectors[rows].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


def test_token_cache_rows_written_at_assigned_rows():
    index = VectorIndex(dim=DIM, capacity=1024, dtype="int8r", device="cpu", token_width=8)
    ids = np.arange(3 * 10, dtype=np.int32).reshape(3, 10) + 3
    rows = index.add_chunks(["x", "y", "z"], _vectors(4, 3), source_id="s", token_ids=ids)
    cache = index.tokens.state
    np.testing.assert_array_equal(cache.ids[rows].numpy(), ids[:, :8])
    assert cache.mask[rows].sum().item() == 24
    assert (cache.ids[3:].numpy() == 1).all() and cache.mask[3:].sum().item() == 0


def test_cuda_device_refused_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VectorIndex(dim=DIM, capacity=1024, device="cuda")
