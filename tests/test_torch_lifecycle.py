"""The port's index lifecycle against the JAX package's: growth, compaction,
generations, snapshots (both ways), ``adopt``, ``rescore_m`` and the host
rescore tier. Each test builds the same index in both packages from seeded
numpy inputs; answers must have the same ids, scores within 1e-6 in the
int8 modes and 1e-5 in the float ones."""

import json
import os
import threading
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outline_rag_tpu.index.store import VectorIndex as JaxIndex
from outline_rag_tpu.ops import hostres as jax_hostres
from outline_rag_tpu.ops import quant as jax_quant
from outline_rag_tpu_torch.index import VectorIndex
from outline_rag_tpu_torch.index import store as store_mod
from outline_rag_tpu_torch.ops.hostres import host_residual_topk
from outline_rag_tpu_torch.ops.quant import (
    int8_topk,
    int8_topk_candidates,
    quantize_rows_int8,
    quantize_rows_int8_residual,
)
from outline_rag_tpu_torch.ops.topk import NEG

torch.set_num_threads(1)

DIM, CAP, WIDTH, RANK = 64, 1024, 8, 4
DTYPES = ["float32", "bfloat16", "f32x2", "int8", "int8r"]


def _vectors(seed, n):
    """Integer-valued rows: their squared norms are exact whatever the
    summation order, so numpy (the JAX package) and torch (the port)
    normalize them to the same bits and the int8 codes agree."""
    return np.random.default_rng(seed).integers(-20, 21, (n, DIM)).astype(np.float32)


def _tokens(seed, n):
    """Token ids (CLS first, padded), lexical weights, ColBERT codes and
    scales for n chunks."""
    rng = np.random.default_rng(seed + 1000)
    ids = rng.integers(3, 500, (n, WIDTH + 2)).astype(np.int32)
    ids[:, 0] = 0
    ids[: n // 2, WIDTH - 2 :] = 1  # padded rows
    weights = rng.random((n, WIDTH + 2)).astype(np.float32)
    codes = rng.integers(-127, 128, (n, WIDTH + 2, RANK + 1)).astype(np.int8)
    scales = rng.random((n, WIDTH + 2)).astype(np.float32)
    return ids, weights, codes, scales


def _pair(dtype, cap=CAP, tokens=False, **kw):
    extra = dict(token_width=WIDTH, colbert_rank=RANK) if tokens else {}
    return (
        JaxIndex(dim=DIM, capacity=cap, dtype=dtype, **extra, **kw),
        VectorIndex(dim=DIM, capacity=cap, dtype=dtype, device="cpu", **extra, **kw),
    )


def _add(index, source, n, seed, tokens=False, replace=True):
    kw = {}
    if tokens:
        ids, weights, codes, scales = _tokens(seed, n)
        kw = dict(token_ids=ids, token_weights=weights, colbert_codes=codes,
                  colbert_scales=scales)
    index.add_chunks([f"{source}:{i}" for i in range(n)], _vectors(seed, n), source_id=source,
                     replace=replace, **kw)


def _both(pair, fn, *args, **kw):
    for index in pair:
        fn(index, *args, **kw)


def _row_ids(index):
    return [str(r) for r in index._shard.row_ids[: index._shard.cursor]]


def _assert_same(pair, k=12, seed=99, layout=True):
    """Same capacity, live rows in the same order (at the same rows, with
    ``layout``), same answers."""
    jax_index, port_index = pair
    assert port_index.capacity == jax_index._shard.capacity
    assert port_index.size == jax_index.size
    if layout:
        assert _row_ids(port_index) == _row_ids(jax_index)
    else:
        assert [c for c in _row_ids(port_index) if c] == [c for c in _row_ids(jax_index) if c]
    queries = _vectors(seed, 9)
    queries[0] = _vectors(3, 50)[7]  # an indexed vector (source s3) finds itself
    jids, jvals = jax_index.query(queries, k)
    pids, pvals = port_index.query(queries, k)
    assert pids == jids
    live = pvals > NEG / 2
    tol = 1e-6 if port_index.dtype in ("int8", "int8r") else 1e-5
    np.testing.assert_allclose(pvals[live], np.asarray(jvals)[live], rtol=0, atol=tol)


def _planes(index):
    """chunk id -> the bytes of its row in every plane of the port index."""
    state, row_ids = index.snapshot()
    planes = [state.vectors, state.scales, state.penalty, state.residual]
    if index.tokens is not None:
        planes += [index.tokens.state.ids, index.tokens.state.mask, index.tokens.state.weights]
        if index.tokens.colbert is not None:
            planes += [index.tokens.colbert.codes, index.tokens.colbert.scales]
    return {
        cid: [p[row : row + 1].view(torch.uint8).numpy().tobytes() for p in planes]
        for cid, row in index._by_chunk.items()
    }


@pytest.mark.parametrize("dtype", DTYPES)
def test_growth_doubles_and_keeps_content(dtype):
    pair = _pair(dtype)
    for s in range(5):
        _both(pair, _add, f"s{s}", 200, s)
    _both(pair, lambda index: index.delete_source("s1"))
    before = _planes(pair[1])
    # 800 live + 300 new > 1024: the index doubles, tombstones dropped
    _both(pair, _add, "s5", 300, 5)
    assert pair[1].capacity == 2 * CAP
    assert pair[1]._shard.cursor == pair[1].size == 1100
    after = _planes(pair[1])
    assert {c: after[c] for c in before} == before
    _assert_same(pair)


def test_churn_compacts_instead_of_growing():
    pair = _pair("int8r", tokens=True)
    for s in range(5):
        _both(pair, _add, f"s{s}", 200, s, tokens=True)
    # re-adding a whole source moves the cursor; once no row is free the
    # tombstones make room and the index compacts at its capacity
    for round_ in range(3):
        _both(pair, _add, f"s{round_}", 200, 10 + round_, tokens=True)
        _assert_same(pair)
    assert pair[1].capacity == CAP
    assert pair[1]._shard.cursor == pair[1].size == 1000


@pytest.mark.parametrize("dtype", ["float32", "int8r"])
def test_compact_keeps_live_rows_in_order(dtype):
    pair = _pair(dtype, tokens=True)
    for s in range(4):
        _both(pair, _add, f"s{s}", 100, s, tokens=True)
    _both(pair, lambda index: index.delete_source("s0"))
    _both(pair, lambda index: index.delete_chunks(["s2:5", "s2:7", "s3:0"]))
    order = [c for c in _row_ids(pair[1]) if c]
    before = _planes(pair[1])
    _both(pair, lambda index: index.compact())
    assert _row_ids(pair[1]) == order  # ascending old-row order, no gaps
    assert _planes(pair[1]) == before
    _assert_same(pair)
    assert pair[1]._by_source["s2"] == pair[0]._by_source["s2"]


def test_generation_monotonic_across_compaction_and_growth():
    pair = _pair("int8", cap=CAP)
    seen = [[], []]

    def step(fn):
        _both(pair, fn)
        for i, index in enumerate(pair):
            seen[i].append(index.generation)

    for s in range(5):
        step(lambda index, s=s: _add(index, f"s{s}", 200, s))
    step(lambda index: index.delete_source("s4"))
    step(lambda index: _add(index, "s0", 200, 20))  # compaction
    step(lambda index: index.compact())
    step(lambda index: _add(index, "s9", 900, 21))  # growth
    assert seen[1] == seen[0]
    assert all(b > a for a, b in zip(seen[1], seen[1][1:]))
    assert pair[1].capacity == 2 * CAP


def test_terminal_capacity_raises(monkeypatch):
    pair = _pair("int8r")
    _both(pair, _add, "s0", 1000, 0)
    monkeypatch.setattr(pair[1], "_growth_would_fit", lambda cap: False)
    with pytest.raises(RuntimeError, match="terminal capacity"):
        _add(pair[1], "s1", 100, 1)
    assert pair[1].capacity == CAP and pair[1].size == 1000


@pytest.mark.parametrize("fails", ["DeviceShard", "TokenCache"])
def test_failed_allocation_restores_old_capacity(monkeypatch, fails):
    """The grown allocation fails, the shard's or the token cache's after
    the shard's succeeded: what the grown rebuild allocated is released
    before the restore, which rebuilds every row at the old capacity."""
    port = VectorIndex(dim=DIM, capacity=CAP, dtype="int8r", device="cpu",
                       token_width=WIDTH, colbert_rank=RANK)
    for s in range(5):
        _add(port, f"s{s}", 200, s, tokens=True)
    port.delete_source("s2")
    before = _planes(port)
    order = [c for c in _row_ids(port) if c]
    grown = []  # weak references to what the grown rebuild allocated

    def patched(name):
        real = getattr(store_mod, name)

        def allocate(capacity, *args, **kw):
            if capacity > CAP:
                built = real(capacity, *args, **kw)
                grown.append(weakref.ref(built))
                if name == fails:
                    raise torch.cuda.OutOfMemoryError("no room for the grown planes")
                return built
            # the restore: nothing of the grown rebuild is held any more
            assert grown and all(ref() is None for ref in grown)
            return real(capacity, *args, **kw)

        return allocate

    for name in ("DeviceShard", "TokenCache"):
        monkeypatch.setattr(store_mod, name, patched(name))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _add(port, "s9", 300, 9, tokens=True)
    assert port.capacity == CAP and port.size == 800
    assert _row_ids(port) == order
    assert _planes(port) == before
    ids, _ = port.query(_vectors(3, 200)[:2], 1)
    assert ids == [["s3:0"], ["s3:1"]]


def test_int8r_through_churn_growth_and_snapshot(tmp_path):
    pair = _pair("int8r", tokens=True)
    for s in range(5):
        _both(pair, _add, f"s{s}", 200, s, tokens=True)
    _both(pair, _add, "s1", 200, 31, tokens=True)  # compacts
    _assert_same(pair)
    _both(pair, _add, "s6", 500, 32, tokens=True)  # grows
    _assert_same(pair)
    assert pair[1].capacity == 2 * CAP
    pair[1].colbert_projection_for(16)  # the matrix the codes stand for
    pair[1].save(str(tmp_path / "snap"))
    loaded = VectorIndex.load(str(tmp_path / "snap"), device="cpu")
    _assert_same((pair[0], loaded), layout=False)
    assert _planes(loaded) == _planes(pair[1])
    np.testing.assert_array_equal(loaded.colbert_proj, pair[1].colbert_proj)


@pytest.mark.parametrize("dtype", ["int8", "int8r"])
def test_rescore_m_zero_matches_jax(dtype):
    pair = _pair(dtype, rescore_m=0)
    assert pair[1].rescore_m == 0
    for s in range(4):
        _both(pair, _add, f"s{s}", 200, s)
    _assert_same(pair)
    float_index = VectorIndex(dim=DIM, capacity=CAP, dtype="float32", device="cpu")
    assert float_index.rescore_m == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_save_load_in_the_port(tmp_path, dtype):
    port = VectorIndex(dim=DIM, capacity=CAP, dtype=dtype, device="cpu",
                       token_width=WIDTH, colbert_rank=RANK)
    for s in range(4):
        _add(port, f"s{s}", 100, s, tokens=True)
    port.delete_source("s1")
    port.delete_chunks(["s2:3"])
    port.colbert_proj = np.random.default_rng(4).standard_normal((16, RANK)).astype(np.float32)
    port.save(str(tmp_path / "snap"))
    assert sorted(os.listdir(tmp_path)) == ["snap.meta.json", "snap.npz"]
    loaded = VectorIndex.load(str(tmp_path / "snap"), device="cpu")
    assert loaded.size == port.size == 299 and loaded.capacity == CAP
    assert _row_ids(loaded) == [c for c in _row_ids(port) if c]
    assert _planes(loaded) == _planes(port)
    assert loaded._by_source == {k: v for k, v in port._by_source.items() if v}
    np.testing.assert_array_equal(loaded.colbert_proj, port.colbert_proj)
    queries = _vectors(5, 6)
    assert loaded.query(queries, 12)[0] == port.query(queries, 12)[0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_snapshots_pass_between_packages(tmp_path, dtype):
    pair = _pair(dtype, tokens=True)
    for s in range(5):
        _both(pair, _add, f"s{s}", 150, s, tokens=True)
    _both(pair, lambda index: index.delete_source("s2"))
    proj = np.random.default_rng(7).standard_normal((16, RANK)).astype(np.float32)
    for index in pair:
        index.colbert_proj = proj
    pair[0].save(str(tmp_path / "from_jax"))
    pair[1].save(str(tmp_path / "from_port"))
    in_port = VectorIndex.load(str(tmp_path / "from_jax"), device="cpu")
    in_jax = JaxIndex.load(str(tmp_path / "from_port"))
    _assert_same((pair[0], in_port), layout=False)
    _assert_same((in_jax, pair[1]), layout=False)
    np.testing.assert_array_equal(in_port.colbert_proj, proj)
    np.testing.assert_array_equal(in_jax.colbert_proj, proj)
    assert in_port._by_source == in_jax._by_source == pair[0]._by_source
    # the token and ColBERT planes of every live row, both ways
    for jax_index, port_index in ((pair[0], in_port), (in_jax, pair[1])):
        jt, pt = jax_index.tokens, port_index.tokens
        for cid, row in port_index._by_chunk.items():
            jrow = jax_index._by_chunk[cid]
            for jplane, pplane in ((jt.state.ids, pt.state.ids), (jt.state.mask, pt.state.mask),
                                   (jt.state.weights, pt.state.weights),
                                   (jt.colbert.codes, pt.colbert.codes),
                                   (jt.colbert.scales, pt.colbert.scales)):
                np.testing.assert_array_equal(pplane[row].numpy(), np.asarray(jplane[jrow]))


def test_mispaired_snapshot_files_rejected(tmp_path):
    port = VectorIndex(dim=DIM, capacity=CAP, dtype="int8r", device="cpu")
    _add(port, "s0", 50, 0)
    port.save(str(tmp_path / "a"))
    _add(port, "s1", 50, 1)
    port.save(str(tmp_path / "b"))
    os.replace(tmp_path / "a.meta.json", tmp_path / "b.meta.json")
    with pytest.raises(ValueError, match="different saves"):
        VectorIndex.load(str(tmp_path / "b"), device="cpu")


def test_colbert_snapshot_without_projection_refused(tmp_path):
    """A JAX snapshot from before the projection was saved: the JAX
    package re-draws its matrix from jax.random; the port refuses."""
    jax_index = JaxIndex(dim=DIM, capacity=CAP, dtype="int8r", token_width=WIDTH,
                         colbert_rank=RANK)
    _add(jax_index, "s0", 50, 0, tokens=True)
    jax_index.save(str(tmp_path / "legacy"))
    with np.load(tmp_path / "legacy.npz") as npz:
        assert "colbert_proj" not in npz.files  # never pinned: the legacy layout
    with pytest.raises(ValueError, match="colbert_proj"):
        VectorIndex.load(str(tmp_path / "legacy"), device="cpu")


def test_save_refuses_colbert_codes_without_projection(tmp_path):
    """Codes the index holds without a pinned matrix would make a snapshot
    that ``load`` refuses: ``save`` refuses it at once and writes nothing."""
    port = VectorIndex(dim=DIM, capacity=CAP, dtype="int8r", device="cpu",
                       token_width=WIDTH, colbert_rank=RANK)
    _add(port, "s0", 50, 0, tokens=True)
    with pytest.raises(ValueError, match="colbert_proj"):
        port.save(str(tmp_path / "snap"))
    assert os.listdir(tmp_path) == []
    port.colbert_projection_for(16)
    port.save(str(tmp_path / "snap"))
    assert VectorIndex.load(str(tmp_path / "snap"), device="cpu").size == 50


def test_two_concurrent_saves_leave_paired_files(tmp_path):
    port = VectorIndex(dim=DIM, capacity=CAP, dtype="int8r", device="cpu", token_width=WIDTH)
    for s in range(4):
        _add(port, f"s{s}", 200, s, tokens=True)
    path = str(tmp_path / "snap")
    errors = []

    def save():
        try:
            for _ in range(3):
                port.save(path)
        except Exception as err:  # reported by the assertion below
            errors.append(err)

    threads = [threading.Thread(target=save) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(os.listdir(tmp_path)) == ["snap.meta.json", "snap.npz"]
    loaded = VectorIndex.load(path, device="cpu")  # paired: the tags agree
    assert loaded.size == 800
    with open(path + ".meta.json") as f:
        assert json.load(f)["cursor"] == 800


def test_adopt_swaps_contents_and_checks_config(tmp_path):
    live = VectorIndex(dim=DIM, capacity=CAP, dtype="int8r", device="cpu", token_width=WIDTH)
    _add(live, "old", 10, 0, tokens=True)
    other = VectorIndex(dim=DIM, capacity=2 * CAP, dtype="int8r", device="cpu",
                        token_width=WIDTH)
    _add(other, "s3", 50, 3, tokens=True)
    gen = live.generation
    live.adopt(other)
    assert live.capacity == 2 * CAP and live.size == 50
    assert live.generation > gen
    assert live.query(_vectors(3, 50)[:1], 1)[0] == [["s3:0"]]
    for bad in (
        VectorIndex(dim=DIM, capacity=CAP, dtype="int8", device="cpu", token_width=WIDTH),
        VectorIndex(dim=DIM, capacity=CAP, dtype="int8r", device="cpu", token_width=16),
        VectorIndex(dim=DIM, capacity=CAP, dtype="int8r", device="cpu", token_width=WIDTH,
                    colbert_rank=RANK),
        VectorIndex(dim=32, capacity=CAP, dtype="int8r", device="cpu", token_width=WIDTH),
    ):
        with pytest.raises(ValueError, match="config mismatch"):
            live.adopt(bad)
    assert live.size == 50


def _candidates_case(seed=0, n=3000, b=5, m=64):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, DIM)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = corpus[rng.integers(0, n, b)] + 0.1 * rng.standard_normal((b, DIM)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    penalty = np.where(rng.random(n) < 0.05, NEG, 0.0).astype(np.float32)
    return corpus, queries.astype(np.float32), penalty, m


def test_int8_topk_candidates_and_host_tier_match_jax():
    corpus, queries, penalty, m = _candidates_case()
    jq1, js, jq2 = (np.asarray(x) for x in jax_quant.quantize_rows_int8_residual(corpus))
    jqq, jqs = (np.asarray(x) for x in jax_quant.quantize_rows_int8(queries))
    want = jax_quant.int8_topk_candidates(
        jnp.asarray(jqq), jnp.asarray(jqs), jnp.asarray(jq1), jnp.asarray(js), m,
        jnp.asarray(queries), jnp.asarray(penalty),
    )
    q1, s, q2 = quantize_rows_int8_residual(torch.from_numpy(corpus))
    qq, qs = quantize_rows_int8(torch.from_numpy(queries))
    got = int8_topk_candidates(qq, qs, q1, s, m, torch.from_numpy(queries),
                               torch.from_numpy(penalty))
    scores, idx, scale = (x.numpy() for x in got)
    jscores, jidx, jscale = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(scale, jscale)
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=1e-6)
    for k in (1, 12, m):
        jv, ji = jax_hostres.host_residual_topk(jscores, jidx, jscale, queries, jq2, k)
        pv, pi = host_residual_topk(scores, idx, scale, queries, q2.numpy(), k)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-6)
    # the split tier ranks as the device rescore over both planes does
    dv, di = int8_topk(qq, qs, q1, s, 12, torch.from_numpy(penalty),
                       rescore_queries=torch.from_numpy(queries), rescore_residual=q2)
    pv, pi = host_residual_topk(scores, idx, scale, queries, q2.numpy(), 12)
    np.testing.assert_array_equal(pi, di.numpy())
    np.testing.assert_allclose(pv, dv.numpy(), rtol=0, atol=1e-6)


def test_host_tier_k_above_m_raises():
    corpus, queries, penalty, m = _candidates_case(n=500, m=16)
    q1, s, q2 = quantize_rows_int8_residual(torch.from_numpy(corpus))
    qq, qs = quantize_rows_int8(torch.from_numpy(queries))
    scores, idx, scale = (x.numpy() for x in int8_topk_candidates(
        qq, qs, q1, s, m, torch.from_numpy(queries)))
    with pytest.raises(ValueError, match="exceeds"):
        host_residual_topk(scores, idx, scale, queries, q2.numpy(), m + 1)
    assert host_residual_topk(scores, idx, scale, queries, q2.numpy(), m)[1].shape == (5, m)


def test_few_live_rows_candidates_are_dead_not_row_zero():
    """The port's dead-slot rule holds in the candidate half too: with
    fewer live rows than m, the empty slots score NEG."""
    corpus, queries, _, _ = _candidates_case(n=40)
    penalty = np.full(40, NEG, np.float32)
    penalty[5:15] = 0.0
    q1, s, _ = quantize_rows_int8_residual(torch.from_numpy(corpus))
    qq, qs = quantize_rows_int8(torch.from_numpy(queries))
    scores, idx, _ = int8_topk_candidates(qq, qs, q1, s, 16, torch.from_numpy(queries),
                                          torch.from_numpy(penalty))
    live = scores > NEG / 2
    assert (live.sum(dim=1) == 10).all()
    assert all(set(idx[b][live[b]].tolist()) == set(range(5, 15)) for b in range(idx.shape[0]))
