"""The port's row-parallel scans (``outline_rag_tpu_torch/parallel/query.py``),
its row-sharded ``VectorIndex`` and its sharded encoder against the JAX
package's on conftest's 8-device CPU mesh, the port's mesh being eight CPU
entries.

Inputs are seeded numpy arrays given to both packages. The JAX scans run the
Pallas kernel in interpret mode (``impl="pallas"``), as
``tests/test_torch_topk.py`` holds the unsharded scan. Tolerances:

- int8 scans without the rescore: values and rows bit-equal (integer dots);
- float scans and the f32 rescore: values within 1e-5 (the f32 sums run in
  another order than the Pallas kernel's), rows equal wherever the JAX
  values around a slot are more than 1e-5 apart
  (``testing.tie_aware_mismatches``); exact ties (duplicated rows spread
  over shards) keep the lowest global row in both;
- the port's sharded scan against its own unsharded scan: bit-equal, rows
  and values, ties included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outline_rag_tpu.index import VectorIndex as JaxIndex
from outline_rag_tpu.ops.quant import quantize_rows_int8 as jax_quant
from outline_rag_tpu.ops.quant import quantize_rows_int8_residual as jax_quant_res
from outline_rag_tpu.ops.topk import split_f32_bf16x2 as jax_split
from outline_rag_tpu.parallel import data_mesh as jax_data_mesh
from outline_rag_tpu.parallel import row_sharding as jax_row_sharding
from outline_rag_tpu.parallel import query as jq
from outline_rag_tpu_torch.index import VectorIndex
from outline_rag_tpu_torch.ops.quant import int8_topk, quantize_rows_int8
from outline_rag_tpu_torch.ops.topk import NEG, cosine_topk, split_f32_bf16x2
from outline_rag_tpu_torch.parallel import Mesh, RowShards, data_mesh, row_sharding
from outline_rag_tpu_torch.parallel import query as pq
from outline_rag_tpu_torch.testing import tie_aware_mismatches

torch.set_num_threads(1)

N, D, B = 2048, 64, 5
TOL = 1e-5
DUPS = [5, 300, 1100, 2000]  # row 5 and three copies, on shards 0, 1, 4 and 7


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    return jax_data_mesh()


@pytest.fixture(scope="module")
def mesh():
    return data_mesh(devices=["cpu"] * 8)


def _case(seed, n_live=None):
    """Unit rows with 5% tombstones spanning shard boundaries and three
    copies of row 5 (query 0 is row 5, so four rows tie at its top)."""
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    corpus[DUPS] = corpus[DUPS[0]]
    q = rng.standard_normal((B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = corpus[DUPS[0]]
    penalty = np.where(rng.random(N) < 0.05, NEG, 0.0).astype(np.float32)
    penalty[250:270] = NEG  # across the boundary of shards 0 and 1
    penalty[DUPS] = 0.0
    if n_live is not None:
        penalty[:] = NEG
        penalty[rng.choice(N, n_live, replace=False)] = 0.0
    return q, corpus, penalty


def _jput(x, jmesh):
    return jax.device_put(jnp.asarray(x), jax_row_sharding(jmesh))


def _stored(corpus, mode):
    if mode == "fp32":
        return jnp.asarray(corpus), torch.from_numpy(corpus)
    if mode == "bf16":
        return (jnp.asarray(corpus).astype(jnp.bfloat16),
                torch.from_numpy(corpus).to(torch.bfloat16))
    return jax_split(jnp.asarray(corpus)), split_f32_bf16x2(torch.from_numpy(corpus))


@pytest.mark.parametrize("mode", ["fp32", "bf16", "f32x2"])
@pytest.mark.parametrize("k", [12, 64])
def test_sharded_topk_matches_jax_and_the_unsharded_scan(jmesh, mesh, mode, k):
    q, corpus, penalty = _case(k)
    jc, pc = _stored(corpus, mode)
    jv, ji = jq.sharded_topk(jnp.asarray(q), _jput(jc, jmesh), k, _jput(penalty, jmesh),
                             mesh=jmesh, impl="pallas", block_n=256)
    jv, ji = np.array(jv), np.array(ji)
    pv, pi = pq.sharded_topk(torch.from_numpy(q), pc, k, torch.from_numpy(penalty), mesh=mesh)
    assert tie_aware_mismatches(pv, pi, jv, ji, TOL) == 0
    # the four copies tie at query 0's top, lowest global row first, in both
    assert list(pi[0, :4].numpy()) == list(ji[0, :4]) == DUPS
    assert not (penalty[pi.numpy()] < 0).any()
    uv, ui = cosine_topk(torch.from_numpy(q), pc, k, torch.from_numpy(penalty))
    assert torch.equal(pi, ui) and torch.equal(pv, uv)


def test_sharded_topk_dead_slots(jmesh, mesh):
    """Fewer live rows than k: each shard's dead slots come back rebased,
    as (NEG, r * N/8), as in the JAX package's sharded scan. The merge is
    stable and shard 0 holds at least as many dead slots as the merged list
    needs, so the merged dead slots are shard 0's (NEG, 0): the same as the
    unsharded scan's, in both packages."""
    q, corpus, penalty = _case(3, n_live=8)
    k = 12
    jv, ji = jq.sharded_topk(jnp.asarray(q), _jput(corpus, jmesh), k, _jput(penalty, jmesh),
                             mesh=jmesh, impl="pallas", block_n=256)
    pv, pi = pq.sharded_topk(torch.from_numpy(q), torch.from_numpy(corpus), k,
                             torch.from_numpy(penalty), mesh=mesh)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=TOL)
    dead = pv.numpy() <= NEG / 2
    assert dead[:, 8:].all() and not dead[:, :8].any()
    assert (pv.numpy()[dead] == np.float32(NEG)).all() and (pi.numpy()[dead] == 0).all()
    uv, ui = cosine_topk(torch.from_numpy(q), torch.from_numpy(corpus), k,
                         torch.from_numpy(penalty))
    assert torch.equal(pi, ui) and torch.equal(pv, uv)
    vals, gidx = pq._local_scans(torch.from_numpy(q), torch.from_numpy(corpus),
                                 torch.from_numpy(penalty), k, mesh)
    for r, (v, i) in enumerate(zip(vals, gidx)):
        shard_dead = v <= NEG / 2
        assert shard_dead.any() and (i[shard_dead] == r * N // 8).all()


def _int8_planes(corpus, residual: bool):
    if residual:
        q1, s, q2 = jax_quant_res(jnp.asarray(corpus))
        return np.array(q1), np.array(s), np.array(q2)
    q1, s = jax_quant(jnp.asarray(corpus))
    return np.array(q1), np.array(s), None


@pytest.mark.parametrize("rescore", ["none", "q1", "q1+q2"])
def test_sharded_topk_int8_matches_jax(jmesh, mesh, rescore):
    q, corpus, penalty = _case(11)
    k = 12
    codes, scales, res = _int8_planes(corpus, rescore == "q1+q2")
    qq, qs = quantize_rows_int8(torch.from_numpy(q))
    kw_j = dict(mesh=jmesh, impl="pallas", block_n=256)
    kw_p = dict(mesh=mesh)
    if rescore != "none":
        kw_j.update(rescore_queries=jnp.asarray(q), rescore_m=64)
        kw_p.update(rescore_queries=torch.from_numpy(q), rescore_m=64)
        if res is not None:
            kw_j["rescore_residual"] = _jput(res, jmesh)
            kw_p["rescore_residual"] = torch.from_numpy(res)
    jv, ji = jq.sharded_topk_int8(
        jnp.asarray(qq.numpy()), jnp.asarray(qs.numpy()), _jput(codes, jmesh),
        _jput(scales, jmesh), k, _jput(penalty, jmesh), **kw_j,
    )
    pv, pi = pq.sharded_topk_int8(qq, qs, torch.from_numpy(codes), torch.from_numpy(scales), k,
                                  torch.from_numpy(penalty), **kw_p)
    jv, ji = np.array(jv), np.array(ji)
    if rescore == "none":
        np.testing.assert_array_equal(pi.numpy(), ji)
        np.testing.assert_array_equal(pv.numpy(), jv)
    else:
        assert tie_aware_mismatches(pv, pi, jv, ji, TOL) == 0
    assert list(pi[0, :4].numpy()) == DUPS
    # the same scan unsharded, bit for bit
    uv, ui = int8_topk(
        qq, qs, torch.from_numpy(codes), torch.from_numpy(scales), k, torch.from_numpy(penalty),
        **{key: val for key, val in kw_p.items() if key != "mesh"},
    )
    assert torch.equal(pi, ui) and torch.equal(pv, uv)


def test_sharded_rescore_at_k_equal_to_m_ranks_a_superset(mesh):
    """At K = rescore_m each shard rescores its own M candidates, a superset
    of the unsharded scan's M, as in the JAX package: the merged values are
    never lower than the unsharded rescore's, position by position, and the
    head (K = 12 of M = 64, the serving shape) is bit-equal."""
    q, corpus, penalty = _case(41)
    codes, scales, res = _int8_planes(corpus, True)
    qq, qs = quantize_rows_int8(torch.from_numpy(q))
    args = (qq, qs, torch.from_numpy(codes), torch.from_numpy(scales))
    kw = dict(rescore_queries=torch.from_numpy(q), rescore_m=64,
              rescore_residual=torch.from_numpy(res))
    pen = torch.from_numpy(penalty)
    sv, si = pq.sharded_topk_int8(*args, 64, pen, mesh=mesh, **kw)
    uv, ui = int8_topk(*args, 64, pen, **kw)
    assert (sv >= uv).all()
    hv, hi = pq.sharded_topk_int8(*args, 12, pen, mesh=mesh, **kw)
    assert torch.equal(hv, uv[:, :12]) and torch.equal(hi, ui[:, :12])


@pytest.mark.parametrize("dtype", ["float32", "int8r"])
def test_sharded_retrieve_tokens_matches_jax(jmesh, mesh, dtype):
    """The mesh fused query's retrieval stage with the ColBERT extras: rows
    as JAX's, and each candidate's cached tokens, lexical weights and
    ColBERT codes gathered on its shard and merged with the same
    permutation."""
    q, corpus, penalty = _case(21)
    k, tc, r = 12, 16, 8
    rng = np.random.default_rng(22)
    ids = rng.integers(3, 250, (N, tc)).astype(np.int32)
    mask = (rng.random((N, tc)) < 0.8).astype(np.int32)
    w = rng.random((N, tc)).astype(np.float32)
    cv = rng.integers(-127, 128, (N, tc, r)).astype(np.int8)
    cs = rng.random((N, tc)).astype(np.float32)
    if dtype == "int8r":
        vec, sc, res = _int8_planes(corpus, True)
    else:
        vec, sc, res = corpus, np.ones(N, np.float32), None
    jout = jq.sharded_retrieve_tokens(
        jnp.asarray(q), _jput(vec, jmesh), _jput(sc, jmesh), _jput(penalty, jmesh),
        _jput(ids, jmesh), _jput(mask, jmesh), _jput(w, jmesh), k,
        tok_cvecs=_jput(cv, jmesh), tok_cscale=_jput(cs, jmesh),
        residual=None if res is None else _jput(res, jmesh), mesh=jmesh, impl="pallas",
        block_n=256,
    )
    pout = pq.sharded_retrieve_tokens(
        torch.from_numpy(q), torch.from_numpy(vec), torch.from_numpy(sc),
        torch.from_numpy(penalty), torch.from_numpy(ids), torch.from_numpy(mask),
        torch.from_numpy(w), k, tok_cvecs=torch.from_numpy(cv), tok_cscale=torch.from_numpy(cs),
        residual=None if res is None else torch.from_numpy(res), mesh=mesh,
    )
    jout = [np.array(x) for x in jout]
    pv, pi = pout[0], pout[1]
    assert tie_aware_mismatches(pv, pi, jout[0], jout[1], TOL) == 0
    np.testing.assert_array_equal(pi.numpy(), jout[1])  # no near-ties but the exact copies
    rows = pi.numpy()
    for got, plane in zip(pout[2:], (ids, mask, w, cv, cs)):
        np.testing.assert_array_equal(got.numpy(), plane[rows])
    for got, want in zip(pout[2:], jout[2:]):
        np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_topk_2d_matches_jax_and_the_flat_merge(mesh):
    """Two slices of four: the ICI-then-DCN merge equals JAX's and the flat
    eight-shard merge, ties included."""
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    q, corpus, penalty = _case(31)
    k = 10
    jmesh2 = JaxMesh(np.array(jax.devices()).reshape(2, 4), ("dcn", "ici"))
    spec = NamedSharding(jmesh2, P(("dcn", "ici")))
    jv, ji = jq.sharded_topk_2d(
        jnp.asarray(q), jax.device_put(jnp.asarray(corpus), spec), k,
        jax.device_put(jnp.asarray(penalty), spec), mesh=jmesh2, impl="pallas", block_n=256,
    )
    mesh2 = Mesh(["cpu"] * 8, ("dcn", "ici"), (2, 4))
    pv, pi = pq.sharded_topk_2d(torch.from_numpy(q), torch.from_numpy(corpus), k,
                                torch.from_numpy(penalty), mesh=mesh2)
    assert tie_aware_mismatches(pv, pi, np.array(jv), np.array(ji), TOL) == 0
    fv, fi = pq.sharded_topk(torch.from_numpy(q), torch.from_numpy(corpus), k,
                             torch.from_numpy(penalty), mesh=mesh)
    assert torch.equal(pi, fi) and torch.equal(pv, fv)
    with pytest.raises(ValueError, match="dcn"):
        pq.sharded_topk_2d(torch.from_numpy(q), torch.from_numpy(corpus), k, mesh=mesh)


def test_merge_keeps_the_lowest_row_on_ties():
    vals = [torch.tensor([[1.0, 0.5]]), torch.tensor([[1.0, 1.0]]), torch.tensor([[0.5, NEG]])]
    gidx = [torch.tensor([[3, 1]], dtype=torch.int32), torch.tensor([[10, 12]], dtype=torch.int32),
            torch.tensor([[20, 16]], dtype=torch.int32)]
    extra = [torch.arange(2)[None, :, None] + 10 * s for s in range(3)]
    v, i, (e,) = pq._merge_gathered(vals, gidx, 4, extras=[extra])
    assert v.tolist() == [[1.0, 1.0, 1.0, 0.5]]
    assert i.tolist() == [[3, 10, 12, 1]]
    assert e[0, :, 0].tolist() == [0, 10, 11, 1]


def test_row_shards_blocks_and_writes():
    mesh = data_mesh(devices=["cpu"] * 4)
    x = torch.arange(32.0).reshape(16, 2)
    rs = RowShards.split(x, mesh)
    assert rs.rows_per_shard == 4 and tuple(rs.shape) == (16, 2)
    assert [b[0, 0].item() for b in rs.blocks] == [0.0, 8.0, 16.0, 24.0]
    for blk, lo, hi, off in rs.pieces(3, 10):
        blk[lo:hi] = -1.0
    want = x.clone()
    want[3:10] = -1.0
    assert torch.equal(rs.cpu(), want)
    rs.index_fill_(np.array([0, 15]), 7.0)
    assert rs.rows(15, 16)[0].tolist() == [7.0, 7.0] and rs.rows(0, 1)[0].tolist() == [7.0, 7.0]
    with pytest.raises(ValueError, match="equal blocks"):
        RowShards.split(torch.zeros(10, 2), mesh)


def test_data_mesh_never_shrinks():
    with pytest.raises(ValueError, match="only 2 device"):
        data_mesh(4, devices=["cpu", "cpu"])
    assert data_mesh(2, devices=["cpu"] * 8).size == 2


# ---------------------------------------------------------------------------
# the row-sharded VectorIndex
# ---------------------------------------------------------------------------

def _fill(index, vecs, n_sources=4):
    n = len(vecs)
    for s in range(n_sources):
        lo, hi = s * n // n_sources, (s + 1) * n // n_sources
        index.add_chunks([f"c{i}" for i in range(lo, hi)], vecs[lo:hi], source_id=f"s{s}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "f32x2", "int8", "int8r"])
def test_sharded_index_query_matches_jax(jmesh, mesh, dtype):
    rng = np.random.default_rng(13)
    vecs = rng.standard_normal((1500, D)).astype(np.float32)
    qs = vecs[:6] + 0.3 * rng.standard_normal((6, D)).astype(np.float32)
    j = JaxIndex(dim=D, capacity=2048, dtype=dtype, sharding=jax_row_sharding(jmesh))
    p = VectorIndex(dim=D, capacity=2048, dtype=dtype, sharding=row_sharding(mesh))
    plain = VectorIndex(dim=D, capacity=2048, dtype=dtype, device="cpu")
    for index in (j, p, plain):
        _fill(index, vecs)
        index.delete_source("s1")
    assert p.mesh is not None and p.mesh.size == 8
    j_ids, j_vals = j.query(qs, 12)
    p_ids, p_vals = p.query(qs, 12)
    assert p_ids == j_ids
    np.testing.assert_allclose(p_vals, j_vals, rtol=0, atol=TOL)
    u_ids, u_vals = plain.query(qs, 12)
    assert p_ids == u_ids
    np.testing.assert_array_equal(p_vals, u_vals)


def test_sharded_index_growth_compaction_and_snapshot(mesh, tmp_path):
    """Growth, compaction, a snapshot round trip and ``adopt`` keep the
    blocks equal and contiguous, and the sharded index answers as an
    unsharded one that went through the same steps, bit for bit."""
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((2600, D)).astype(np.float32)
    qs = rng.standard_normal((4, D)).astype(np.float32)
    kw = dict(dim=D, capacity=1024, dtype="int8r", token_width=8)
    p = VectorIndex(sharding=row_sharding(mesh), **kw)
    u = VectorIndex(device="cpu", **kw)
    toks = rng.integers(3, 250, (2600, 8)).astype(np.int32)

    def add(index, lo, hi, src):
        index.add_chunks([f"c{i}" for i in range(lo, hi)], vecs[lo:hi], source_id=src,
                         token_ids=toks[lo:hi])

    for index in (p, u):
        add(index, 0, 800, "a")
        add(index, 800, 1600, "b")  # grows to 2048
        index.delete_source("a")
        gen = index.generation
        add(index, 1600, 2600, "c")  # compacts at 2048
        assert index.generation > gen and index._shard.cursor == 1800
    assert p.capacity == u.capacity == 2048
    state, _ = p.snapshot()
    assert [b.shape[0] for b in state.vectors.blocks] == [p.capacity // 8] * 8
    assert [b.shape[0] for b in state.residual.blocks] == [p.capacity // 8] * 8
    assert p.query(qs, 12)[0] == u.query(qs, 12)[0]
    np.testing.assert_array_equal(p.query(qs, 12)[1], u.query(qs, 12)[1])
    np.testing.assert_array_equal(p.tokens.state.ids.cpu().numpy(),
                                  u.tokens.state.ids.cpu().numpy())

    path = str(tmp_path / "snap")
    p.save(path)
    loaded = VectorIndex.load(path, sharding=row_sharding(mesh))
    assert loaded.mesh == p.mesh
    assert loaded.query(qs, 12)[0] == u.query(qs, 12)[0]
    fresh = VectorIndex(sharding=row_sharding(mesh), **kw)
    fresh.adopt(loaded)
    assert fresh.query(qs, 12)[0] == u.query(qs, 12)[0]
    with pytest.raises(ValueError, match="sharding"):
        VectorIndex(device="cpu", **kw).adopt(VectorIndex.load(path, sharding=row_sharding(mesh)))
    # the JAX package reads the sharded index's snapshot
    j = JaxIndex.load(path)
    assert j.query(qs, 12)[0] == u.query(qs, 12)[0]


def test_sharded_index_k_is_at_most_a_shard(mesh):
    """Under a mesh each shard returns at most its rows: k_eff is
    capacity / mesh size, as in the JAX package."""
    p = VectorIndex(dim=D, capacity=64, sharding=row_sharding(mesh))
    rng = np.random.default_rng(2)
    p.add_chunks([f"c{i}" for i in range(40)], rng.standard_normal((40, D)), source_id="d")
    ids, vals = p.query(rng.standard_normal((2, D)), 12)
    assert vals.shape == (2, 8)


def test_sharded_index_needs_divisible_capacity(mesh):
    with pytest.raises(ValueError, match="equal blocks"):
        VectorIndex(dim=D, capacity=100, sharding=row_sharding(mesh))


def test_a_one_device_mesh_is_an_unsharded_index():
    rng = np.random.default_rng(4)
    vecs = rng.standard_normal((30, D)).astype(np.float32)
    one = VectorIndex(dim=D, capacity=64, dtype="int8r",
                      sharding=row_sharding(data_mesh(devices=["cpu"])))
    plain = VectorIndex(dim=D, capacity=64, dtype="int8r", device="cpu")
    for index in (one, plain):
        index.add_chunks([f"c{i}" for i in range(30)], vecs, source_id="d")
    assert one.mesh is None and isinstance(one.snapshot()[0].vectors, torch.Tensor)
    assert one.query(vecs[:3], 5)[0] == plain.query(vecs[:3], 5)[0]


# ---------------------------------------------------------------------------
# data-parallel encoding
# ---------------------------------------------------------------------------

def test_sharded_encoder_matches_jax(jmesh, mesh):
    from outline_rag_tpu.models import encoder as je
    from outline_rag_tpu.parallel.encode import make_sharded_encoder as jax_sharded_encoder
    from outline_rag_tpu_torch.models.convert import encoder_from_jax
    from outline_rag_tpu_torch.models.encoder import EncoderConfig, pooled_embeddings
    from outline_rag_tpu_torch.parallel.encode import make_sharded_encoder

    jcfg = je.EncoderConfig.tiny()
    params = je.init_encoder_params(jax.random.key(5), jcfg)
    cfg = EncoderConfig.tiny()
    enc = encoder_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    rng = np.random.default_rng(5)
    ids = rng.integers(3, cfg.vocab_size, size=(16, 12)).astype(np.int32)
    mask = np.ones((16, 12), np.int32)
    mask[3, 8:] = 0
    want = np.asarray(jax_sharded_encoder(jcfg, jmesh)(params, ids, mask))
    got = make_sharded_encoder(cfg, mesh)(enc, ids, mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    with torch.no_grad():
        single = pooled_embeddings(enc, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="does not split"):
        make_sharded_encoder(cfg, mesh)(enc, ids[:12], mask[:12])
