"""The port's mesh-sharded serving path against the JAX package's (mirrors
``tests/test_mesh_serving.py``) on conftest's 8-device CPU mesh, the port's
mesh being eight CPU entries:

- a row-sharded ``VectorIndex.query`` runs ``parallel/query.py``'s
  ``sharded_topk`` / ``sharded_topk_int8`` and returns the unsharded
  index's ids and scores, bit for bit;
- ``FusedEngine`` over a row-sharded index runs ``fused_query_mesh`` and
  returns the single-device engine's hits (ids equal, scores within 1e-6)
  and the JAX package's mesh engine's (ids equal, cross-encoder and
  retrieval scores within 1e-4, the tolerance of ``tests/test_torch_engine.py``),
  with the hybrid weights off and on, and with int8 trunks;
- the app serves an ask with citations through ``MESH_DATA_AXIS=2``.
"""

import asyncio
import json

import jax
import numpy as np
import pytest
import torch

from outline_rag_tpu.engine.embedder import EncoderEmbedder as JaxEmbedder
from outline_rag_tpu.engine.fused import FusedEngine as JaxEngine
from outline_rag_tpu.engine.rerank import CrossEncoderReranker as JaxReranker
from outline_rag_tpu.index import VectorIndex as JaxIndex
from outline_rag_tpu.models import encoder as je
from outline_rag_tpu.models.reranker import init_reranker_params
from outline_rag_tpu.parallel import data_mesh as jax_data_mesh
from outline_rag_tpu.parallel import row_sharding as jax_row_sharding
from outline_rag_tpu_torch.engine import CrossEncoderReranker, EncoderEmbedder
from outline_rag_tpu_torch.engine.fused import FusedEngine
from outline_rag_tpu_torch.index import VectorIndex
from outline_rag_tpu_torch.models.convert import encoder_from_jax, reranker_from_jax
from outline_rag_tpu_torch.models.encoder import EncoderConfig
from outline_rag_tpu_torch.models.tokenizer import HashTokenizer
from outline_rag_tpu_torch.parallel import data_mesh, row_sharding

torch.set_num_threads(1)

TOL = 1e-4
WIDTH, RANK = 32, 16
MESH = data_mesh(devices=["cpu"] * 8)
WORDS = (
    "wolf pack forest snow river delta channel geiger counter radiation "
    "release monday testing alpha beta gamma spring rain harbour ship"
).split()
QUERIES = ["wolf pack in the forest", "geiger counter radiation", "river delta channels"]


def _fill(idx, n: int, dim: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [f"c{i}" for i in range(n)]
    for s in range(4):  # several sources, so tombstones appear
        lo, hi = s * n // 4, (s + 1) * n // 4
        idx.add_chunks(ids[lo:hi], vecs[lo:hi], source_id=f"s{s}")


@pytest.mark.parametrize("dtype, spied", [("float32", "sharded_topk"),
                                          ("int8", "sharded_topk_int8")])
def test_sharded_index_query_routes_through_the_shards(monkeypatch, dtype, spied):
    dim, n, k = 64, 4096, 12
    sharded = VectorIndex(dim=dim, capacity=8192, dtype=dtype, sharding=row_sharding(MESH))
    plain = VectorIndex(dim=dim, capacity=8192, dtype=dtype, device="cpu")
    for index in (sharded, plain):
        _fill(index, n, dim)
        index.delete_source("s1")

    import outline_rag_tpu_torch.parallel.query as pq

    calls = []
    real = getattr(pq, spied)

    def spy(*a, **kw):
        calls.append(kw["mesh"])
        return real(*a, **kw)

    monkeypatch.setattr(pq, spied, spy)
    q = np.random.default_rng(7).standard_normal((5, dim)).astype(np.float32)
    ids_s, vals_s = sharded.query(q, k)
    ids_p, vals_p = plain.query(q, k)
    assert calls == [MESH], "a sharded index must run parallel/query.py's scan"
    assert ids_s == ids_p
    np.testing.assert_array_equal(vals_s, vals_p)


def test_sharded_f32x2_index_query_matches_fp32():
    """The compensated pair layout through the mesh: the fp32 index's ids,
    scores within 1e-5 (the tolerance of ``tests/test_mesh_serving.py``)."""
    dim, n, k = 64, 4096, 10
    sharded = VectorIndex(dim=dim, capacity=8192, dtype="f32x2", sharding=row_sharding(MESH))
    plain = VectorIndex(dim=dim, capacity=8192, device="cpu")
    for index in (sharded, plain):
        _fill(index, n, dim)
        index.delete_source("s2")
    q = np.random.default_rng(5).standard_normal((4, dim)).astype(np.float32)
    ids_s, vals_s = sharded.query(q, k)
    ids_p, vals_p = plain.query(q, k)
    assert ids_s == ids_p
    np.testing.assert_allclose(vals_s, vals_p, atol=1e-5)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def stacks():
    """The same int8r and f32x2 indexes (token cache, lexical weights,
    ColBERT codes) row-sharded in both packages and unsharded in the port,
    with both packages' embedders and rerankers."""
    jcfg = je.EncoderConfig.tiny()
    # weights scaled up from the init's std so neighbouring scores are far
    # above f32 rounding (see tests/test_torch_engine.py)
    params = jax.tree_util.tree_map(
        lambda x: x * 25 if x.ndim == 2 else x, je.init_encoder_params(jax.random.key(0), jcfg)
    )
    params["sparse"] = je.init_sparse_head(jax.random.key(3), jcfg)
    params["colbert"] = je.init_colbert_head(jax.random.key(4), jcfg)
    params["sparse"]["w"] = params["sparse"]["w"] * 25
    params["colbert"]["w"] = params["colbert"]["w"] * 25
    rr_p = init_reranker_params(jax.random.key(1), jcfg)
    tok = HashTokenizer(vocab_size=jcfg.vocab_size)
    cfg = EncoderConfig.tiny()
    out = dict(
        tok=tok, params=params, rr_p=rr_p,
        j_emb=JaxEmbedder(params, jcfg, tok, max_tokens=64, seq_buckets=(32, 64), name="tiny"),
        j_rr=JaxReranker(rr_p, jcfg, tok, max_tokens=128),
        p_emb=EncoderEmbedder(encoder_from_jax(_np_tree(params), cfg, device="cpu"), tok,
                              max_tokens=64, seq_buckets=(32, 64)),
        p_rr=CrossEncoderReranker(reranker_from_jax(_np_tree(rr_p), cfg, device="cpu"), tok,
                                  max_tokens=128),
    )
    rng = np.random.default_rng(0)
    docs = [" ".join(rng.choice(WORDS, rng.integers(4, 20))) for _ in range(120)]
    jmesh = jax_data_mesh()
    for dtype in ("int8r", "f32x2"):
        kw = dict(dim=64, capacity=2048, dtype=dtype, token_width=WIDTH, colbert_rank=RANK)
        j_idx = JaxIndex(sharding=jax_row_sharding(jmesh), **kw)
        sharded = VectorIndex(sharding=row_sharding(MESH), **kw)
        plain = VectorIndex(device="cpu", **kw)
        proj = j_idx.colbert_projection_for(64)
        for index in (sharded, plain):
            index.colbert_proj = proj.copy()
        for s in range(0, len(docs), 10):
            texts = docs[s:s + 10]
            tb = tok.batch(texts, WIDTH, buckets=(WIDTH,))
            codes, scales = out["j_emb"].colbert_cache(tb.input_ids, tb.attention_mask, RANK, proj)
            add = dict(token_ids=tb.input_ids, token_mask=tb.attention_mask,
                       token_weights=out["j_emb"].token_weights(tb.input_ids, tb.attention_mask),
                       colbert_codes=codes, colbert_scales=scales)
            vecs = out["j_emb"].embed(texts)
            for index in (j_idx, sharded, plain):
                index.add_chunks([f"doc{s}:{i}" for i in range(len(texts))], vecs,
                                 source_id=f"doc{s}", **add)
        for index in (j_idx, sharded, plain):
            index.delete_source("doc30")
        out[dtype] = (j_idx, sharded, plain)
    return out


def _assert_rows(got, want, tol):
    assert len(got) == len(want)
    for grow, wrow in zip(got, want):
        assert [c for c, _, _ in grow] == [c for c, _, _ in wrow]
        np.testing.assert_allclose([r for _, r, _ in grow], [r for _, r, _ in wrow], atol=tol)
        np.testing.assert_allclose([d for _, _, d in grow], [d for _, _, d in wrow], atol=tol)


@pytest.mark.parametrize("dtype", ["int8r", "f32x2"])
@pytest.mark.parametrize("weights", [{}, {"lex_weight": 0.3, "colbert_weight": 0.2}],
                         ids=["plain", "hybrid"])
def test_fused_engine_mesh_matches_single_device_and_jax(stacks, monkeypatch, dtype, weights):
    import outline_rag_tpu_torch.engine.fused as fused_mod

    j_idx, sharded, plain = stacks[dtype]
    calls = []
    real = fused_mod.fused_query_mesh
    monkeypatch.setattr(fused_mod, "fused_query_mesh",
                        lambda *a, **kw: calls.append(kw["mesh"]) or real(*a, **kw))
    kw = dict(top_k=12, rerank_k=3, **weights)
    got = FusedEngine(stacks["p_emb"], stacks["p_rr"], sharded, **kw).query(QUERIES)
    assert calls == [MESH]
    single = FusedEngine(stacks["p_emb"], stacks["p_rr"], plain, **kw).query(QUERIES)
    _assert_rows(got, single, 1e-6)
    want = JaxEngine(stacks["j_emb"], stacks["j_rr"], j_idx, **kw).query(QUERIES)
    _assert_rows(got, want, TOL)


def test_fused_engine_mesh_runs_int8_trunks(stacks):
    """ENCODER_INT8 under the mesh: the int8 trunks run once next to the
    row-sharded corpus and return the single-device int8 engine's hits."""
    tok, cfg = stacks["tok"], EncoderConfig.tiny()
    emb = EncoderEmbedder(encoder_from_jax(_np_tree(stacks["params"]), cfg, device="cpu"), tok,
                          max_tokens=64, seq_buckets=(32, 64), int8=True)
    rr = CrossEncoderReranker(reranker_from_jax(_np_tree(stacks["rr_p"]), cfg, device="cpu"), tok,
                              max_tokens=128, int8=True)
    _, sharded, plain = stacks["int8r"]
    got = FusedEngine(emb, rr, sharded, top_k=4, rerank_k=3).query(QUERIES)
    want = FusedEngine(emb, rr, plain, top_k=4, rerank_k=3).query(QUERIES)
    _assert_rows(got, want, 1e-6)


def test_app_serves_ask_through_sharded_index():
    """The whole HTTP surface over a row-sharded index (MESH_DATA_AXIS=2
    over two CPU entries): refresh -> ask -> SSE with citations."""
    from outline_rag_tpu_torch.config import load_settings
    from outline_rag_tpu_torch.models.hash_embedder import HashEmbedder
    from outline_rag_tpu_torch.serve.app import build_app
    from outline_rag_tpu_torch.serve.http import TestClient
    from outline_rag_tpu_torch.serve.llm import FakeChatProvider
    from outline_rag_tpu_torch.storage import SqliteMetaStore
    from outline_rag_tpu_torch.sync.refresh import TASK_QUEUE
    from tests.fake_outline import FakeOutline

    dim = 128
    settings = load_settings({
        "SECRET_KEY": "s", "VECTOR_DIM": str(dim), "DATA_DIR": "",
        "OUTLINE_WEBHOOK_SECRET": "whsec", "SHARD_CAPACITY": "8192", "MESH_DATA_AXIS": "2",
    })
    fake = FakeOutline()
    fake.put_doc("d1", "Wolves", "wolves hunt in packs across the tundra", "t1")
    fake.put_doc("d2", "Rivers", "rivers carve canyons over millennia", "t1")
    app = build_app(
        settings, device="cpu", devices=["cpu"] * 8, provider=FakeChatProvider(),
        embedder=HashEmbedder(dim=dim), meta=SqliteMetaStore(":memory:"),
        outline_transport=fake.transport(), start_workers=False,
    )
    index = app.state["index"]
    assert index.mesh is not None and index.mesh.size == 2
    client = TestClient(app)

    async def run():
        await client.post("/chat/login", body=b"name=tester",
                          headers={"content-type": "application/x-www-form-urlencoded"})
        await client.post("/chat/update/all")
        ing, bus = app.state["ingestor"], app.state["bus"]
        for _ in range(20):
            item = await bus.pop(TASK_QUEUE, timeout=0.01)
            if item is None:
                break
            if item["task"] == "refresh_all":
                await ing.refresh_all()
            else:
                await ing.process_doc_batch(item["ids"])
        assert index.size > 0
        conv = json.loads((await client.post("/chat/api/conversations",
                                             json_body={"title": "t"})).body)
        events = await client.sse("POST", "/chat/api/ask", json_body={
            "question": "how do wolves hunt in the tundra?", "conversation_id": conv["id"]})
        assert "[DONE]" in events
        text = "".join(e["choices"][0]["delta"].get("content", "")
                       for e in events if isinstance(e, dict) and e.get("choices"))
        assert "[SourcesMap]:" in text

    asyncio.run(run())


def test_app_refuses_more_devices_than_visible():
    from outline_rag_tpu_torch.config import load_settings
    from outline_rag_tpu_torch.models.hash_embedder import HashEmbedder
    from outline_rag_tpu_torch.serve.app import build_app
    from outline_rag_tpu_torch.storage import SqliteMetaStore

    settings = load_settings({"SECRET_KEY": "s", "VECTOR_DIM": "64", "DATA_DIR": "",
                              "MESH_DATA_AXIS": "4"})
    with pytest.raises(ValueError, match="MESH_DATA_AXIS=4 asks for more devices"):
        build_app(settings, device="cpu", devices=["cpu", "cpu"], embedder=HashEmbedder(dim=64),
                  meta=SqliteMetaStore(":memory:"), start_workers=False)
