"""BGE-m3's sparse and ColBERT heads and the two hybrid terms of the fused
query, port against the JAX package on the same numpy weights of a tiny
encoder with both heads: the head outputs, the cache codes, the two score
functions, and ``fused_query`` / ``FusedEngine`` with ``lex_weight`` and
``colbert_weight`` in the cached and the recompute forms (retrieval rows
exact, scores within 1e-5, rerank scores within 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outline_rag_tpu.engine.embedder import EncoderEmbedder as JaxEmbedder
from outline_rag_tpu.engine.fused import FusedEngine as JaxEngine
from outline_rag_tpu.engine.fused import fused_query as jax_fused_query
from outline_rag_tpu.engine.rerank import CrossEncoderReranker as JaxReranker
from outline_rag_tpu.index.store import VectorIndex as JaxIndex
from outline_rag_tpu.models import encoder as je
from outline_rag_tpu.models.reranker import init_reranker_params
from outline_rag_tpu_torch.engine import (
    CrossEncoderReranker,
    EncoderEmbedder,
    FusedEngine,
    RetrievalService,
    fused_query,
)
from outline_rag_tpu_torch.index import VectorIndex
from outline_rag_tpu_torch.models import encoder as pe
from outline_rag_tpu_torch.models.convert import (
    encoder_from_jax,
    init_colbert_head,
    init_encoder,
    init_sparse_head,
    reranker_from_jax,
)
from outline_rag_tpu_torch.models.encoder import EncoderConfig
from outline_rag_tpu_torch.models.tokenizer import HashTokenizer

torch.set_num_threads(1)

TOL = 1e-4  # rerank scores, as tests/test_torch_engine.py
VAL_TOL = 1e-5  # retrieval scores, terms included
WIDTH, RANK = 32, 16
WORDS = (
    "wolf pack forest snow river delta channel geiger counter radiation "
    "release monday testing alpha beta gamma spring rain harbour ship"
).split()
QUERIES = [
    "wolf pack in the forest",
    "geiger counter radiation",
    "river delta channels",
    "release testing monday",
    "snow ship harbour",
]


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def models():
    """(JAX params with both heads, the port's encoder of them, tokenizer)."""
    jcfg = je.EncoderConfig.tiny()
    params = jax.tree_util.tree_map(
        lambda x: x * 25 if x.ndim == 2 else x,
        je.init_encoder_params(jax.random.key(0), jcfg),
    )
    params["sparse"] = je.init_sparse_head(jax.random.key(3), jcfg)
    params["colbert"] = je.init_colbert_head(jax.random.key(4), jcfg)
    params["sparse"]["w"] = params["sparse"]["w"] * 25
    params["colbert"]["w"] = params["colbert"]["w"] * 25
    enc = encoder_from_jax(_np_tree(params), EncoderConfig.tiny(), device="cpu")
    return jcfg, params, enc, HashTokenizer(vocab_size=jcfg.vocab_size)


def _batch(tok, texts, width=WIDTH):
    tb = tok.batch(texts, width, buckets=(width,))
    return tb.input_ids, tb.attention_mask


def _docs(n=100, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, rng.integers(4, 20))) for _ in range(n)]


def test_encoder_from_jax_carries_both_heads(models):
    _, params, enc, _ = models
    assert enc.sparse.weight.shape == (1, 64) and enc.colbert.weight.shape == (64, 64)
    np.testing.assert_array_equal(enc.colbert.weight.detach().numpy(),
                                  np.asarray(params["colbert"]["w"]).T)
    plain = encoder_from_jax(_np_tree({k: v for k, v in params.items()
                                       if k not in ("sparse", "colbert")}),
                             EncoderConfig.tiny(), device="cpu")
    assert plain.sparse is None and plain.colbert is None


def test_sparse_weights_match_jax(models):
    jcfg, params, enc, tok = models
    ids, mask = _batch(tok, _docs(6))
    want = np.asarray(je.sparse_token_weights(params, ids, mask, jcfg))
    with torch.no_grad():
        got = pe.sparse_token_weights(enc, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    # the trunks agree to ~1e-5 (tests/test_torch_models.py); the x25 head
    # sums 64 of those with weights of std 0.5, into values up to ~4
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    masked = (mask == 0) | (ids < 3)  # padding, CLS and EOS
    assert masked.any() and (got[masked] == 0).all()
    assert (got[~masked] > 0).mean() > 0.3


def test_colbert_vectors_match_jax(models):
    jcfg, params, enc, tok = models
    ids, mask = _batch(tok, _docs(6))
    want = np.asarray(je.colbert_token_vectors(params, ids, jnp.asarray(mask), jcfg))
    with torch.no_grad():
        got = pe.colbert_token_vectors(enc, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[:, 0] == 0).all() and (got[mask == 0] == 0).all()
    norms = np.linalg.norm(got, axis=-1)
    np.testing.assert_allclose(norms[:, 1:][mask[:, 1:] == 1], 1.0, atol=1e-5)


def _jax_codes_on(params, jcfg, hidden, ids, mask, proj, monkeypatch):
    """JAX's jitted colbert_cache_codes with the encoder forward replaced
    by ``hidden``: the same hidden states on both sides."""
    monkeypatch.setattr(je, "encoder_forward", lambda p, i, m, c, **kw: jnp.asarray(hidden))
    fn = jax.jit(lambda p, i, m: je.colbert_cache_codes(p, i, m, jcfg, jnp.asarray(proj)))
    codes, scales = fn(params, ids, mask)
    return np.asarray(codes), np.asarray(scales)


def _port_codes_on(enc, hidden, ids, mask, proj, monkeypatch):
    monkeypatch.setattr(pe, "colbert_token_vectors", lambda e, i, m: pe.colbert_vectors_from_hidden(
        e, torch.from_numpy(hidden), m))
    with torch.no_grad():
        codes, scales = pe.colbert_cache_codes(enc, torch.from_numpy(ids),
                                               torch.from_numpy(mask), torch.from_numpy(proj))
    return codes.numpy(), scales.numpy()


def test_colbert_quantizer_byte_equal_to_jax(models, monkeypatch):
    """The same token vectors through the identity projection (exact in
    any summation order): codes byte-equal and scales bit-equal, the scale
    being ``amax * f32(1/127)`` as XLA compiles ``amax / 127``."""
    jcfg, params, enc, tok = models
    ids, mask = _batch(tok, _docs(8))
    vecs = np.random.default_rng(1).standard_normal((8, WIDTH, 64)).astype(np.float32)
    vecs[:, 0] = 0.0  # CLS, zeroed as the head zeroes it
    vecs[mask == 0] = 0.0
    eye = np.eye(64, dtype=np.float32)
    monkeypatch.setattr(je, "colbert_token_vectors", lambda p, i, m, c: jnp.asarray(vecs))
    monkeypatch.setattr(pe, "colbert_token_vectors", lambda e, i, m: torch.from_numpy(vecs))
    jc, js = jax.jit(lambda p, i, m: je.colbert_cache_codes(p, i, m, jcfg, jnp.asarray(eye)))(
        params, ids, mask)
    jc, js = np.asarray(jc), np.asarray(js)
    pc, ps = (x.numpy() for x in pe.colbert_cache_codes(
        enc, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(eye)))
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(ps.view(np.uint32), js.view(np.uint32))
    assert (ps[:, 0] == 0).all() and (pc[mask == 0] == 0).all() and (ps[:, 1:][mask[:, 1:] == 1] > 0).all()


def test_colbert_cache_codes_match_jax(models, monkeypatch):
    """The same hidden states and a rank-16 projection: codes byte-equal;
    a scale may sit a few ulps away, because the two packages sum each
    vector's norm in another order (XLA's row reduction cannot be
    reproduced in PyTorch)."""
    jcfg, params, enc, tok = models
    ids, mask = _batch(tok, _docs(8))
    hidden = np.random.default_rng(2).standard_normal((8, WIDTH, 64)).astype(np.float32)
    proj = np.asarray(je.colbert_projection(64, RANK))
    jc, js = _jax_codes_on(params, jcfg, hidden, ids, mask, proj, monkeypatch)
    pc, ps = _port_codes_on(enc, hidden, ids, mask, proj, monkeypatch)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_allclose(ps, js, rtol=1e-6, atol=0)


def test_late_interaction_and_lexical_scores_match_jax():
    rng = np.random.default_rng(5)
    b, k, tq, tc, h = 3, 4, 6, 7, 16
    q_vecs = rng.standard_normal((b, tq, h)).astype(np.float32)
    c_vecs = rng.standard_normal((b, k, tc, h)).astype(np.float32)
    q_mask = np.ones((b, tq), np.int32)
    q_mask[1, 4:] = 0
    want = np.asarray(je.late_interaction_scores(q_vecs, jnp.asarray(q_mask), c_vecs))
    got = pe.late_interaction_scores(torch.from_numpy(q_vecs), torch.from_numpy(q_mask),
                                     torch.from_numpy(c_vecs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    q_ids = rng.integers(3, 9, (b, tq)).astype(np.int32)
    c_ids = rng.integers(3, 9, (b, k, tc)).astype(np.int32)
    q_w = rng.random((b, tq)).astype(np.float32)
    c_w = rng.random((b, k, tc)).astype(np.float32)
    want = np.asarray(je.lexical_overlap_scores(q_ids, q_w, c_ids, c_w))
    got = pe.lexical_overlap_scores(*(torch.from_numpy(x) for x in (q_ids, q_w, c_ids, c_w)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # a token repeated in the candidate counts once, at its largest weight;
    # a query token repeated counts each time
    one = pe.lexical_overlap_scores(
        torch.tensor([[5, 5, 6]]), torch.tensor([[0.5, 0.25, 1.0]]),
        torch.tensor([[[5, 5, 7]]]), torch.tensor([[[0.2, 0.8, 3.0]]]),
    )
    assert float(one) == pytest.approx(0.5 * 0.8 + 0.25 * 0.8)


def test_colbert_projection_is_orthonormal_with_positive_r_diagonal():
    dim, rank = 64, RANK
    p = pe.colbert_projection(dim, rank)
    assert p.shape == (dim, rank) and p.dtype == torch.float32 and p.device.type == "cpu"
    q = p / (dim / rank) ** 0.5
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(rank), atol=1e-5)
    g = torch.randn((dim, rank), generator=torch.Generator().manual_seed(pe.COLBERT_SEED))
    assert (torch.diagonal(q.T @ g) > 0).all()  # R = Q^T G, its diagonal made positive
    assert torch.equal(p, pe.colbert_projection(dim, rank))  # the same matrix every call
    full = pe.colbert_projection(dim, dim)
    np.testing.assert_allclose((full.T @ full).numpy(), np.eye(dim), atol=1e-5)


def test_seeded_heads_are_deterministic():
    cfg = EncoderConfig.tiny()
    encs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(9)
        enc = init_encoder(cfg, gen, "cpu")
        init_colbert_head(init_sparse_head(enc, gen), gen)
        encs.append(enc)
    assert torch.equal(encs[0].colbert.weight, encs[1].colbert.weight)
    assert encs[0].colbert.weight.shape == (64, 64) and encs[0].sparse.weight.shape == (1, 64)
    assert float(encs[0].colbert.weight.detach().std()) == pytest.approx(0.02, rel=0.1)
    assert (encs[0].sparse.bias == 0).all() and (encs[0].colbert.bias == 0).all()


@pytest.fixture(scope="module")
def hybrid(models):
    """The same int8r index with a token cache, lexical weights and
    ColBERT codes in both packages (JAX's embeddings, weights and codes
    written to both), plus both packages' embedders and rerankers."""
    jcfg, params, enc, tok = models
    rr_p = init_reranker_params(jax.random.key(1), jcfg)
    j_emb = JaxEmbedder(params, jcfg, tok, max_tokens=64, seq_buckets=(32, 64), name="tiny")
    j_rr = JaxReranker(rr_p, jcfg, tok, max_tokens=128)
    p_emb = EncoderEmbedder(enc, tok, max_tokens=64, seq_buckets=(32, 64))
    p_rr = CrossEncoderReranker(reranker_from_jax(_np_tree(rr_p), EncoderConfig.tiny(),
                                                  device="cpu"), tok, max_tokens=128)
    j_idx = JaxIndex(dim=64, capacity=2048, dtype="int8r", token_width=WIDTH, colbert_rank=RANK)
    p_idx = VectorIndex(dim=64, capacity=2048, dtype="int8r", device="cpu", token_width=WIDTH,
                        colbert_rank=RANK)
    proj = j_idx.colbert_projection_for(64)
    p_idx.colbert_proj = proj.copy()
    docs = _docs()
    for s in range(0, len(docs), 10):
        texts = docs[s : s + 10]
        ids, mask = _batch(tok, texts)
        codes, scales = j_emb.colbert_cache(ids, mask, RANK, proj)
        kw = dict(token_ids=ids, token_mask=mask, token_weights=j_emb.token_weights(ids, mask),
                  colbert_codes=codes, colbert_scales=scales)
        vecs = j_emb.embed(texts)
        for index in (j_idx, p_idx):
            index.add_chunks([f"doc{s}:{i}" for i in range(len(texts))], vecs,
                             source_id=f"doc{s}", **kw)
    for index in (j_idx, p_idx):
        index.delete_source("doc30")
    return dict(j_emb=j_emb, j_rr=j_rr, j_idx=j_idx, p_emb=p_emb, p_rr=p_rr, p_idx=p_idx,
                tok=tok, proj=proj)


def test_embedder_heads_match_jax(hybrid):
    tok, j_emb, p_emb = hybrid["tok"], hybrid["j_emb"], hybrid["p_emb"]
    assert p_emb.has_sparse_head and p_emb.has_colbert_head
    ids, mask = _batch(tok, _docs(12, seed=3))
    # as in test_sparse_weights_match_jax
    np.testing.assert_allclose(p_emb.token_weights(ids, mask), j_emb.token_weights(ids, mask),
                               rtol=0, atol=5e-5)
    proj = hybrid["proj"]
    pc, ps = p_emb.colbert_cache(ids, mask, RANK, proj)
    jc, js = j_emb.colbert_cache(ids, mask, RANK, proj)
    assert pc.shape == jc.shape == (12, WIDTH, RANK) and pc.dtype == np.int8
    # the hidden states differ in the last bits: within one code step
    step = np.maximum(ps, js)[..., None] * 1.01
    assert (np.abs(pc * ps[..., None] - jc * js[..., None]) <= step).all()


def _fused_pair(h, texts, *, cached, width=64, **weights):
    tb = h["tok"].batch(texts, width, buckets=(width,))
    j_idx, p_idx = h["j_idx"], h["p_idx"]
    jstate, _, _ = j_idx._shard.snapshot()
    jtok, jcb = j_idx.tokens.state, j_idx.tokens.colbert
    want = jax_fused_query(
        h["j_emb"].params, h["j_rr"].params, tb.input_ids, tb.attention_mask,
        jstate.vectors, jstate.scales, jstate.penalty, jtok.ids, jtok.mask, jtok.weights,
        jcb.codes if cached else None, jcb.scales if cached else None,
        jnp.asarray(h["proj"]) if cached else None, jstate.residual,
        enc_cfg=h["j_emb"].cfg, rr_cfg=h["j_rr"].cfg, top_k=12, rerank_k=3, **weights,
    )
    state, _ = p_idx.snapshot()
    ptok, pcb = p_idx.tokens.state, p_idx.tokens.colbert
    with torch.no_grad():
        got = fused_query(
            h["p_emb"].encoder, h["p_rr"].model, torch.from_numpy(tb.input_ids),
            torch.from_numpy(tb.attention_mask), state.vectors, state.scales, state.penalty,
            ptok.ids, ptok.mask, state.residual, top_k=12, rerank_k=3,
            tok_weights=ptok.weights,
            tok_cvecs=pcb.codes if cached else None, tok_cscale=pcb.scales if cached else None,
            colbert_proj=torch.from_numpy(h["proj"]) if cached else None, **weights,
        )
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "recompute"])
def test_fused_query_hybrid_matches_jax(hybrid, cached):
    weights = dict(lex_weight=0.3, colbert_weight=0.2)
    want, got = _fused_pair(hybrid, QUERIES, cached=cached, **weights)
    np.testing.assert_array_equal(got[3], want[3])  # retrieval rows
    np.testing.assert_allclose(got[4], want[4], rtol=0, atol=VAL_TOL)
    np.testing.assert_array_equal(got[0], want[0])  # rerank rows
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=TOL)
    # the terms moved the retrieval scores of (almost) every live candidate
    _, off = _fused_pair(hybrid, QUERIES, cached=cached)
    assert (np.abs(got[4] - off[4]) > 1e-4).mean() > 0.9
    np.testing.assert_array_equal(got[3], off[3])  # but not the candidates


def test_each_term_alone_matches_jax(hybrid):
    for weights in (dict(lex_weight=0.5), dict(colbert_weight=0.5)):
        want, got = _fused_pair(hybrid, QUERIES[:3], cached=True, **weights)
        np.testing.assert_array_equal(got[3], want[3])
        np.testing.assert_allclose(got[4], want[4], rtol=0, atol=VAL_TOL)


def _engines(h, **kw):
    return (
        JaxEngine(h["j_emb"], h["j_rr"], h["j_idx"], top_k=12, rerank_k=3, **kw),
        FusedEngine(h["p_emb"], h["p_rr"], h["p_idx"], top_k=12, rerank_k=3, **kw),
    )


def _assert_engine_rows(jrows, prows):
    assert len(prows) == len(jrows)
    for jrow, prow in zip(jrows, prows):
        assert [c for c, _, _ in prow] == [c for c, _, _ in jrow]
        np.testing.assert_allclose([r for _, r, _ in prow], [r for _, r, _ in jrow], atol=TOL)
        np.testing.assert_allclose([d for _, _, d in prow], [d for _, _, d in jrow], atol=TOL)


@pytest.mark.parametrize("q_width", [64, 32])
def test_engine_hybrid_matches_jax(hybrid, q_width):
    jeng, peng = _engines(hybrid, q_width=q_width, lex_weight=0.3, colbert_weight=0.2)
    assert peng.q_width == q_width
    _assert_engine_rows(jeng.query(QUERIES), peng.query(QUERIES))


def test_service_passes_the_weights_through(hybrid):
    svc = RetrievalService(hybrid["p_idx"], hybrid["p_emb"], hybrid["p_rr"], top_k=12,
                           rerank_k=3, lex_weight=0.3, colbert_weight=0.2)
    assert svc.fused and svc._fused.lex_weight == 0.3 and svc._fused.colbert_weight == 0.2
    _, peng = _engines(hybrid, lex_weight=0.3, colbert_weight=0.2)
    rows = svc.retrieve_batch(QUERIES)
    assert [[(c.chunk_id, c.rerank_score, c.score) for c in row] for row in rows] == \
        [[(c, r, d) for c, r, d in row] for row in peng.query(QUERIES)]


def test_engine_repins_projection_after_adopt(hybrid, tmp_path):
    """A snapshot adopted after the engine was built brings its own
    matrix; the engine projects queries with it from the next query on."""
    p_idx = hybrid["p_idx"]
    p_idx.save(str(tmp_path / "snap"))
    live = VectorIndex(dim=64, capacity=2048, dtype="int8r", device="cpu", token_width=WIDTH,
                       colbert_rank=RANK)
    engine = FusedEngine(hybrid["p_emb"], hybrid["p_rr"], live, top_k=12, rerank_k=3,
                         colbert_weight=0.2)
    pinned = engine._pin_projection()
    assert not np.array_equal(pinned.numpy(), hybrid["proj"])  # the port's own matrix
    live.adopt(VectorIndex.load(str(tmp_path / "snap"), device="cpu"))
    np.testing.assert_array_equal(engine._pin_projection().numpy(), hybrid["proj"])
    ref = FusedEngine(hybrid["p_emb"], hybrid["p_rr"], p_idx, top_k=12, rerank_k=3,
                      colbert_weight=0.2)
    assert engine.query(QUERIES) == ref.query(QUERIES)


def test_colbert_rows_survive_compact(hybrid, tmp_path):
    """Compaction moves rows; the ColBERT codes move with them, so the
    hybrid answers are unchanged."""
    hybrid["p_idx"].save(str(tmp_path / "snap"))
    p_idx = VectorIndex.load(str(tmp_path / "snap"), device="cpu")
    p_idx.delete_source("doc0")
    engine = FusedEngine(hybrid["p_emb"], hybrid["p_rr"], p_idx, top_k=12, rerank_k=3,
                         lex_weight=0.3, colbert_weight=0.2)
    before = engine.query(QUERIES)
    cb_before = {c: p_idx.tokens.colbert.codes[r].clone() for c, r in p_idx._by_chunk.items()}
    p_idx.compact()
    assert p_idx._shard.cursor == p_idx.size == 80
    for c, r in p_idx._by_chunk.items():
        assert torch.equal(p_idx.tokens.colbert.codes[r], cb_before[c])
    assert engine.query(QUERIES) == before


def test_weights_off_launch_what_the_plain_path_launches(hybrid, monkeypatch):
    """With both weights 0 the fused query runs no head and no extra
    encoder forward: the encoder runs once, for the queries."""
    calls = []
    enc = hybrid["p_emb"].encoder
    real = type(enc).forward

    def forward(self, i, m, **kw):
        if self is enc:  # the reranker's trunk is an Encoder too
            calls.append(tuple(i.shape))
        return real(self, i, m, **kw)

    monkeypatch.setattr(type(enc), "forward", forward)
    for name in ("sparse_weights_from_hidden", "colbert_vectors_from_hidden",
                 "lexical_overlap_scores", "late_interaction_scores"):
        monkeypatch.setattr(f"outline_rag_tpu_torch.engine.fused.{name}",
                            lambda *a, **k: pytest.fail("a hybrid term ran"))
    _, peng = _engines(hybrid)
    peng.query(QUERIES)
    assert calls == [(len(QUERIES), 64)]
