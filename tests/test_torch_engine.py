"""The port's slice end to end against the JAX package on tiny models: the
fused query (over int8r and f32x2 indexes), the retrieval service (fused
and staged) and the micro-batcher give the same retrieval ids, and rerank
scores within 1e-4."""

import asyncio
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from outline_rag_tpu.engine.embedder import EncoderEmbedder as JaxEmbedder
from outline_rag_tpu.engine.fused import fused_query as jax_fused_query
from outline_rag_tpu.engine.rerank import CrossEncoderReranker as JaxReranker
from outline_rag_tpu.engine.service import RetrievalService as JaxService
from outline_rag_tpu.index.store import VectorIndex as JaxIndex
from outline_rag_tpu.models import encoder as je
from outline_rag_tpu.models.reranker import init_reranker_params
from outline_rag_tpu_torch.engine import (
    CrossEncoderReranker,
    EncoderEmbedder,
    NoopReranker,
    QueryBatcher,
    RetrievalService,
    fused_query,
)
from outline_rag_tpu_torch.index import VectorIndex
from outline_rag_tpu_torch.models.convert import encoder_from_jax, reranker_from_jax
from outline_rag_tpu_torch.models.encoder import EncoderConfig
from outline_rag_tpu_torch.models.tokenizer import HashTokenizer
from outline_rag_tpu_torch.testing import tie_aware_mismatches

torch.set_num_threads(1)

TOL = 1e-4
WIDTH = 32  # token cache width (the tiny config's positions allow 64 + 64)
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


def _docs(n=100, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, rng.integers(4, 20))) for _ in range(n)]


def _ingest(index, embedder, tokenizer, docs):
    for s in range(0, len(docs), 10):  # ten chunks per source
        texts = docs[s : s + 10]
        tb = tokenizer.batch(texts, WIDTH, buckets=(WIDTH,))
        index.add_chunks(
            [f"doc{s}:{i}" for i in range(len(texts))], embedder.embed(texts),
            source_id=f"doc{s}", token_ids=tb.input_ids, token_mask=tb.attention_mask,
        )


@pytest.fixture(scope="module")
def stacks():
    """(jax_service, port_service) over the same tiny models and docs."""
    jcfg = je.EncoderConfig.tiny()
    # weights scaled from the init's std 0.02 to 0.5: at 0.02 the tiny
    # encoder maps every text to nearly the same vector (cosines ~0.99997)
    # and the top-12 is a run of ties; at 0.5 neighbouring scores are
    # 7e-5 or more apart, far above f32 rounding
    enc_p = jax.tree_util.tree_map(
        lambda x: x * 25 if x.ndim == 2 else x,
        je.init_encoder_params(jax.random.key(0), jcfg),
    )
    rr_p = init_reranker_params(jax.random.key(1), jcfg)
    tok = HashTokenizer(vocab_size=jcfg.vocab_size)
    docs = _docs()

    j_emb = JaxEmbedder(enc_p, jcfg, tok, max_tokens=64, seq_buckets=(32, 64), name="tiny")
    j_rr = JaxReranker(rr_p, jcfg, tok, max_tokens=128)
    j_idx = JaxIndex(dim=64, capacity=2048, dtype="int8r", token_width=WIDTH)
    _ingest(j_idx, j_emb, tok, docs)

    np_tree = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    pcfg = EncoderConfig.tiny()
    p_emb = EncoderEmbedder(
        encoder_from_jax(np_tree(enc_p), pcfg, device="cpu"), tok, max_tokens=64, seq_buckets=(32, 64)
    )
    p_rr = CrossEncoderReranker(reranker_from_jax(np_tree(rr_p), pcfg, device="cpu"), tok, max_tokens=128)
    p_idx = VectorIndex(dim=64, capacity=2048, dtype="int8r", device="cpu", token_width=WIDTH)
    _ingest(p_idx, p_emb, tok, docs)
    for index in (j_idx, p_idx):
        index.delete_source("doc30")
    return (
        JaxService(j_idx, j_emb, j_rr, top_k=12, rerank_k=3),
        RetrievalService(p_idx, p_emb, p_rr, top_k=12, rerank_k=3),
    )


def _assert_rows_match(jax_rows, port_rows):
    """Same rerank scores within TOL; the same ids wherever the scores
    around a position are further apart than TOL."""
    assert len(port_rows) == len(jax_rows)
    for jrow, prow in zip(jax_rows, port_rows):
        assert len(prow) == len(jrow)
        jr = np.array([c.rerank_score for c in jrow])
        pr = np.array([c.rerank_score for c in prow])
        np.testing.assert_allclose(pr, jr, rtol=0, atol=TOL)
        np.testing.assert_allclose(
            [c.score for c in prow], [c.score for c in jrow], rtol=0, atol=TOL
        )
        for j, (jc, pc) in enumerate(zip(jrow, prow)):
            gaps = np.abs(jr - jr[j])
            gaps[j] = np.inf
            if gaps.min() > TOL:
                assert pc.chunk_id == jc.chunk_id


def test_fused_query_matches_jax(stacks):
    jsvc, psvc = stacks
    tb = psvc.embedder.tokenizer.batch(QUERIES, 64, buckets=(64,))
    jstate, _, _ = jsvc.index._shard.snapshot()
    jtok = jsvc.index.tokens.state
    want = jax_fused_query(
        jsvc.embedder.params, jsvc.reranker.params, tb.input_ids, tb.attention_mask,
        jstate.vectors, jstate.scales, jstate.penalty, jtok.ids, jtok.mask,
        residual=jstate.residual, enc_cfg=jsvc.embedder.cfg, rr_cfg=jsvc.reranker.cfg,
        top_k=12, rerank_k=3,
    )
    state, _ = psvc.index.snapshot()
    ptok = psvc.index.tokens.state
    with torch.no_grad():
        got = fused_query(
            psvc.embedder.encoder, psvc.reranker.model, torch.from_numpy(tb.input_ids),
            torch.from_numpy(tb.attention_mask), state.vectors, state.scales,
            state.penalty, ptok.ids, ptok.mask, state.residual, top_k=12, rerank_k=3,
        )
    r_rows, r_vals, retr_vals, idx, vals = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[3].numpy(), idx)  # retrieval top-12
    np.testing.assert_allclose(got[4].numpy(), vals, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), r_vals, rtol=0, atol=TOL)
    np.testing.assert_allclose(got[2].numpy(), retr_vals, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def f32x2_stacks(stacks):
    """(jax_service, port_service) over f32x2 indexes of the same docs."""
    jsvc, psvc = stacks
    j_idx = JaxIndex(dim=64, capacity=2048, dtype="f32x2", token_width=WIDTH)
    p_idx = VectorIndex(dim=64, capacity=2048, dtype="f32x2", device="cpu", token_width=WIDTH)
    tok = psvc.embedder.tokenizer
    _ingest(j_idx, jsvc.embedder, tok, _docs())
    _ingest(p_idx, psvc.embedder, tok, _docs())
    for index in (j_idx, p_idx):
        index.delete_source("doc30")
    return (
        JaxService(j_idx, jsvc.embedder, jsvc.reranker, top_k=12, rerank_k=3),
        RetrievalService(p_idx, psvc.embedder, psvc.reranker, top_k=12, rerank_k=3),
    )


def test_fused_query_f32x2_matches_jax(f32x2_stacks):
    """The float branch of stage 2: cosine_topk over bf16 pairs, top_k
    taken directly (no rescore). Retrieval scores within 1e-5 (the sums run
    in another order than XLA's), rows tie-aware equal."""
    jsvc, psvc = f32x2_stacks
    tb = psvc.embedder.tokenizer.batch(QUERIES, 64, buckets=(64,))
    jstate, _, _ = jsvc.index._shard.snapshot()
    jtok = jsvc.index.tokens.state
    want = jax_fused_query(
        jsvc.embedder.params, jsvc.reranker.params, tb.input_ids, tb.attention_mask,
        jstate.vectors, jstate.scales, jstate.penalty, jtok.ids, jtok.mask,
        enc_cfg=jsvc.embedder.cfg, rr_cfg=jsvc.reranker.cfg, top_k=12, rerank_k=3,
    )
    state, _ = psvc.index.snapshot()
    assert state.vectors.dtype == torch.bfloat16 and state.vectors.shape[1] == 128
    ptok = psvc.index.tokens.state
    with torch.no_grad():
        got = fused_query(
            psvc.embedder.encoder, psvc.reranker.model, torch.from_numpy(tb.input_ids),
            torch.from_numpy(tb.attention_mask), state.vectors, state.scales,
            state.penalty, ptok.ids, ptok.mask, top_k=12, rerank_k=3,
        )
    r_rows, r_vals, retr_vals, idx, vals = (np.array(x) for x in want)
    assert tie_aware_mismatches(got[4], got[3], vals, idx, 1e-5) == 0
    np.testing.assert_array_equal(got[0].numpy(), r_rows)
    np.testing.assert_allclose(got[1].numpy(), r_vals, rtol=0, atol=TOL)
    np.testing.assert_allclose(got[2].numpy(), retr_vals, rtol=0, atol=TOL)


def test_service_f32x2_through_batcher_matches_jax(f32x2_stacks):
    jsvc, psvc = f32x2_stacks
    assert psvc.fused and jsvc.fused

    async def run():
        batcher = QueryBatcher(psvc.retrieve_batch, window_ms=50, max_batch=4)
        try:
            return await asyncio.gather(*(batcher.retrieve(q) for q in QUERIES))
        finally:
            await batcher.stop()

    port_rows = asyncio.run(run())
    _assert_rows_match(jsvc.retrieve_batch(QUERIES), port_rows)
    for row in port_rows:
        ids = [c.chunk_id for c in row]
        assert len(ids) == 3 == len(set(ids))
        assert not any(c.startswith("doc30:") for c in ids)


def test_service_through_batcher_matches_jax(stacks):
    jsvc, psvc = stacks
    assert psvc.fused and jsvc.fused
    calls = []

    def batch_fn(queries):
        calls.append(len(queries))
        return psvc.retrieve_batch(queries)

    async def run():
        batcher = QueryBatcher(batch_fn, window_ms=50, max_batch=4)
        try:
            return await asyncio.gather(*(batcher.retrieve(q) for q in QUERIES))
        finally:
            await batcher.stop()

    port_rows = asyncio.run(run())
    _assert_rows_match(jsvc.retrieve_batch(QUERIES), port_rows)
    assert sum(calls) == len(QUERIES) and len(calls) < len(QUERIES)
    for row in port_rows:
        ids = [c.chunk_id for c in row]
        assert len(ids) == 3 == len(set(ids))
        assert not any(c.startswith("doc30:") for c in ids)


def test_staged_path_matches_jax(stacks):
    jsvc, psvc = stacks
    jstaged = JaxService(jsvc.index, jsvc.embedder, top_k=12, rerank_k=3)
    pstaged = RetrievalService(psvc.index, psvc.embedder, NoopReranker(), top_k=12, rerank_k=3)
    assert not pstaged.fused
    jrows, prows = jstaged.retrieve_batch(QUERIES), pstaged.retrieve_batch(QUERIES)
    for jrow, prow in zip(jrows, prows):
        assert [c.chunk_id for c in prow] == [c.chunk_id for c in jrow]
        np.testing.assert_allclose(
            [c.score for c in prow], [c.score for c in jrow], rtol=0, atol=TOL
        )


def test_fused_errors_propagate(stacks):
    _, psvc = stacks
    svc = RetrievalService(psvc.index, psvc.embedder, psvc.reranker, top_k=12, rerank_k=3)

    def broken(texts):
        raise RuntimeError("scan failed")

    svc._fused.query = broken
    with pytest.raises(RuntimeError, match="scan failed"):
        svc.retrieve_batch(["anything"])


_NO_JAX_SLICE = """
import asyncio, importlib, pkgutil, sys
import numpy as np, torch
import outline_rag_tpu_torch
for m in pkgutil.walk_packages(outline_rag_tpu_torch.__path__, "outline_rag_tpu_torch."):
    importlib.import_module(m.name)
from outline_rag_tpu_torch.engine import (
    CrossEncoderReranker, EncoderEmbedder, QueryBatcher, RetrievalService)
from outline_rag_tpu_torch.index import VectorIndex
from outline_rag_tpu_torch.models import EncoderConfig, init_encoder, init_reranker
from outline_rag_tpu_torch.models.tokenizer import HashTokenizer
torch.set_num_threads(1)
cfg, tok, gen = EncoderConfig.tiny(), HashTokenizer(1024), torch.Generator().manual_seed(0)
emb = EncoderEmbedder(init_encoder(cfg, gen, "cpu"), tok, max_tokens=64, seq_buckets=(32, 64))
rr = CrossEncoderReranker(init_reranker(cfg, gen, "cpu"), tok, max_tokens=128)
index = VectorIndex(dim=64, capacity=1024, dtype="int8r", device="cpu", token_width=32)
texts = ["chunk %d about topic %d" % (i, i % 7) for i in range(80)]
tb = tok.batch(texts, 32, buckets=(32,))
index.add_chunks(["c%d" % i for i in range(80)], emb.embed(texts), "s",
                 token_ids=tb.input_ids, token_mask=tb.attention_mask)
svc = RetrievalService(index, emb, rr, top_k=12, rerank_k=3)
async def main():
    b = QueryBatcher(svc.retrieve_batch, max_batch=32)
    try:
        return await asyncio.gather(*(b.retrieve("topic %d" % i) for i in range(6)))
    finally:
        await b.stop()
rows = asyncio.run(main())
assert svc.fused and all(len(r) == 3 for r in rows)
bad = sorted(m for m in sys.modules
             if m in ("jax", "outline_rag_tpu") or m.startswith(("jax.", "outline_rag_tpu.")))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_runs_without_jax():
    """Every port module imports, and the tiny slice serves, with neither
    jax nor the JAX package loaded."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SLICE], cwd=root, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
