"""The w8a8 encoder / cross-encoder trunk (``ENCODER_INT8``) and the QKV
fusion policy (``ORT_ENCODER_FUSE``), held to the JAX package's
``quantize_encoder_params`` / ``fuse_encoder_params`` on the same weights,
and the five consumers of ``tests/test_encoder_int8.py`` run on the port's
int8 trunk: embeddings, the reranker's order, the embedder, the fused
engine and the heads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from outline_rag_tpu.models import encoder as je
from outline_rag_tpu.models.reranker import init_reranker_params, reranker_forward
from outline_rag_tpu_torch.engine import CrossEncoderReranker, EncoderEmbedder
from outline_rag_tpu_torch.models import convert
from outline_rag_tpu_torch.models.encoder import (
    EncoderConfig,
    Int8Linear,
    fuse_qkv_,
    maybe_fuse_qkv_,
    pooled_embeddings,
    quantize_encoder_,
    sparse_token_weights,
)
from outline_rag_tpu_torch.models.tokenizer import HashTokenizer

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
PROJ = {("attn", "wq"): "q", ("attn", "wk"): "k", ("attn", "wv"): "v", ("attn", "wo"): "o",
        ("mlp", "wi"): "mlp_in", ("mlp", "wo"): "mlp_out"}


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _inputs(batch=8, seq=24, vocab=1024, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(3, vocab, (batch, seq)).astype(np.int32), np.ones((batch, seq), np.int32)


@pytest.fixture(scope="module")
def enc_params():
    return je.init_encoder_params(jax.random.key(0), je.EncoderConfig.tiny())


def _port_encoder(params, dtype=torch.float32):
    return convert.encoder_from_jax(_np_tree(params), EncoderConfig.tiny(dtype=dtype), device="cpu")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_codes_and_scales_byte_equal_to_jax(enc_params, dtype):
    jdt, tdt = DTYPES[dtype]
    jq = je.quantize_encoder_params(je.stack_layer_params(je.cast_params(enc_params, jdt)))
    enc = quantize_encoder_(_port_encoder(enc_params, tdt))
    for i, layer in enumerate(enc.layers):
        for (grp, name), ours in PROJ.items():
            lin = getattr(layer, ours)
            assert isinstance(lin, Int8Linear) and lin.codes.dtype == torch.int8
            np.testing.assert_array_equal(lin.codes.numpy(), np.asarray(jq["layers"][grp][name]["q"][i]))
            np.testing.assert_array_equal(lin.scales.numpy(), np.asarray(jq["layers"][grp][name]["s"][i]))
            assert lin.bias.dtype == tdt
        assert layer.attn_ln.weight.dtype == torch.float32
    # embeddings and layernorms untouched
    assert enc.word.dtype == tdt and not any(isinstance(m, nn.Linear) for m in enc.layers.modules())


def test_fused_codes_equal_the_separate_codes(enc_params):
    sep = quantize_encoder_(_port_encoder(enc_params, torch.bfloat16))
    fused = quantize_encoder_(fuse_qkv_(_port_encoder(enc_params, torch.bfloat16)))
    jq = je.quantize_encoder_params(je.stack_layer_params(
        je.fuse_encoder_params(je.cast_params(enc_params, jnp.bfloat16))))
    for i, (s, f) in enumerate(zip(sep.layers, fused.layers)):
        assert f.q is None and isinstance(f.qkv, Int8Linear)
        assert torch.equal(f.qkv.codes, torch.cat([s.q.codes, s.k.codes, s.v.codes]))
        assert torch.equal(f.qkv.scales, torch.cat([s.q.scales, s.k.scales, s.v.scales]))
        np.testing.assert_array_equal(f.qkv.codes.numpy(), np.asarray(jq["layers"]["attn"]["wqkv"]["q"][i]))


def test_fused_forward_equals_unfused(enc_params):
    ids, mask = (torch.from_numpy(x) for x in _inputs())
    plain = _port_encoder(enc_params)
    fused = fuse_qkv_(_port_encoder(enc_params))
    assert fuse_qkv_(fused) is fused  # fusing twice changes nothing
    with torch.no_grad():
        np.testing.assert_allclose(fused(ids, mask).numpy(), plain(ids, mask).numpy(), atol=1e-5)


def test_the_fusion_policy_follows_the_environment(enc_params, monkeypatch):
    monkeypatch.delenv("ORT_ENCODER_FUSE", raising=False)
    assert maybe_fuse_qkv_(_port_encoder(enc_params)).layers[0].qkv is None  # the default
    monkeypatch.setenv("ORT_ENCODER_FUSE", "1")
    tok = HashTokenizer(vocab_size=1024)
    emb = EncoderEmbedder(_port_encoder(enc_params), tok, max_tokens=32, seq_buckets=(32,))
    assert emb.encoder.layers[0].qkv is not None and emb.encoder.layers[0].q is None


def test_int8_embeddings_match_jax_and_the_float_trunk(enc_params):
    """f32: the port's int8 trunk within 1e-5 of JAX's, cosine > 0.999
    against its own float trunk."""
    cfg = je.EncoderConfig.tiny()
    ids, mask = _inputs()
    jq = je.quantize_encoder_params(je.stack_layer_params(enc_params))
    want = np.asarray(je.pooled_embeddings(jq, jnp.asarray(ids), jnp.asarray(mask), cfg))
    enc = quantize_encoder_(_port_encoder(enc_params))
    t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        got = pooled_embeddings(enc, t_ids, t_mask).numpy()
        dense = pooled_embeddings(_port_encoder(enc_params), t_ids, t_mask).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got * dense).sum(axis=1).min() > 0.999


@pytest.mark.parametrize("dtype", ["bf16"])
def test_int8_embedding_cosine_in_bf16(enc_params, dtype):
    ids, mask = (torch.from_numpy(x) for x in _inputs())
    with torch.no_grad():
        dense = pooled_embeddings(_port_encoder(enc_params, torch.bfloat16), ids, mask)
        q8 = pooled_embeddings(quantize_encoder_(_port_encoder(enc_params, torch.bfloat16)), ids, mask)
    assert (dense * q8).sum(-1).min() > 0.999


def test_int8_reranker_order_matches():
    cfg = je.EncoderConfig.tiny()
    params = init_reranker_params(jax.random.key(1), cfg)
    ids, mask = _inputs(seed=3)
    jq = je.quantize_encoder_params(je.stack_layer_params(params))
    want = np.asarray(reranker_forward(jq, jnp.asarray(ids), jnp.asarray(mask), cfg))
    dense_rr = convert.reranker_from_jax(_np_tree(params), EncoderConfig.tiny(), device="cpu")
    rr = convert.reranker_from_jax(_np_tree(params), EncoderConfig.tiny(), device="cpu")
    quantize_encoder_(rr.encoder)
    assert isinstance(rr.dense, nn.Linear) and rr.dense.weight.dtype == torch.float32
    with torch.no_grad():
        got = rr(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        dense = dense_rr(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (np.argsort(-got) == np.argsort(-dense)).all(), (got, dense)
    assert np.corrcoef(got, dense)[0, 1] > 0.999


def test_embedder_int8_end_to_end(enc_params):
    tok = HashTokenizer(vocab_size=1024)
    texts = ["alpha wolf pack forest", "geiger counter radiation levels"]
    dense = EncoderEmbedder(_port_encoder(enc_params), tok, max_tokens=32, seq_buckets=(32,))
    q8 = EncoderEmbedder(_port_encoder(enc_params), tok, max_tokens=32, seq_buckets=(32,),
                         int8=True)
    assert isinstance(q8.encoder.layers[0].mlp_in, Int8Linear)
    e_d, e_q = dense.embed(texts), q8.embed(texts)
    assert np.allclose(np.linalg.norm(e_q, axis=1), 1.0, atol=1e-4)
    assert (e_d * e_q).sum(axis=1).min() > 0.999


def test_fused_engine_runs_on_int8_trunks(enc_params):
    from outline_rag_tpu_torch.engine.service import RetrievalService
    from outline_rag_tpu_torch.index import VectorIndex

    tok = HashTokenizer(vocab_size=1024)
    emb = EncoderEmbedder(_port_encoder(enc_params), tok, max_tokens=64, seq_buckets=(32, 64),
                          int8=True)
    rr_model = convert.reranker_from_jax(
        _np_tree(init_reranker_params(jax.random.key(1), je.EncoderConfig.tiny())),
        EncoderConfig.tiny(), device="cpu")
    rr = CrossEncoderReranker(rr_model, tok, max_tokens=128, int8=True)
    assert isinstance(rr.model.encoder.layers[0].q, Int8Linear)
    idx = VectorIndex(dim=emb.dim, capacity=2048, token_width=32, device="cpu")
    docs = {"alpha": "the alpha wolf leads the pack through the snowy forest",
            "gamma": "gamma radiation is measured with a geiger counter"}
    for name, text in docs.items():
        tb = tok.batch([text], 32, buckets=(32,))
        idx.add_chunks([f"{name}:0"], emb.embed([text]), source_id=name,
                       token_ids=tb.input_ids, token_mask=tb.attention_mask)
    svc = RetrievalService(idx, emb, rr, top_k=2, rerank_k=2)
    assert svc.fused
    out = svc.retrieve_batch(["wolf pack in the forest"])
    assert out and out[0]
    assert {c.chunk_id for c in out[0]} <= {"alpha:0", "gamma:0"}


def test_heads_run_on_the_int8_trunk(enc_params):
    """The sparse head reads the quantized trunk's hidden states; its
    weights stay in the compute dtype."""
    enc = _port_encoder(enc_params)
    convert.init_sparse_head(enc, torch.Generator().manual_seed(2))
    quantize_encoder_(enc)
    assert isinstance(enc.sparse, nn.Linear)
    ids, mask = (torch.from_numpy(x) for x in _inputs(batch=4))
    with torch.no_grad():
        w = sparse_token_weights(enc, ids, mask).numpy()
    assert w.shape == (4, ids.shape[1])
    assert np.isfinite(w).all() and (w >= 0).all()


def test_quantize_after_fusion_only(enc_params):
    enc = quantize_encoder_(_port_encoder(enc_params))
    with pytest.raises(ValueError, match="fuse before quantizing"):
        fuse_qkv_(enc)
