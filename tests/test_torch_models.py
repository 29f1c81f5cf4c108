"""The port's encoder and reranker compute the JAX package's functions:
the same parameters (through ``encoder_from_jax`` / ``reranker_from_jax``)
and the same token batches give the same outputs, within 1e-5 in f32 and
2e-2 in bf16 (where the cast rule puts the embeddings, the dense weights
and the classifier head in bf16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outline_rag_tpu.models import encoder as je
from outline_rag_tpu.models.reranker import init_reranker_params, reranker_forward
from outline_rag_tpu.models.tokenizer import HashTokenizer
from outline_rag_tpu_torch.models import convert
from outline_rag_tpu_torch.models.encoder import EncoderConfig, pooled_embeddings

torch.set_num_threads(1)

TEXTS = [
    "the alpha wolf leads the pack",
    "beta testing of the new release starts on monday morning early",
    "gamma",
    "the river delta spreads into many small channels " * 3,
]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _configs(name):
    jdt, tdt, tol = DTYPES[name]
    return je.EncoderConfig.tiny(dtype=jdt), EncoderConfig.tiny(dtype=tdt), tol


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(width=32):
    tb = HashTokenizer(vocab_size=1024).batch(TEXTS, width, buckets=(width,))
    return tb.input_ids, tb.attention_mask


@pytest.fixture(scope="module")
def enc_params():
    return je.init_encoder_params(jax.random.key(0), je.EncoderConfig.tiny())


@pytest.fixture(scope="module")
def rr_params():
    return init_reranker_params(jax.random.key(1), je.EncoderConfig.tiny())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encoder_hidden_states_match_jax(enc_params, dtype):
    jcfg, pcfg, tol = _configs(dtype)
    ids, mask = _batch()
    want = je.encoder_forward(je.cast_params(enc_params, jcfg.dtype), ids, mask, jcfg)
    enc = convert.encoder_from_jax(_np_tree(enc_params), pcfg, device="cpu")
    with torch.no_grad():
        got = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == pcfg.dtype
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=0, atol=tol
    )


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pooled_embeddings_match_jax(enc_params, dtype):
    jcfg, pcfg, tol = _configs(dtype)
    ids, mask = _batch()
    want = je.pooled_embeddings(je.cast_params(enc_params, jcfg.dtype), ids, mask, jcfg)
    enc = convert.encoder_from_jax(_np_tree(enc_params), pcfg, device="cpu")
    with torch.no_grad():
        got = pooled_embeddings(enc, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reranker_scores_match_jax(rr_params, dtype):
    jcfg, pcfg, tol = _configs(dtype)
    tb = HashTokenizer(1024).batch_pairs(["wolf pack"] * 4, TEXTS, 128, (64, 128))
    want = reranker_forward(
        je.cast_params(rr_params, jcfg.dtype), tb.input_ids, tb.attention_mask, jcfg
    )
    rr = convert.reranker_from_jax(_np_tree(rr_params), pcfg, device="cpu")
    with torch.no_grad():
        got = rr(torch.from_numpy(tb.input_ids), torch.from_numpy(tb.attention_mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)


def test_cast_rule_dtypes():
    """Dense weights, biases, embeddings and the classifier in the compute
    dtype; layernorm parameters in f32."""
    rr = convert.reranker_from_jax(
        _np_tree(init_reranker_params(jax.random.key(1), je.EncoderConfig.tiny())),
        EncoderConfig.tiny(dtype=torch.bfloat16),
        device="cpu",
    )
    for name, p in rr.named_parameters():
        want = torch.float32 if "_ln." in name else torch.bfloat16
        assert p.dtype == want, name


def test_seeded_init_is_deterministic_and_scaled():
    cfg = EncoderConfig.tiny()
    a = convert.init_encoder(cfg, torch.Generator().manual_seed(3), "cpu")
    b = convert.init_encoder(cfg, torch.Generator().manual_seed(3), "cpu")
    c = convert.init_encoder(cfg, torch.Generator().manual_seed(4), "cpu")
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name
        if pa.dim() == 2:
            assert not torch.equal(pa, pc), name
            assert abs(pa.std().item() - 0.02) < 0.004, name
        else:  # biases 0, layernorm scales 1
            assert set(pa.unique().tolist()) <= {0.0, 1.0}, name
    rr = convert.init_reranker(cfg, torch.Generator().manual_seed(3), "cpu")
    ids, mask = _batch()
    with torch.no_grad():
        assert torch.isfinite(rr(torch.from_numpy(ids), torch.from_numpy(mask))).all()
