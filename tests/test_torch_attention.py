"""The port's flash attention and whole-document ingest against the JAX
package: the plain twin against the Pallas kernel in interpret mode, the
tiny encoder with ``attn_impl="flash"`` against the JAX encoder's flash
route, and the whole-document embedder against the JAX one.

Inputs come from numpy with a seed (or the JAX package's seeded init,
carried over with ``encoder_from_jax``). On CPU tensors ``flash_attention``
runs its plain twin; the CUDA kernel is held to that twin on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``). Tolerances: 1e-5 in
f32 for attention alone, 5e-5 through the encoder (the JAX package's own
flash-vs-einsum bound). In bf16 attention alone, each element within
2e-3 + 2 bf16 ulps of JAX's and the error's norm within 1e-2 of the
output's (outputs here are 0.07-0.2 on average and up to 2; P is rounded
to bf16 against a running max over key tiles in the Pallas kernel and
against the whole row's max in the twin).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outline_rag_tpu.engine.embedder import EncoderEmbedder as JaxEmbedder
from outline_rag_tpu.models import encoder as je
from outline_rag_tpu.models.tokenizer import HashTokenizer
from outline_rag_tpu.ops.attention import flash_attention as jax_flash
from outline_rag_tpu_torch.engine import EncoderEmbedder
from outline_rag_tpu_torch.models import convert
from outline_rag_tpu_torch.models.encoder import EncoderConfig, use_flash
from outline_rag_tpu_torch.models.tokenizer import LONG_BUCKETS
from outline_rag_tpu_torch.ops.attention import (
    NEG_BIAS,
    flash_attention,
    flash_attention_plain,
)
from outline_rag_tpu_torch.testing import flash_errors

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_ATOL, BF16_ULPS, BF16_REL_RMS = 2e-3, 2.0, 1e-2


def _qkv(seed, b, s, h=2, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


def _bias(lengths, s):
    bias = np.zeros((len(lengths), s), np.float32)
    for i, n in enumerate(lengths):
        bias[i, n:] = NEG_BIAS
    return bias


def _both(q, k, v, bias, dtype, block=64):
    jdt, tdt = DTYPES[dtype]
    want = jax_flash(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), jnp.asarray(bias),
        block_q=block, block_k=block, interpret=True,
    )
    got = flash_attention_plain(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                torch.from_numpy(bias))
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    return np.array(want.astype(jnp.float32)), got.float().numpy()


def _assert_close(got, want, dtype):
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        return
    err = flash_errors(torch.from_numpy(got), torch.from_numpy(want), BF16_ATOL, BF16_ULPS)
    assert err["worst_vs_bound"] <= 1.0 and err["rel_rms_err"] <= BF16_REL_RMS, err


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "s,lengths",
    [
        (256, [256, 256]),  # every key live
        (256, [40, 256]),  # a short document in a long bucket: skipped tiles
        (200, [200, 131, 7]),  # S not a multiple of the tile
    ],
)
def test_plain_twin_matches_pallas_interpret(dtype, s, lengths):
    q, k, v = _qkv(s + len(lengths), len(lengths), s)
    want, got = _both(q, k, v, _bias(lengths, s), dtype)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_all_padding_row_is_zero(dtype):
    q, k, v = _qkv(5, 2, 130)
    want, got = _both(q, k, v, _bias([97, 0], 130), dtype)
    assert (got[1] == 0).all() and (want[1] == 0).all()
    _assert_close(got, want, dtype)


def test_flash_attention_on_cpu_runs_the_plain_twin():
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 2, 70))
    bias = torch.from_numpy(_bias([70, 20], 70))
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, v, bias), flash_attention_plain(q, k, v, bias))
    assert flash_attention.launches == before  # no kernel launch on the CPU
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), bias.to("meta"))


@pytest.mark.parametrize("what", ["head_dim", "dtype", "mixed_dtype", "strided", "misaligned",
                                  "bias_shape", "too_many_heads"])
def test_kernel_input_checks_refuse_what_the_kernel_cannot_take(what):
    """The checks the wrapper makes before a launch are plain Python over
    shapes, types and addresses: they run here on CPU tensors."""
    from outline_rag_tpu_torch.ops import attention as attn

    b, s, h, d = 2, 16, 4, 64
    q, k, v = (torch.zeros((b, s, h, d), dtype=torch.bfloat16) for _ in range(3))
    bias = torch.zeros((b, s))
    attn._check_kernel_inputs(q, k, v, bias)  # as the kernel wants them
    if what == "head_dim":
        q, k, v = (t[..., :32].contiguous() for t in (q, k, v))
    elif what == "dtype":
        q, k, v = (t.to(torch.float16) for t in (q, k, v))
    elif what == "mixed_dtype":
        k = k.float()
    elif what == "strided":
        v = torch.zeros((b, h, s, d), dtype=torch.bfloat16).transpose(1, 2)
    elif what == "misaligned":
        flat = torch.zeros(b * s * h * d + 1, dtype=torch.bfloat16)
        k = flat[1:].reshape(b, s, h, d)  # contiguous, two bytes off a 16-byte boundary
    elif what == "bias_shape":
        bias = torch.zeros((b, s + 1))
    elif what == "too_many_heads":
        q, k, v = (torch.zeros((1, 1, 65536, d), dtype=torch.bfloat16) for _ in range(3))
        bias = torch.zeros((1, 1))
    with pytest.raises(ValueError):
        attn._check_kernel_inputs(q, k, v, bias)


def test_use_flash_rule():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    auto = EncoderConfig.bge_m3()
    assert use_flash(auto, 8, 2048, cuda) and use_flash(auto, 1, 8192, cuda)
    assert not use_flash(auto, 8, 1024, cuda) and not use_flash(auto, 32, 64, cuda)
    assert use_flash(auto, 300, 1024, cuda)  # f32 logits past 4 GiB
    assert not use_flash(auto, 8, 8192, cpu)  # einsum off the card, as JAX off the TPU
    assert use_flash(EncoderConfig.bge_m3(dtype=torch.float32), 8, 8192, cuda)  # f32 kernel
    assert use_flash(EncoderConfig.tiny(attn_impl="flash"), 2, 32, cpu)
    assert not use_flash(EncoderConfig.bge_m3(attn_impl="einsum"), 8, 8192, cuda)
    with pytest.raises(ValueError, match="attn_impl"):
        EncoderConfig(attn_impl="xla")


def test_config_from_jax_carries_attn_impl():
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        for impl in ("auto", "flash", "einsum"):
            jcfg = je.EncoderConfig(max_positions=8194, dtype=jdt, attn_impl=impl)
            cfg = convert.config_from_jax(jcfg)
            assert cfg == EncoderConfig(dtype=tdt, attn_impl=impl)


@pytest.fixture(scope="module")
def enc_params():
    return je.init_encoder_params(jax.random.key(0), je.EncoderConfig.tiny())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encoder_flash_route_matches_jax(enc_params, dtype):
    jdt = DTYPES[dtype][0]
    jcfg = dataclasses.replace(je.EncoderConfig.tiny(dtype=jdt), attn_impl="flash")
    texts = ["the alpha wolf leads the pack", "gamma", "the river delta spreads " * 6]
    tb = HashTokenizer(vocab_size=1024).batch(texts, 64, buckets=(64,))
    want = je.encoder_forward(je.cast_params(enc_params, jdt), tb.input_ids,
                              tb.attention_mask, jcfg)
    enc = convert.encoder_from_jax(
        jax.tree_util.tree_map(np.asarray, enc_params), convert.config_from_jax(jcfg),
        device="cpu",
    )
    assert enc.cfg.attn_impl == "flash"
    with torch.no_grad():
        got = enc(torch.from_numpy(tb.input_ids), torch.from_numpy(tb.attention_mask))
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=0,
        atol=5e-5 if dtype == "f32" else 2e-2,
    )


def test_whole_document_embedder_matches_jax():
    """max_tokens 2048 past the default ladder: the ladder grows to 2048,
    a 1,500-word document lands in the 2048 bucket beside a short one, and
    both embed through flash attention as one vector each."""
    jcfg = dataclasses.replace(
        je.EncoderConfig.tiny(), max_positions=2050, attn_impl="flash"
    )
    params = je.init_encoder_params(jax.random.key(2), jcfg)
    tok = HashTokenizer(vocab_size=1024)
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(300)]
    docs = [" ".join(rng.choice(words, 1500)), " ".join(rng.choice(words, 40))]
    j_emb = JaxEmbedder(params, jcfg, tok, max_tokens=2048, batch_buckets=(2,))
    p_emb = EncoderEmbedder(
        convert.encoder_from_jax(
            jax.tree_util.tree_map(np.asarray, params), convert.config_from_jax(jcfg),
            device="cpu",
        ),
        tok, max_tokens=2048,
    )
    assert p_emb.seq_buckets == j_emb.seq_buckets == tuple(b for b in LONG_BUCKETS if b <= 2048)
    assert tok.batch(docs, 2048, p_emb.seq_buckets).input_ids.shape == (2, 2048)
    want = j_emb.embed(docs)
    got = p_emb.embed(docs)
    assert got.shape == (2, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_flash_errors_bound_in_bf16_ulps():
    plain = torch.tensor([1.0, 0.15, -0.3, 0.0])
    one_ulp = torch.tensor([2.0**-7, 2.0**-10, 2.0**-9, 0.0])
    err = flash_errors(plain + one_ulp, plain, atol=1e-12, ulps=1.0)
    assert err["worst_vs_bound"] == pytest.approx(1.0) and err["max_abs_err"] == 2.0**-7
    err = flash_errors(plain + 2 * one_ulp, plain, atol=1e-12, ulps=1.0)
    assert err["worst_vs_bound"] == pytest.approx(2.0)
    assert flash_errors(plain, plain, atol=1e-3, ulps=2.0) == {
        "max_abs_err": 0.0, "worst_vs_bound": 0.0, "rel_rms_err": 0.0
    }
