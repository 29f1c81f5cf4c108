"""The port's decoder (``outline_rag_tpu_torch.models.decoder``) against the
JAX package's on ``DecoderConfig.tiny()`` in f32 on the CPU: the same seeded
weights (through ``decoder_from_jax``) and the same numpy tokens give
logits within 1e-4 (f32 sums in another order; logits are of order 0.1) on
the ring and the paged cache, and the same greedy tokens. int8 weights are
held to 1e-5 per projection on the same input, and through the whole
forward to a bound that allows for a flipped activation rounding. int4
weights quantized by the JAX package keep the activations exact on the CPU
(both packages take the grouped product there), so their logits are held
to 1e-4 as well. The sampler draws other numbers than ``jax.random``, so it is held
to its own contract: the nucleus distribution and the position rule."""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outline_rag_tpu.models import decoder as jdec
from outline_rag_tpu_torch.models import decoder as tdec
from outline_rag_tpu_torch.models.convert import (
    decoder_config_from_jax,
    decoder_from_jax,
    decoder_params_from_state_dict,
    paged_kv_from_jax,
)

TOL = 1e-4
TABLE = np.array([[3, 5, 1, 7], [2, 4, 6, 8]], np.int32)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_model(**cfg_kw):
    jcfg = dataclasses.replace(jdec.DecoderConfig.tiny(), **cfg_kw)
    jparams = jdec.init_decoder_params(jax.random.key(0), jcfg)
    if jcfg.attn_bias:  # zeros at init: give the biases something to do
        rng = np.random.default_rng(5)
        for layer in jparams["layers"]:
            for name in ("bq", "bk", "bv"):
                layer[name] = jnp.asarray(rng.standard_normal(layer[name].shape) * 0.1, jnp.float32)
    return jcfg, jdec.stack_decoder_params(jparams)


def tokens(b=2, t=7, seed=0):
    return np.random.default_rng(seed).integers(1, 256, (b, t)).astype(np.int32)


def jax_cache(jcfg, kind, b=2):
    if kind == "ring":
        return jdec.init_cache(jcfg, b)
    cache = jdec.init_paged_cache(jcfg, b, 9, 16, kv_dtype="int8" if kind == "paged_int8" else None)
    return dataclasses.replace(cache, table=jnp.asarray(TABLE[:b]))


def port_cache(cfg, jcache):
    if isinstance(jcache, tuple):
        return tdec.init_cache(cfg, jcache[0].shape[1], "cpu")
    return paged_kv_from_jax(to_np(jcache), device="cpu")


def run_both(jcfg, jparams, kind, steps=3):
    """Prefill 7 tokens, then `steps` single-token steps, in both packages:
    [(jax logits, port logits)] per call."""
    cfg = decoder_config_from_jax(jcfg)
    params = decoder_from_jax(to_np(jparams), cfg, device="cpu")
    jcache = jax_cache(jcfg, kind)
    tcache = port_cache(cfg, jcache)
    toks = tokens()
    out = []
    pos = 0
    with torch.inference_mode():
        for step in range(steps + 1):
            jl, jcache = jdec.decoder_forward(
                jparams, jnp.asarray(toks), jcache, jnp.full((2,), pos, jnp.int32), jcfg)
            tl, tcache = tdec.decoder_forward(
                params, torch.from_numpy(toks.copy()), tcache, torch.full((2,), pos, dtype=torch.int32), cfg)
            assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
            out.append((np.asarray(jl), tl.numpy()))
            pos += toks.shape[1]
            toks = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    return out


@pytest.mark.parametrize("kind", ["ring", "paged", "paged_int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_logits_match_jax_prefill_then_steps(kind, fused):
    jcfg, jparams = jax_model()
    if fused:
        jparams = jdec.fuse_decoder_params(jparams)
    for jl, tl in run_both(jcfg, jparams, kind):
        np.testing.assert_allclose(tl, jl, atol=TOL, rtol=0)


@pytest.mark.parametrize("cfg_kw", [{"attn_bias": True}, {"tie_embeddings": True},
                                    {"attn_bias": True, "tie_embeddings": True}],
                         ids=["attn_bias", "tied", "both"])
@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_logits_match_jax_bias_and_tied_embeddings(kind, cfg_kw):
    jcfg, jparams = jax_model(**cfg_kw)
    jparams = jdec.fuse_decoder_params(jparams)  # covers bqkv
    for jl, tl in run_both(jcfg, jparams, kind, steps=2):
        np.testing.assert_allclose(tl, jl, atol=TOL, rtol=0)


@pytest.mark.parametrize("mode", ["w8a8", "kernel"])
def test_int8_mm_matches_jax_on_the_same_input(monkeypatch, mode):
    """Every int8 projection of the tiny model, fed the same activations in
    both packages (the JAX side runs its Pallas kernel in interpret mode on
    the CPU): w8a8 is exact integers with an f32 rescale, the kernel mode an
    f32 sum of bf16 products in another order; both within 1e-5 on outputs
    of order 1."""
    monkeypatch.setattr(jdec, "_INT8_MODE", mode)
    monkeypatch.setattr(tdec, "_INT8_MODE", mode)
    jcfg, jparams = jax_model()
    jq = jdec.quantize_decoder_params(jdec.fuse_decoder_params(jparams))
    tq = decoder_from_jax(to_np(jq), decoder_config_from_jax(jcfg), device="cpu")
    rng = np.random.default_rng(4)
    leaves = [(jq["lm_head"], tq["lm_head"])] + [
        ({k: v[1] for k, v in jq["layers"][name].items()}, tq["layers"][1][name])
        for name in ("wqkv", "wo", "wgu", "wd")]
    for m in (1, 7, 16):  # 1 and 7 are padded to a multiple of 8 in kernel mode
        for jw, tw in leaves:
            x = rng.standard_normal((1, m, jw["q"].shape[1])).astype(np.float32)
            want = np.asarray(jdec._mm(jnp.asarray(x), jw, jnp.float32))
            got = tdec._mm(torch.from_numpy(x), tw, torch.float32)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["ring", "paged"])
@pytest.mark.parametrize("mode", ["w8a8", "kernel"])
def test_logits_track_jax_int8_weights(monkeypatch, mode, kind):
    """The whole forward with int8 ``{"q", "s"}`` leaves quantized by the
    JAX package. Both strategies round the activations (to int8 per row, or
    to bf16), and a last-bit difference upstream can flip such a rounding,
    which moves a logit by about the quantization step; so 1e-4 holds per
    projection (the test above) but not through two layers. The two
    packages must stay closer to each other than the int8 model is to the
    float one, with a per-position cosine above 0.9995."""
    monkeypatch.setattr(jdec, "_INT8_MODE", mode)
    monkeypatch.setattr(tdec, "_INT8_MODE", mode)
    jcfg, jparams = jax_model()
    fused = jdec.fuse_decoder_params(jparams)
    floats = run_both(jcfg, fused, kind, steps=2)
    quants = run_both(jcfg, jdec.quantize_decoder_params(fused), kind, steps=2)
    for (_, fl), (jl, tl) in zip(floats[:1], quants[:1]):  # later steps feed other tokens
        assert np.abs(tl - jl).max() < np.abs(tl - fl).max()
    for jl, tl in quants:
        cos = (jl * tl).sum(-1) / (np.linalg.norm(jl, axis=-1) * np.linalg.norm(tl, axis=-1))
        assert cos.min() > 0.9995, cos.min()
        assert np.abs(tl - jl).max() < 1e-2  # logits are of order 0.5


def test_quantize_decoder_params_matches_jax_codes():
    jcfg, jparams = jax_model()
    cfg = decoder_config_from_jax(jcfg)
    fused = jdec.fuse_decoder_params(jparams)
    want = to_np(jdec.quantize_decoder_params(fused))
    got = tdec.quantize_decoder_params(decoder_from_jax(to_np(fused), cfg, device="cpu"))
    assert set(got["layers"][0]) == set(want["layers"])
    for name in ("wqkv", "wo", "wgu", "wd"):
        for li in range(cfg.layers):
            np.testing.assert_array_equal(got["layers"][li][name]["q"].numpy(), want["layers"][name]["q"][li])
            np.testing.assert_allclose(got["layers"][li][name]["s"].numpy(), want["layers"][name]["s"][li], rtol=1e-6)
    np.testing.assert_array_equal(got["lm_head"]["q"].numpy(), want["lm_head"]["q"])
    assert got["embed"].dtype == torch.float32 and not isinstance(got["layers"][0]["ln1"], dict)


def test_large_m_kernel_mode_dequantizes_then_multiplies(monkeypatch):
    """M > 256 in ``kernel`` mode takes the dequantize-then-matmul route in
    both packages."""
    monkeypatch.setattr(jdec, "_INT8_MODE", "kernel")
    monkeypatch.setattr(tdec, "_INT8_MODE", "kernel")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 160, 64)).astype(np.float32)  # M = 320
    jq, js = jdec.quantize_decoder_params({"layers": {}, "lm_head": jnp.asarray(
        rng.standard_normal((64, 48)).astype(np.float32))})["lm_head"].values()
    want = np.asarray(jdec._mm(jnp.asarray(x), {"q": jq, "s": js}, jnp.float32))
    w = {"q": torch.from_numpy(np.array(jq)), "s": torch.from_numpy(np.array(js))}
    np.testing.assert_allclose(tdec._mm(torch.from_numpy(x), w, torch.float32).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("n", [44, 250])
def test_kernel_mode_refuses_a_width_the_kernel_cannot_take(monkeypatch, n):
    """At M <= 256 ``kernel`` mode goes to ``int8_linear`` whatever the
    widths are: an N that is no multiple of 8 raises, it never takes the
    dequantize-then-matmul route behind the caller's back."""
    monkeypatch.setattr(tdec, "_INT8_MODE", "kernel")
    g = torch.Generator().manual_seed(n)
    w = {"q": torch.randint(-127, 128, (n, 64), generator=g, dtype=torch.int8),
         "s": torch.rand(n, generator=g) / 127}
    x = torch.randn((2, 3, 64), generator=g)
    with pytest.raises(ValueError, match="N % 8"):
        tdec._mm(x, w, torch.float32)


def test_paged_pool_is_updated_in_place_and_matches_jax_pool():
    jcfg, jparams = jax_model()
    cfg = decoder_config_from_jax(jcfg)
    params = decoder_from_jax(to_np(jparams), cfg, device="cpu")
    jcache = jax_cache(jcfg, "paged_int8")
    tcache = port_cache(cfg, jcache)
    k_before = tcache.k
    toks = tokens(t=20)  # straddles a 16-token page
    zero = jnp.zeros((2,), jnp.int32)
    _, jcache = jdec.decoder_forward(jparams, jnp.asarray(toks), jcache, zero, jcfg)
    with torch.inference_mode():
        _, out = tdec.decoder_forward(params, torch.from_numpy(toks), tcache,
                                      torch.zeros(2, dtype=torch.int32), cfg)
    assert out is tcache and out.k is k_before and out.page == 16
    want = paged_kv_from_jax(to_np(jcache), device="cpu")
    live = np.unique(TABLE[:, :2])  # the pages the 20 tokens touched
    # int8 codes may differ by one where x/s lands on a rounding boundary
    assert (out.k[:, live].int() - want.k[:, live].int()).abs().max() <= 1
    assert (out.k[:, live] != want.k[:, live]).float().mean() < 1e-3
    np.testing.assert_allclose(out.k_scale[:, live].numpy(), want.k_scale[:, live].numpy(), rtol=1e-4)


def test_init_paged_cache_checks():
    cfg = tdec.DecoderConfig.tiny()
    with pytest.raises(ValueError, match="not divisible"):
        tdec.init_paged_cache(cfg, 2, 8, page_size=24, device="cpu")
    with pytest.raises(ValueError, match="unsupported kv_dtype"):
        tdec.init_paged_cache(cfg, 2, 8, page_size=16, kv_dtype="fp8", device="cpu")
    c = tdec.init_paged_cache(cfg, 2, 8, page_size=16, kv_dtype="int8", device="cpu")
    assert tuple(c.k.shape) == (2, 8, 2, 16, 16) and c.k.dtype == torch.int8
    assert tuple(c.k_scale.shape) == (2, 8, 2, 16) and tuple(c.table.shape) == (2, 4)
    assert tdec.init_paged_cache(cfg, 2, 8, 16, device="cpu").k.dtype == torch.float32


@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_greedy_generate_chunk_tokens_equal_jax(kind):
    jcfg, jparams = jax_model()
    cfg = decoder_config_from_jax(jcfg)
    params = decoder_from_jax(to_np(jparams), cfg, device="cpu")
    jcache = jax_cache(jcfg, kind)
    tcache = port_cache(cfg, jcache)
    toks = tokens()
    jl, jcache = jdec.decoder_forward(jparams, jnp.asarray(toks), jcache, jnp.zeros((2,), jnp.int32), jcfg)
    first = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
    want, _, jtok, jpos = jdec.generate_chunk(
        jparams, jcache, jnp.asarray(first), jnp.full((2,), 7, jnp.int32), jax.random.key(1), jcfg,
        n_steps=32, temperature=0.0, top_p=1.0, eos_id=-1)
    with torch.inference_mode():
        _, tcache = tdec.decoder_forward(params, torch.from_numpy(toks), tcache,
                                         torch.zeros(2, dtype=torch.int32), cfg)
        got, _, ttok, tpos = tdec.generate_chunk(
            params, tcache, torch.from_numpy(first.copy()), torch.full((2,), 7, dtype=torch.int32),
            tdec.make_key(1, "cpu"), cfg, n_steps=32, temperature=0.0, top_p=1.0, eos_id=-1)
    assert got.tolist() == np.asarray(want).tolist()
    assert ttok.tolist() == np.asarray(jtok).tolist() and tpos.tolist() == np.asarray(jpos).tolist()


def test_generate_chunk_freezes_on_eos():
    jcfg, jparams = jax_model()
    cfg = decoder_config_from_jax(jcfg)
    params = decoder_from_jax(to_np(jparams), cfg, device="cpu")
    with torch.inference_mode():
        cache = tdec.init_cache(cfg, 2, "cpu")
        free, *_ = tdec.generate_chunk(
            params, cache, torch.tensor([5, 9]), torch.zeros(2, dtype=torch.int32),
            tdec.make_key(0, "cpu"), cfg, n_steps=8, temperature=0.0, top_p=1.0, eos_id=-1)
        eos = int(free[0, 2])  # make row 0's third token the eos
        cache = tdec.init_cache(cfg, 2, "cpu")
        got, _, tok, _ = tdec.generate_chunk(
            params, cache, torch.tensor([5, 9]), torch.zeros(2, dtype=torch.int32),
            tdec.make_key(0, "cpu"), cfg, n_steps=8, temperature=0.0, top_p=1.0, eos_id=eos)
    assert got[0, :3].tolist() == free[0, :3].tolist()
    assert (got[0, 2:] == eos).all() and int(tok[0]) == eos
    row1 = free[1].tolist()
    stop = row1.index(eos) if eos in row1 else 8
    assert got[1, :stop].tolist() == row1[:stop]


def test_prefill_matches_incremental_and_chunked():
    """Per-position math does not depend on how the tokens were cut into
    calls (what the prefix cache's warm == cold rests on)."""
    cfg = tdec.DecoderConfig.tiny()
    params = tdec.init_decoder(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(tokens(b=1, t=12))
    with torch.inference_mode():
        whole, _ = tdec.decoder_forward(params, toks, tdec.init_paged_cache(cfg, 1, 5, 16, device="cpu"),
                                        torch.zeros(1, dtype=torch.int32), cfg)
        for cut in (1, 4):
            cache = tdec.init_paged_cache(cfg, 1, 5, 16, device="cpu")
            cache.table[0] = torch.tensor([2, 4, 1, 3])
            parts = []
            for start in range(0, 12, cut):
                lg, cache = tdec.decoder_forward(params, toks[:, start:start + cut], cache,
                                                 torch.tensor([start], dtype=torch.int32), cfg)
                parts.append(lg)
            np.testing.assert_allclose(torch.cat(parts, 1).numpy(), whole.numpy(), atol=2e-6)


def test_init_decoder_is_seeded_and_casts_like_jax():
    cfg = tdec.DecoderConfig.tiny(dtype=torch.bfloat16)
    a = tdec.init_decoder(cfg, torch.Generator().manual_seed(3), "cpu")
    b = tdec.init_decoder(cfg, torch.Generator().manual_seed(3), "cpu")
    c = tdec.init_decoder(cfg, torch.Generator().manual_seed(4), "cpu")
    assert torch.equal(a["layers"][1]["wd"], b["layers"][1]["wd"])
    assert not torch.equal(a["layers"][1]["wd"], c["layers"][1]["wd"])
    assert a["embed"].dtype == torch.bfloat16 and a["layers"][0]["ln1"].dtype == torch.float32
    assert tuple(a["lm_head"].shape) == (64, 256) and tuple(a["layers"][0]["wk"].shape) == (64, 32)
    assert abs(float(a["embed"].float().std()) - 0.02) < 2e-3
    big = tdec.DecoderConfig.tinyllama_1b()
    assert (big.hidden, big.layers, big.heads, big.kv_heads, big.hd, big.intermediate,
            big.vocab_size, big.max_cache) == (2048, 22, 32, 4, 64, 5632, 32000, 2048)


# ----------------------------------------------------------------------
# int4 weights
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ring", "paged", "paged_int8"])
def test_logits_match_jax_int4_weights(kind):
    """``{"q4", "s4"}`` leaves quantized by the JAX package, carried across by
    ``decoder_from_jax``. On the CPU both packages take the grouped product
    (exact activations, f32 sums in another order): 1e-4 as for dense
    weights, prefill (M = 14) and steps (M = 2)."""
    jcfg, jparams = jax_model()
    jq = jdec.quantize_decoder_params_int4(jdec.fuse_decoder_params(jparams))
    for jl, tl in run_both(jcfg, jq, kind):
        np.testing.assert_allclose(tl, jl, atol=TOL, rtol=0)


def test_logits_track_jax_int4_weights_bf16():
    """A bf16 model rounds every activation, and a last-bit difference
    upstream flips such a rounding, so 1e-4 cannot hold; the two packages
    stay closer to each other than the int4 model is to the float one, with
    a per-position cosine above 0.999."""
    jcfg, jparams = jax_model(dtype=jnp.bfloat16)
    fused = jdec.fuse_decoder_params(jdec.cast_decoder_params(jparams, jnp.bfloat16))
    floats = run_both(jcfg, fused, "ring", steps=0)
    quants = run_both(jcfg, jdec.quantize_decoder_params_int4(fused), "ring", steps=2)
    (_, fl), (jl0, tl0) = floats[0], quants[0]
    assert np.abs(tl0 - jl0).max() < np.abs(tl0 - fl).max()
    for jl, tl in quants:
        cos = (jl * tl).sum(-1) / (np.linalg.norm(jl, axis=-1) * np.linalg.norm(tl, axis=-1))
        assert cos.min() > 0.999, cos.min()


def test_quantize_decoder_params_int4_matches_jax_codes():
    jcfg, jparams = jax_model()
    cfg = decoder_config_from_jax(jcfg)
    fused = jdec.fuse_decoder_params(jparams)
    want = to_np(jdec.quantize_decoder_params_int4(fused))
    got = tdec.quantize_decoder_params_int4(decoder_from_jax(to_np(fused), cfg, device="cpu"))
    assert set(got["layers"][0]) == set(want["layers"])
    for name in ("wqkv", "wo", "wgu", "wd"):
        for li in range(cfg.layers):
            for leaf in ("q4", "s4"):
                np.testing.assert_array_equal(got["layers"][li][name][leaf].numpy(),
                                              want["layers"][name][leaf][li])
    np.testing.assert_array_equal(got["lm_head"]["q4"].numpy(), want["lm_head"]["q4"])
    assert got["embed"].dtype == torch.float32 and not isinstance(got["layers"][0]["ln1"], dict)
    again = tdec.cast_decoder_params(got, torch.bfloat16)  # quantized leaves are never cast
    assert again["layers"][0]["wo"]["s4"].dtype == torch.float32


def test_int4_decode_and_prefill_paths_agree():
    """Small M goes through the grouped product and M > 256 through one full
    dequantization: the same function on two schedules, to f32 summation
    order (the JAX package's test of the same name, at its sizes)."""
    cfg = tdec.DecoderConfig(vocab_size=512, hidden=256, layers=2, heads=4, kv_heads=2,
                             intermediate=512, max_cache=64, dtype=torch.float32)
    params = tdec.quantize_decoder_params_int4(tdec.fuse_decoder_params(
        tdec.init_decoder(cfg, torch.Generator().manual_seed(3), "cpu")))
    assert tuple(params["layers"][0]["wgu"]["q4"].shape) == (1024, 128)
    assert tuple(params["layers"][0]["wgu"]["s4"].shape) == (1024, 2)
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, 512, (1, 12)))
    with torch.inference_mode():
        big, _ = tdec.decoder_forward(params, toks.repeat(32, 1), tdec.init_cache(cfg, 32, "cpu"),
                                      torch.zeros(32, dtype=torch.int32), cfg)  # M = 384
        small, _ = tdec.decoder_forward(params, toks, tdec.init_cache(cfg, 1, "cpu"),
                                        torch.zeros(1, dtype=torch.int32), cfg)
    np.testing.assert_allclose(big[0].numpy(), small[0].numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_init_quantized_decoder_params_layout_equals_fuse_then_quantize(mode):
    cfg = dataclasses.replace(tdec.DecoderConfig.tiny(dtype=torch.bfloat16), attn_bias=True)
    got = tdec.init_quantized_decoder_params(cfg, torch.Generator().manual_seed(0), "cpu", mode=mode)
    fused = tdec.fuse_decoder_params(tdec.init_decoder(cfg, torch.Generator().manual_seed(0), "cpu"))
    want = (tdec.quantize_decoder_params_int4 if mode == "int4" else tdec.quantize_decoder_params)(fused)

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [layout(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert layout(got) == layout(want)
    again = tdec.init_quantized_decoder_params(cfg, torch.Generator().manual_seed(0), "cpu", mode=mode)
    leaf = "q4" if mode == "int4" else "q"
    assert torch.equal(got["layers"][1]["wd"][leaf], again["layers"][1]["wd"][leaf])
    with torch.inference_mode():  # and the tree runs
        logits, _ = tdec.decoder_forward(got, torch.tensor([[3, 4, 5]]), tdec.init_cache(cfg, 1, "cpu"),
                                         torch.zeros(1, dtype=torch.int32), cfg)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="int4\\|int8"):
        tdec.init_quantized_decoder_params(cfg, torch.Generator().manual_seed(0), "cpu", mode="fp8")


@pytest.mark.parametrize("mode", ["w4a8", "kernel", "xla"])
def test_int4_mode_never_reaches_a_kernel_on_the_cpu(monkeypatch, mode):
    """Where the JAX package asks for its TPU backend the port asks for the
    tensor's device: a CPU tensor takes the grouped product in every mode,
    at an eligible shape too."""
    import outline_rag_tpu_torch.ops.int4_linear as int4_module

    monkeypatch.setattr(tdec, "_INT4_MODE", mode)
    q4, s4 = int4_module.quantize_int4_weight(torch.randn((256, 128), generator=torch.Generator().manual_seed(1)))
    x = torch.randn((2, 3, 256), generator=torch.Generator().manual_seed(2))
    got = tdec._mm(x, {"q4": q4, "s4": s4}, torch.float32)
    want = int4_module.w4a16_matmul_plain(x.reshape(6, 256), q4, s4).reshape(2, 3, 128)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * float(want.abs().max()))
    assert int4_module.w4a8_matmul.launches == 0 and int4_module.w4a16_matmul.launches == 0


# ----------------------------------------------------------------------
# the sampler
# ----------------------------------------------------------------------


def nucleus_probs(logits, temperature, top_p, cap=64):
    scaled = logits / max(temperature, 1e-4)
    order = np.argsort(-scaled, kind="stable")[:cap]
    p = np.exp(scaled[order] - scaled[order].max())
    p /= p.sum()
    keep = np.concatenate([[True], np.cumsum(p)[:-1] < top_p])
    p = np.where(keep, p, 0.0)
    out = np.zeros_like(logits)
    out[order] = p / p.sum()
    return out


@pytest.mark.parametrize("temperature,top_p", [(1.0, 1.0), (0.7, 0.9), (1.5, 0.5)])
def test_sampler_follows_the_nucleus_distribution(temperature, top_p):
    """Chi-square of 20,000 seeded draws over a 12-token vocabulary against
    the nucleus probabilities; tokens outside the nucleus never appear."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal(12).astype(np.float32)
    n = 20_000
    keys = tdec.key_at(tdec.make_key(7, "cpu"), torch.arange(n))
    draws = tdec.sample_token(torch.from_numpy(logits).expand(n, 12), keys, temperature, top_p)
    counts = np.bincount(draws.numpy(), minlength=12)
    want = nucleus_probs(logits, temperature, top_p)
    assert counts[want == 0].sum() == 0
    live = want > 0
    chi2 = (((counts[live] - n * want[live]) ** 2) / (n * want[live])).sum()
    assert chi2 < 40.0, (chi2, counts, want)  # 11 degrees of freedom: p < 1e-4


def test_sampler_position_contract():
    """The token for position q depends only on (seed, q, logits): not on
    the batch a row shares, its slot, or how keys were batched."""
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((6, 256)).astype(np.float32))
    seeds = torch.tensor([11, 12, 13, 11, 12, 13])
    pos = torch.tensor([5, 6, 7, 8, 6, 7])
    keys = tdec.key_at(tdec.make_key(seeds, "cpu"), pos)
    batch = tdec.sample_token(logits, keys, 1.2, 0.95)
    for i in range(6):
        solo = tdec._sample_one(logits[i], tdec.key_at(tdec.make_key(int(seeds[i]), "cpu"), int(pos[i])),
                                1.2, 0.95)
        assert int(solo) == int(batch[i])
    perm = torch.tensor([3, 0, 5, 1, 4, 2])
    assert torch.equal(tdec.sample_token(logits[perm], keys[perm], 1.2, 0.95), batch[perm])
    # same seed and logits at another position draw with another key
    assert len({int(tdec.key_at(tdec.make_key(11, "cpu"), q)) for q in range(100)}) == 100


def test_sampler_greedy_and_mixed_rows():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [2.0, 0.0, 0.0, 2.0]])
    key = tdec.make_key(0, "cpu")
    assert tdec.sample_token(logits, key, 0.0, 1.0).tolist() == [1, 0]  # ties: lowest index
    temp = torch.tensor([0.0, 1e-6])
    # row 1 samples at a vanishing temperature within top_p -> its best token, lowest index first
    assert tdec.sample_token(logits, key, temp, torch.tensor([1.0, 0.1])).tolist() == [1, 0]
    assert tdec.sample_token(logits, key, 1.0, 1.0).dtype == torch.int32


def test_sampler_one_key_gives_rows_their_own_noise():
    logits = torch.zeros((64, 50))
    draws = tdec.sample_token(logits, tdec.make_key(3, "cpu"), 1.0, 1.0)
    assert len(set(draws.tolist())) > 10
    assert torch.equal(draws, tdec.sample_token(logits, tdec.make_key(3, "cpu"), 1.0, 1.0))


# ----------------------------------------------------------------------
# converters
# ----------------------------------------------------------------------


def test_decoder_from_jax_takes_list_or_stacked_and_rejects_int4():
    jcfg = jdec.DecoderConfig.tiny()
    jlist = jdec.init_decoder_params(jax.random.key(0), jcfg)
    cfg = decoder_config_from_jax(jcfg)
    a = decoder_from_jax(to_np(jlist), cfg, device="cpu")
    b = decoder_from_jax(to_np(jdec.stack_decoder_params(jlist)), cfg, device="cpu")
    assert len(a["layers"]) == len(b["layers"]) == 2
    for la, lb in zip(a["layers"], b["layers"]):
        assert la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la)
    bf = decoder_from_jax(to_np(jlist), dataclasses.replace(cfg, dtype=torch.bfloat16), device="cpu")
    want = np.asarray(jdec.cast_decoder_params(jlist, jnp.bfloat16)["layers"][0]["wq"].astype(jnp.float32))
    np.testing.assert_array_equal(bf["layers"][0]["wq"].float().numpy(), want)
    assert bf["layers"][0]["ln1"].dtype == torch.float32
    with pytest.raises(ValueError, match="layers"):
        decoder_from_jax(to_np(jlist), dataclasses.replace(cfg, layers=3), device="cpu")
    # an int4 tree is taken as it is (the name dates from when it was refused)
    q4 = to_np(jdec.quantize_decoder_params_int4(jdec.stack_decoder_params(jlist)))
    got = decoder_from_jax(q4, cfg, device="cpu")
    leaf = got["layers"][1]["wd"]
    assert leaf["q4"].dtype == torch.uint8 and leaf["s4"].dtype == torch.float32
    np.testing.assert_array_equal(leaf["q4"].numpy(), q4["layers"]["wd"]["q4"][1])
    np.testing.assert_array_equal(got["lm_head"]["s4"].numpy(), q4["lm_head"]["s4"])


def test_decoder_params_from_state_dict_synthesized():
    """A synthesized HF-style state dict ([out, in] linears) through the
    port's converter and the JAX package's give the same logits."""
    from outline_rag_tpu.models.convert import decoder_params_from_state_dict as jax_from_sd

    jcfg = dataclasses.replace(jdec.DecoderConfig.tiny(), attn_bias=True)
    cfg = decoder_config_from_jax(jcfg)
    rng = np.random.default_rng(0)
    hd, h = cfg.hd, cfg.hidden
    sd = {"model.embed_tokens.weight": rng.standard_normal((cfg.vocab_size, h)) * 0.02,
          "model.norm.weight": 1 + 0.1 * rng.standard_normal(h),
          "lm_head.weight": rng.standard_normal((cfg.vocab_size, h)) * 0.02}
    shapes = {"self_attn.q_proj": (cfg.heads * hd, h), "self_attn.k_proj": (cfg.kv_heads * hd, h),
              "self_attn.v_proj": (cfg.kv_heads * hd, h), "self_attn.o_proj": (h, cfg.heads * hd),
              "mlp.gate_proj": (cfg.intermediate, h), "mlp.up_proj": (cfg.intermediate, h),
              "mlp.down_proj": (h, cfg.intermediate)}
    for i in range(cfg.layers):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = 1 + 0.1 * rng.standard_normal(h)
        sd[pre + "post_attention_layernorm.weight"] = 1 + 0.1 * rng.standard_normal(h)
        for name, shape in shapes.items():
            sd[f"{pre}{name}.weight"] = rng.standard_normal(shape) * 0.05
            if name[-6:] in ("q_proj", "k_proj", "v_proj"):
                sd[f"{pre}{name}.bias"] = rng.standard_normal(shape[0]) * 0.1
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    jparams = jdec.stack_decoder_params(jax.tree_util.tree_map(jnp.asarray, jax_from_sd(sd, jcfg)))
    params = decoder_params_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, cfg,
                                            device="cpu")
    assert tuple(params["layers"][0]["wq"].shape) == (h, cfg.heads * hd)
    toks = tokens()
    jl, _ = jdec.decoder_forward(jparams, jnp.asarray(toks), jdec.init_cache(jcfg, 2),
                                 jnp.zeros((2,), jnp.int32), jcfg)
    with torch.inference_mode():
        tl, _ = tdec.decoder_forward(params, torch.from_numpy(toks), tdec.init_cache(cfg, 2, "cpu"),
                                     torch.zeros(2, dtype=torch.int32), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)


def test_paged_kv_from_jax_relays_the_pool():
    jcfg = jdec.DecoderConfig.tiny()
    cache = jdec.init_paged_cache(jcfg, 2, 5, 16, kv_dtype="int8")
    rng = np.random.default_rng(0)
    k = rng.integers(-127, 128, cache.k.shape).astype(np.int8)
    cache = dataclasses.replace(cache, k=jnp.asarray(k), table=jnp.asarray(TABLE))
    got = paged_kv_from_jax(to_np(cache), device="cpu")
    assert tuple(got.k.shape) == (2, 5, 2, 16, 16) and got.k.dtype == torch.int8
    assert got.k.is_contiguous() and got.table.dtype == torch.int32
    np.testing.assert_array_equal(got.k.numpy(), k.transpose(0, 1, 2, 4, 3))
    np.testing.assert_array_equal(got.table.numpy(), TABLE)
    assert tuple(got.k_scale.shape) == (2, 5, 2, 16)


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the JAX
    package."""
    root = pathlib.Path(__file__).resolve().parents[1]
    files = list((root / "outline_rag_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 20
    pattern = re.compile(r"^\s*(import|from)\s+(jax|outline_rag_tpu)(\.|\s|$)", re.M)
    bad = [str(f.relative_to(root)) for f in files if pattern.search(f.read_text())]
    assert not bad, bad


def test_ops_submodules_are_not_shadowed_by_their_functions():
    import inspect

    import outline_rag_tpu_torch.ops as ops
    import outline_rag_tpu_torch.ops.int8_linear as lin
    import outline_rag_tpu_torch.ops.paged_attention as paged

    assert inspect.ismodule(lin) and inspect.ismodule(paged)
    assert callable(paged.paged_attention) and callable(lin.int8_linear)
    for name in ("paged_attention_plain", "paged_kv_write", "paged_kv_write_plain",
                 "int8_linear_plain", "quantize_linear_weight", "w8a8_matmul"):
        assert callable(getattr(ops, name)) and name in ops.__all__
