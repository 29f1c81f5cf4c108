"""DeepSeek-V2 in the port (latent attention over the paged latent pool,
routed and shared experts, YaRN rope) against the plain float32 reference
``portbench/reference/deepseek_v2.py``, on the CPU at a tiny size in
float32: the batcher's paged prefill and decode, the router, the YaRN tables
and scale at the published numbers, the expert product, planted faults, and
the options the model refuses."""

import dataclasses
import json
import time
import types
from pathlib import Path

import pytest
import torch

from outline_rag_tpu_torch.models import decoder as decoder_mod
from outline_rag_tpu_torch.models import mla, moe
from outline_rag_tpu_torch.models.convert import decoder_config_from_hf
from outline_rag_tpu_torch.models.decoder import (
    cast_decoder_params,
    fuse_decoder_params,
    init_paged_cache,
)
from outline_rag_tpu_torch.serve import decode_batcher
from outline_rag_tpu_torch.serve.decode_batcher import DONE, DecodeBatcher
from outline_rag_tpu_torch.serve.llm import LocalChatProvider
from outline_rag_tpu_torch.utils.profiling import metrics
from portbench import weights
from portbench.arch import deepseek_v2 as arch
from portbench.reference import deepseek_v2 as ref

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 5
PAGE = 16
# a tiny DeepSeek-V2: layer 0 dense, two expert layers of 8 experts top-2 and
# one shared expert, YaRN at factor 4 over an original 16 positions
TINY = {
    "model_type": "deepseek_v2", "hidden_size": 64, "num_attention_heads": 4,
    "num_key_value_heads": 4, "kv_lora_rank": 32, "qk_rope_head_dim": 16,
    "qk_nope_head_dim": 16, "v_head_dim": 16, "q_lora_rank": None, "n_routed_experts": 8,
    "num_experts_per_tok": 2, "n_shared_experts": 1, "moe_intermediate_size": 32,
    "first_k_dense_replace": 1, "moe_layer_freq": 1, "num_hidden_layers": 3,
    "intermediate_size": 128, "vocab_size": 256, "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "norm_topk_prob": False, "routed_scaling_factor": 1.0, "scoring_func": "softmax",
    "topk_method": "greedy", "tie_word_embeddings": False, "attention_bias": False,
    "hidden_act": "silu", "max_position_embeddings": 256,
    "rope_scaling": {"type": "yarn", "factor": 4, "original_max_position_embeddings": 16,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707},
}
# float32 on both sides: the port's absorbed products and paged gathers and
# the reference's un-absorbed ones round differently, by 1.8e-7 on logits of
# magnitude ~0.7; 2e-5 leaves a hundredfold room, and every fault below moves
# the logits by at least 1.2e-3 (the YaRN mscale left out)
TOL = 2e-5
PROMPT = torch.randint(0, 256, (40,), generator=torch.Generator().manual_seed(1)).tolist()
# shares PROMPT's first two full pages (32 tokens), then goes its own way
WARM = PROMPT[:32] + torch.randint(0, 256, (9,), generator=torch.Generator().manual_seed(2)).tolist()


def draw():
    return weights.draw(arch.layout(TINY), CPU, torch.float32, SEED, "decoder")


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(2)
    params, cfg = arch.build(TINY, draw(), CPU, torch.float32)
    return fuse_decoder_params(cast_decoder_params(params, cfg.dtype)), cfg


def _serve(params, cfg, prompts, max_new=10):
    """Each prompt greedily through a two-slot paged ``DecodeBatcher``, one
    after the other; for each, its served tokens and the port's logits at
    every position of prompt + served (from the forwards the batcher ran,
    captured as they ran: position -> (token fed, logits))."""
    calls = []
    real = decode_batcher.decoder_forward

    def capture(params_, tokens, cache, start, cfg_, route=None):
        logits, out = real(params_, tokens, cache, start, cfg_, route=route)
        calls.append((tokens.clone(), start.clone(), cache.table.clone(), logits.clone()))
        return logits, out

    results = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decode_batcher, "decoder_forward", capture)
        b = DecodeBatcher(params, cfg, slots=2, chunk_tokens=4, eos_id=255, kv_pages=40,
                          page_size=PAGE, prefill_chunk=32, device="cpu")
        try:
            for prompt in prompts:
                calls.clear()
                out = b.submit(prompt, 0.0, 1.0, max_new, seed=1)
                served = []
                while (item := out.get(timeout=120)) is not DONE:
                    assert not isinstance(item, Exception), item
                    served += item
                seen = {}
                for tokens, start, table, logits in calls:
                    for r in range(tokens.shape[0]):
                        if table[r].any():  # a live row (idle rows point at page 0)
                            for i in range(tokens.shape[1]):
                                seen[int(start[r]) + i] = (int(tokens[r, i]), logits[r, i])
                results.append((served, seen))
            stats = b.stats()
        finally:
            b.close()
    return results, stats


def _errors(prompt, served, seen) -> torch.Tensor:
    """|port - reference| of the logits at every position of prompt +
    served from the first the port forwarded (a prefix from the cache is
    not), checking the port fed the token the sequence has there."""
    seq = prompt + served
    want = ref.logits(draw(), TINY, torch.tensor(seq))
    first = min(seen)
    got = []
    for p in range(first, len(seq)):
        token, row = seen[p]
        assert token == seq[p], (p, token, seq[p])
        got.append(row)
    return (torch.stack(got) - want[first:]).abs()


@pytest.fixture(scope="module")
def served(model):
    since = time.perf_counter()
    results, stats = _serve(*model, [PROMPT, WARM])
    return results, stats, since


@pytest.mark.parametrize("case", [0, 1], ids=["spanning-pages", "prefix-hit"])
def test_paged_prefill_then_decode_match_the_reference(served, case):
    results, stats, _ = served
    out, seen = results[case]
    assert len(out) == 10 and min(seen) == 32 * case  # the warm prompt forwards past its hit
    assert _errors([PROMPT, WARM][case], out, seen).max() < TOL
    if case == 1:  # the warm prompt took PROMPT's two full pages from the cache
        assert stats["prefix_hits"] == 2


def test_moe_route_records_tile_the_chunks(served):
    """One ``moe.route`` a paged prefill chunk and a decode chunk, with its
    span's ends; pairs = rows run x top-k x expert layers x steps."""
    _, stats, since = served
    routes = metrics.spans("moe.route", since)
    ends = {(s.t0, s.t1): s.name for name in ("decode.launch", "decode.prefill")
            for s in metrics.spans(name, since)}
    kinds = {"decode": "decode.launch", "prefill": "decode.prefill"}
    assert {r.fields["kind"] for r in routes} == {"decode", "prefill"}
    assert len(routes) == len(ends)
    for r in routes:
        f = r.fields
        assert ends[(r.t0, r.t1)] == kinds[f["kind"]]
        rows_run = 2 if f["kind"] == "decode" else 32  # slots, or the chunk's padded width
        assert f["pairs"] == rows_run * 2 * 2 * f["steps"]
        assert 2 * f["steps"] <= f["experts_hit"] <= 8 * 2 * f["steps"]
        assert -(-rows_run * 2 // 8) <= f["expert_tokens_max"] <= rows_run
    assert stats["kv_bytes_per_token"] == 3 * (32 + 16) * 4  # 3 layers, f32 entries


def test_the_routers_experts_and_weights_equal_the_references(model):
    params, cfg = model
    layer = params["layers"][1]
    x = torch.randn(50, 64, generator=torch.Generator().manual_seed(3))
    idx, w = moe.route(x, layer["router"], cfg)
    want_idx, want_w = ref.gate(x, draw()["model.layers.1.mlp.gate.weight"], TINY)
    a, b = idx.sort(dim=-1), want_idx.sort(dim=-1)
    assert torch.equal(a.values, b.values)
    assert torch.equal(w.gather(1, a.indices), want_w.gather(1, b.indices))


def _published():
    cfg = json.loads((ROOT / "portbench" / "configs" / "deepseek-v2-lite.local-rag.json")
                     .read_text())
    return cfg, decoder_config_from_hf(types.SimpleNamespace(**cfg), torch.float32)


def test_yarn_tables_and_softmax_scale_at_the_published_numbers():
    """DeepSeek-V2-Lite: pairs below 10 keep rope_theta's frequencies, pairs
    above 23 are divided by 40, the tables' scale is 1 and the softmax's
    192^-0.5 x (0.1 x 0.707 x ln 40 + 1)^2 = 0.11472; the tables are the
    reference's bit for bit."""
    hf, cfg = _published()
    assert mla.correction_range(cfg.mla, cfg.rope_theta) == (10, 23)
    freq = mla.rope_frequencies(cfg)
    plain = 1.0 / (10000.0 ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64))
    assert torch.equal(freq[:11], plain[:11])
    assert torch.allclose(freq[23:], plain[23:] / 40, rtol=1e-6, atol=0)
    assert ((freq[11:23] < plain[11:23]) & (freq[11:23] > plain[11:23] / 40)).all()
    assert mla.table_scale(cfg.mla) == 1.0
    assert mla.softmax_scale(cfg.mla) == pytest.approx(0.11472, abs=5e-6)
    assert mla.softmax_scale(cfg.mla) == ref.softmax_scale(hf)
    start = torch.tensor([0, 3000], dtype=torch.int32)
    at = mla.walk(freq, torch.zeros((2, 32), dtype=torch.int32), start, 8, 128, None, cfg)
    cos, sin = ref.rope_tables(hf, 3008, CPU)
    for r, s in enumerate(start.tolist()):
        assert torch.equal(at.cos[r, :, 0], cos[s : s + 8, :32])
        assert torch.equal(at.sin[r, :, 0], sin[s : s + 8, 32:])


def test_the_latent_pool_holds_31104_bytes_a_token_at_the_published_widths():
    _, cfg = _published()
    pool = init_paged_cache(dataclasses.replace(cfg, dtype=torch.bfloat16), 1, 2, 128,
                            device="cpu")
    assert pool.latent.shape == (27, 2, 128, 576) and pool.bytes_per_token == 31_104


def test_the_grouped_product_matches_the_per_expert_path():
    """``experts_grouped`` (``torch._grouped_mm``, the card's route) against
    the loop over experts, in bf16 at widths the grouped product aligns,
    with an expert that takes no pair; the card holds them at the published
    widths (``tests/test_torch_cuda.py``)."""
    g = torch.Generator().manual_seed(4)
    counts = torch.tensor([5, 0, 9, 1, 0, 7, 3, 11])
    xs = torch.randn(int(counts.sum()), 64, generator=g).bfloat16()
    gu = (torch.randn(8, 64, 64, generator=g) * 0.1).bfloat16()
    down = (torch.randn(8, 64, 32, generator=g) * 0.1).bfloat16()
    got = moe.experts_grouped(xs, counts, gu, down).float()
    want = moe.experts_plain(xs, counts, gu, down).float()
    assert torch.allclose(got, want, rtol=2e-2, atol=2e-3)  # bf16 outputs, sums in f32


def test_the_loader_takes_the_draws_experts_as_views(model):
    sd = draw()
    buf = sd["model.embed_tokens.weight"].untyped_storage().data_ptr()
    params, _ = arch.build(TINY, sd, CPU, torch.float32)
    assert not sd  # consumed
    for layer in params["layers"][1:]:
        for name in ("experts_gu", "experts_down", "wq", "w_uk"):
            assert layer[name].untyped_storage().data_ptr() == buf, name
    assert params["layers"][1]["experts_gu"].shape == (8, 64, 64)


def _renormalised(mp, params):
    real = moe.route

    def route(x, router, cfg):
        idx, w = real(x, router, cfg)
        return idx, w / w.sum(dim=-1, keepdim=True)

    mp.setattr(moe, "route", route)
    return params


def _no_shared(mp, params):
    layers = [dict(layer) for layer in params["layers"]]
    for layer in layers[1:]:
        layer["shared_down"] = torch.zeros_like(layer["shared_down"])
    return dict(params, layers=layers)


def _patch(name, value):
    def plant(mp, params):
        mp.setattr(mla, name, value)
        return params

    return plant


FAULTS = {
    "topk-renormalised": _renormalised,
    "shared-experts-dropped": _no_shared,
    "kv-a-layernorm-skipped": _patch("_rms_norm", lambda x, w, eps: x),
    "rope-not-deinterleaved": _patch("deinterleave", lambda x: x),
    "yarn-mscale-left-out": _patch(
        "softmax_scale", lambda m: (m.qk_nope_dim + m.qk_rope_dim) ** -0.5),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_fails_the_comparison(model, fault):
    params, cfg = model
    with pytest.MonkeyPatch.context() as mp:
        [(out, seen)], _ = _serve(FAULTS[fault](mp, params), cfg, [PROMPT], max_new=4)
    assert _errors(PROMPT, out, seen).max() > 10 * TOL


@pytest.mark.parametrize("option,value", [("kv_int8", True), ("int8_weights", True),
                                          ("int4_weights", True), ("spec_k", 2),
                                          ("tp_devices", 2), ("batch_slots", 0),
                                          ("kv_pages", 0)])
def test_an_unsupported_option_is_refused_by_name(model, option, value):
    params, cfg = model
    kwargs = {"batch_slots": 2, "kv_pages": 40, "page_size": PAGE, **{option: value}}
    name = "paged" if option in ("batch_slots", "kv_pages") else option
    with pytest.raises(ValueError, match=name):
        LocalChatProvider(params, cfg, types.SimpleNamespace(eos_token_id=255), device="cpu",
                          **kwargs)


@pytest.mark.parametrize("key,value", [("q_lora_rank", 1536), ("topk_method", "group_limited_greedy"),
                                       ("scoring_func", "sigmoid"), ("moe_layer_freq", 2),
                                       ("norm_topk_prob", True), ("routed_scaling_factor", 16.0),
                                       ("rope_scaling", None), ("n_routed_experts", None)])
def test_an_unsupported_published_variant_is_refused_by_name(key, value):
    with pytest.raises(ValueError, match=key):
        decoder_config_from_hf(types.SimpleNamespace(**dict(TINY, **{key: value})))


def test_the_ring_forward_is_refused(model):
    params, cfg = model
    ring = decoder_mod.init_cache(dataclasses.replace(cfg, mla=None), 1, CPU)
    with pytest.raises(ValueError, match="paged"):
        decoder_mod.decoder_forward(params, torch.zeros((1, 1), dtype=torch.int32), ring,
                                    torch.zeros((1,), dtype=torch.int32), cfg)
