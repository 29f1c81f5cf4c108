"""The port's ``LocalChatProvider`` (tiny f32 decoder, CPU): streaming deltas,
termination, greedy parity with the JAX package's provider, the batched
route, early close, int4 weights, single-stream and batched speculative
decoding, and the option that is not ported yet. With a tiny
random decoder the text is gibberish; these tests pin the plumbing. Every
wait has a time limit of its own."""

import asyncio
import time

import jax
import numpy as np
import pytest

from outline_rag_tpu.models import decoder as jdec
from outline_rag_tpu.serve import llm as jllm
from outline_rag_tpu_torch.models.convert import decoder_config_from_jax, decoder_from_jax
from outline_rag_tpu_torch.serve import LocalChatProvider
from outline_rag_tpu_torch.testing import ByteTokenizer

WAIT = 60


class StubTok:
    """Reversible-enough tokenizer stub (no tokenizer files needed)."""

    eos_token_id = 0

    def encode(self, text: str):
        return [1 + (b % 250) for b in text.encode()][:120]

    def decode(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids)


@pytest.fixture(scope="module")
def setup():
    jcfg = jdec.DecoderConfig.tiny()
    jparams = jdec.init_decoder_params(jax.random.key(0), jcfg)
    cfg = decoder_config_from_jax(jcfg)
    params = decoder_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return cfg, params, jcfg, jparams


def provider(setup, **kw):
    cfg, params = setup[:2]
    kw.setdefault("chunk_tokens", 8)
    kw.setdefault("max_new_tokens", 24)
    return LocalChatProvider(params, cfg, StubTok(), device="cpu", **kw)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, WAIT))


async def stream_text(prov, text, temperature=0.0, top_p=1.0):
    out = []
    async for delta in prov.stream("local", [{"role": "user", "content": text}],
                                   temperature=temperature, top_p=top_p):
        assert set(delta) == {"content", "thinking", "model"}
        assert delta["thinking"] is None and delta["model"] == prov.model_name
        out.append(delta["content"] or "")
    return "".join(out)


def test_stream_yields_and_terminates(setup):
    text = run(stream_text(provider(setup), "hello", temperature=0.7, top_p=0.9))
    assert 0 < len(text) <= 24 * 4


def test_complete_returns_text_and_honours_max_tokens(setup):
    prov = provider(setup)
    text = run(prov.complete("local", [{"role": "user", "content": "classify this"}],
                             temperature=0.0, max_tokens=12))
    assert isinstance(text, str) and len(text) <= 12
    assert prov.stats() == {"model": "local-gpu", "mode": "single-stream"}


def test_greedy_deterministic_and_sampled_reproduces(setup):
    prov = provider(setup)
    msgs = [{"role": "user", "content": "same prompt"}]
    a = run(prov.complete("local", msgs, temperature=0.0))
    assert a == run(prov.complete("local", msgs, temperature=0.0))
    # the sampled stream is keyed by the prompt: it reproduces too
    s = run(prov.complete("local", msgs, temperature=1.3, top_p=0.9))
    assert s == run(prov.complete("local", msgs, temperature=1.3, top_p=0.9))


@pytest.mark.parametrize("chunk_tokens", [4, 8])
def test_greedy_text_equals_jax_provider(setup, chunk_tokens):
    """Same prompt, same tiny weights: the port's provider and the JAX
    package's emit the same greedy text (the pipelined loop included)."""
    cfg, params, jcfg, jparams = setup
    jprov = jllm.LocalChatProvider(jparams, jcfg, StubTok(), chunk_tokens=chunk_tokens,
                                   max_new_tokens=24)
    tprov = provider(setup, chunk_tokens=chunk_tokens)
    for text in ("hello", "a longer question about wolves and geiger counters"):
        msgs = [{"role": "user", "content": text}]
        want = run(jprov.complete("local", msgs, temperature=0.0))
        assert run(tprov.complete("local", msgs, temperature=0.0)) == want
        assert run(stream_text(tprov, text)) == want


def test_lookahead_loop_matches_serial_chunks(setup):
    """The one-chunk lookahead only reorders dispatches: its text equals a
    serial loop of decoder steps over the same prompt."""
    import torch

    from outline_rag_tpu_torch.models.decoder import decoder_forward, init_cache

    cfg, params = setup[:2]
    prov = provider(setup, chunk_tokens=4, max_new_tokens=18)
    msgs = [{"role": "user", "content": "serial oracle"}]
    got = run(prov.complete("local", msgs, temperature=0.0))
    ids = prov._encode_prompt(prov._render(msgs))
    with torch.inference_mode():
        cache = init_cache(cfg, 1, "cpu")
        logits, cache = decoder_forward(prov.params, torch.tensor([ids]), cache,
                                        torch.zeros(1, dtype=torch.int32), cfg)
        tok, out = int(logits[0, -1].argmax()), []
        while tok != 0 and len(out) < 18:
            out.append(tok)
            logits, cache = decoder_forward(
                prov.params, torch.tensor([[tok]]), cache,
                torch.tensor([len(ids) + len(out) - 1], dtype=torch.int32), cfg)
            tok = int(logits[0, -1].argmax())
    assert got == StubTok().decode(out)


def test_batched_streams_equal_solo(setup):
    """batch_slots=2: two concurrent greedy streams equal their sequential
    unbatched outputs."""
    prov_b = provider(setup, chunk_tokens=4, max_new_tokens=10, batch_slots=2)
    prov_s = provider(setup, chunk_tokens=4, max_new_tokens=10)

    async def both():
        return await asyncio.gather(stream_text(prov_b, "alpha"), stream_text(prov_b, "beta"))

    try:
        batched = run(both())
        assert prov_b.stats()["mode"] == "ring" and prov_b.stats()["slots"] == 2
    finally:
        prov_b.close()
    assert batched == [run(stream_text(prov_s, "alpha")), run(stream_text(prov_s, "beta"))]


def test_many_streams_run_at_once(setup):
    """More concurrent streams than a default thread pool has workers: each
    has its own feeding thread, so all of them end."""
    prov = provider(setup, chunk_tokens=4, max_new_tokens=6, batch_slots=4, kv_pages=24,
                    page_size=16)

    async def burst():
        return await asyncio.gather(*(stream_text(prov, f"question {i}") for i in range(40)))

    try:
        texts = run(burst())
        st = prov.stats()
    finally:
        prov.close()
    assert len(texts) == 40 and all(0 < len(t) <= 6 for t in texts)
    assert st["mode"] == "paged" and st["active"] == 0
    assert st["pages_free"] + st["pages_cached"] == st["pages_total"]


def test_stream_close_cancels_row(setup):
    """Closing the async stream mid-generation frees the batcher slot (the
    path a client disconnect takes)."""
    prov = provider(setup, chunk_tokens=2, max_new_tokens=50, batch_slots=2)

    async def abandon():
        gen = prov.stream("m", [{"role": "user", "content": "hello"}], temperature=0.0)
        async for _ in gen:
            break  # take one piece, then abandon
        await gen.aclose()

    try:
        run(abandon())
        deadline = time.time() + 15
        while time.time() < deadline and prov._batcher.stats()["active"]:
            time.sleep(0.05)
        assert prov._batcher.stats()["active"] == 0
    finally:
        prov.close()


def test_stream_surfaces_worker_failure(setup):
    prov = provider(setup, chunk_tokens=2, max_new_tokens=50, batch_slots=2)

    def boom(*a, **k):
        raise RuntimeError("simulated device failure")

    prov._batcher._step_chunk = boom
    try:
        with pytest.raises(RuntimeError, match="simulated device failure"):
            run(stream_text(prov, "hello"))
    finally:
        prov.close()


@pytest.mark.parametrize("int8_mode", ["w8a8", "kernel"])
def test_int8_provider_stream(setup, monkeypatch, int8_mode):
    """int8 weights serve through the same plumbing in both matmul modes,
    and a greedy run repeats."""
    from outline_rag_tpu_torch.models import decoder as tdec

    monkeypatch.setattr(tdec, "_INT8_MODE", int8_mode)
    prov = provider(setup, int8_weights=True, max_new_tokens=12)
    assert set(prov.params["layers"][0]["wqkv"]) == {"q", "s"}
    a = run(stream_text(prov, "quantized"))
    assert 0 < len(a) <= 12 and a == run(stream_text(prov, "quantized"))


def test_prequantized_params_are_taken_as_they_are(setup):
    prov = provider(setup, int8_weights=True)
    again = provider((setup[0], prov.params), int8_weights=True, prequantized=True)
    assert again.params["layers"][0]["wo"]["q"] is prov.params["layers"][0]["wo"]["q"]
    with pytest.raises(ValueError, match="prequantized"):
        provider((setup[0], prov.params), prequantized=True)


@pytest.mark.parametrize("kw", [{"tp_devices": 2}], ids=["tp_devices"])
def test_unported_options_raise(setup, kw):
    with pytest.raises(NotImplementedError, match="later slice"):
        provider(setup, **kw)


# ----------------------------------------------------------------------
# int4 weights and speculative decoding
# ----------------------------------------------------------------------


def test_int4_provider_stream_and_exclusivity(setup):
    import torch

    prov = provider(setup, int4_weights=True, chunk_tokens=4, max_new_tokens=8)
    leaf = prov.params["layers"][0]["wqkv"]
    assert leaf["q4"].dtype == torch.uint8 and set(leaf) == {"q4", "s4"}
    a = run(stream_text(prov, "hello int4"))
    assert 0 < len(a) <= 8 and a == run(stream_text(prov, "hello int4"))
    with pytest.raises(ValueError, match="mutually exclusive"):
        provider(setup, int8_weights=True, int4_weights=True)


def test_int4_prequantized_params_are_taken_as_they_are(setup):
    prov = provider(setup, int4_weights=True)
    again = provider((setup[0], prov.params), int4_weights=True, prequantized=True)
    assert again.params["layers"][0]["wo"]["q4"] is prov.params["layers"][0]["wo"]["q4"]
    assert run(stream_text(again, "same tree")) == run(stream_text(prov, "same tree"))


def test_int4_batched_streams_equal_single_stream(setup):
    solo = provider(setup, int4_weights=True, chunk_tokens=4, max_new_tokens=8)
    batched = provider(setup, int4_weights=True, chunk_tokens=4, max_new_tokens=8, batch_slots=2,
                       kv_pages=8, page_size=16)
    try:
        async def both():
            return await asyncio.gather(stream_text(batched, "alpha"), stream_text(batched, "beta beta"))

        assert run(both()) == [run(stream_text(solo, "alpha")), run(stream_text(solo, "beta beta"))]
    finally:
        batched.close()


@pytest.mark.parametrize("kw", [{}, {"int4_weights": True}], ids=["dense", "int4"])
@pytest.mark.parametrize("text", ["hello", "abababababab", "the quick brown fox " * 3])
def test_single_stream_spec_equals_the_plain_loop(setup, kw, text):
    """Greedy: ``_generate_spec`` emits the plain loop's text, whatever it
    accepts and wherever the chunks end (max_new = 21 is no multiple of the
    chunk, and the lookahead discards a chunk at the stop)."""
    plain = provider(setup, chunk_tokens=4, max_new_tokens=21, **kw)
    spec = provider(setup, chunk_tokens=4, max_new_tokens=21, spec_k=3, spec_gram=2, **kw)
    want = run(stream_text(plain, text))
    assert run(stream_text(spec, text)) == want and len(want) == 21
    assert spec.stats()["mode"] == "single-stream"


def test_single_stream_spec_sampled_is_reproducible_and_honours_max_tokens(setup):
    spec = provider(setup, chunk_tokens=4, max_new_tokens=24, spec_k=2)
    a = run(stream_text(spec, "sample me", temperature=0.9, top_p=0.9))
    assert a == run(stream_text(spec, "sample me", temperature=0.9, top_p=0.9)) and 0 < len(a) <= 24
    msg = [{"role": "user", "content": "short"}]
    assert len(run(spec.complete("m", msg, max_tokens=5))) == 5


def test_single_stream_spec_stops_at_the_cache_capacity(setup):
    """A prompt that leaves less room than the budget: the speculative loop
    ends at the capacity (the guard freezes the row) with the plain loop's
    text up to there."""
    text = "y" * 100  # the stub caps prompts at 120 ids; the cache holds 64
    plain = provider(setup, chunk_tokens=4, max_new_tokens=12)
    spec = provider(setup, chunk_tokens=4, max_new_tokens=12, spec_k=3)
    want, got = run(stream_text(plain, text)), run(stream_text(spec, text))
    assert 0 < len(got) <= 12 and want.startswith(got) and len(got) >= len(want) - 4


def test_batched_spec_provider_equals_plain_and_reports_acceptance(setup):
    plain = provider(setup, chunk_tokens=4, max_new_tokens=20, batch_slots=2, kv_pages=12, page_size=16)
    spec = provider(setup, chunk_tokens=4, max_new_tokens=20, batch_slots=2, kv_pages=12,
                    page_size=16, spec_k=3, spec_gram=2, int4_weights=True)
    plain4 = provider(setup, chunk_tokens=4, max_new_tokens=20, batch_slots=2, kv_pages=12,
                      page_size=16, int4_weights=True)
    try:
        async def both(prov):
            return await asyncio.gather(stream_text(prov, "abababababab"), stream_text(prov, "other"))

        assert run(both(spec)) == run(both(plain4))
        assert len(run(both(plain))) == 2
        assert spec.stats()["spec_tokens_per_step"] >= 1.0 and spec.stats()["mode"] == "paged"
    finally:
        for prov in (plain, spec, plain4):
            prov.close()


def test_default_device_is_the_card(setup):
    cfg, params = setup[:2]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LocalChatProvider(params, cfg, StubTok())


def test_prompt_is_cut_to_leave_room_and_ladder_reaches_max_cache(setup):
    prov = provider(setup, prompt_buckets=(16, 32), max_new_tokens=24)
    assert prov.prompt_buckets == (16, 32, 64)
    ids = prov._encode_prompt("x" * 500)
    assert len(ids) == 64 - 24 - 1  # the tail of the prompt is kept
    text = run(prov.complete("local", [{"role": "user", "content": "y" * 500}], temperature=0.0))
    assert len(text) <= 24


def test_json_mode_appends_an_instruction(setup):
    prov = provider(setup)
    seen = []
    prov._pieces = lambda messages, *a: seen.append(messages) or iter(["{}"])
    assert run(prov.complete("local", [{"role": "user", "content": "q"}], json_mode=True)) == "{}"
    assert len(seen[0]) == 2 and "JSON" in seen[0][-1]["content"]


def test_byte_tokenizer_round_trips_and_decodes_any_id():
    tok = ByteTokenizer()
    text = "wölfe & geiger: 42 ✓"
    ids = tok.encode(text)
    assert tok.decode(ids) == text and min(ids) >= 3 and max(ids) < tok.vocab_size
    assert tok.decode([tok.eos_token_id, 1, 0]) == ""
    assert tok.decode([31999, 259, 68]) == chr(32 + (31999 - 259) % 95) + " A"
