"""Continuous batching in the port (``outline_rag_tpu_torch.serve``), tiny
f32 decoder on the CPU: batched greedy decoding equals solo decoding and the
JAX package's ``DecodeBatcher`` token for token; admission, slot reuse, the
paged pool's allocator, prefix cache, cancellation and teardown behave as
the JAX package's do. Speculative steps (``spec_k > 0``) give the streams of
``spec_k = 0``, alone and with int4 weights, the paged pool and an int8 pool
together. Every wait on a queue or a thread has a time limit of
its own."""

import asyncio
import queue as _q
import random
import threading
import time

import jax
import numpy as np
import pytest
import torch

from outline_rag_tpu.models import decoder as jdec
from outline_rag_tpu.serve import decode_batcher as jbatcher
from outline_rag_tpu_torch.models.convert import decoder_config_from_jax, decoder_from_jax
from outline_rag_tpu_torch.serve.decode_batcher import DONE, DecodeBatcher
from outline_rag_tpu_torch.serve.llm import LocalChatProvider

WAIT = 60  # seconds any single wait may take


class StubTok:
    eos_token_id = 0

    def encode(self, text: str):
        return [1 + (b % 250) for b in text.encode()][:60]

    def decode(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids)


@pytest.fixture(scope="module")
def setup():
    jcfg = jdec.DecoderConfig.tiny()
    jparams = jdec.init_decoder_params(jax.random.key(0), jcfg)
    cfg = decoder_config_from_jax(jcfg)
    params = decoder_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return cfg, params, jcfg, jparams


def make(setup, **kw):
    cfg, params = setup[:2]
    kw.setdefault("eos_id", 0)
    return DecodeBatcher(params, cfg, device="cpu", **kw)


def collect(q, done=DONE):
    out = []
    while True:
        item = q.get(timeout=WAIT)
        if item is done:
            return out
        if isinstance(item, Exception):
            raise item
        out.extend(item)


def solo_greedy(setup, prompt_ids, max_new):
    """Reference: single-request greedy via the unbatched provider path."""
    cfg, params = setup[:2]
    ids = []

    class Cap:
        eos_token_id = 0

        def encode(self, t):
            return prompt_ids

        def decode(self, got):
            ids.clear()
            ids.extend(got)
            return "".join(chr(97 + (i % 26)) for i in got)

    prov = LocalChatProvider(params, cfg, Cap(), chunk_tokens=4, max_new_tokens=max_new,
                             device="cpu")
    asyncio.run(asyncio.wait_for(
        prov.complete("m", [{"role": "user", "content": "x"}], temperature=0.0), WAIT))
    return list(ids)


PROMPTS = [[5, 9, 13, 2, 7], [100, 101, 102], [40, 41, 42, 43, 44, 45, 46]]


def test_batched_greedy_matches_solo(setup):
    batcher = make(setup, slots=3, chunk_tokens=4)
    try:
        queues = [batcher.submit(p, 0.0, 1.0, 12) for p in PROMPTS]
        got = [collect(q) for q in queues]
    finally:
        batcher.close()
    for p, g in zip(PROMPTS, got):
        assert g == solo_greedy(setup, p, 12), (p, g)


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_batched_greedy_matches_jax_batcher(setup, paged):
    """The same prompts through the JAX package's DecodeBatcher and the
    port's give the same greedy tokens (f32, tiny, CPU)."""
    cfg, params, jcfg, jparams = setup
    kw = dict(slots=3, chunk_tokens=4, eos_id=0)
    if paged:
        kw.update(kv_pages=16, page_size=16)
    stacked = jdec.stack_decoder_params(jdec.cast_decoder_params(jparams, jcfg.dtype))
    jb = jbatcher.DecodeBatcher(stacked, jcfg, **kw)
    try:
        want = [collect(q, jbatcher.DONE) for q in [jb.submit(p, 0.0, 1.0, 12) for p in PROMPTS]]
    finally:
        jb.close()
    tb = DecodeBatcher(params, cfg, device="cpu", **kw)
    try:
        got = [collect(q) for q in [tb.submit(p, 0.0, 1.0, 12) for p in PROMPTS]]
    finally:
        tb.close()
    assert got == want


def test_staggered_admission_and_slot_reuse(setup):
    batcher = make(setup, slots=2, chunk_tokens=4)
    try:
        qa = batcher.submit([5, 9, 13], 0.0, 1.0, 10)
        first_a = qa.get(timeout=WAIT)  # A mid-flight
        assert first_a is not DONE
        # B joins while A decodes; C queues behind the 2 slots and reuses one
        qb = batcher.submit([77, 78], 0.0, 1.0, 10)
        qc = batcher.submit([200, 201, 202, 203], 0.0, 1.0, 10)
        got_a = (first_a if isinstance(first_a, list) else []) + collect(qa)
        got_b = collect(qb)
        got_c = collect(qc)
    finally:
        batcher.close()
    assert got_a == solo_greedy(setup, [5, 9, 13], 10)
    assert got_b == solo_greedy(setup, [77, 78], 10)
    assert got_c == solo_greedy(setup, [200, 201, 202, 203], 10)


def test_close_releases_waiters(setup):
    """close() must unblock in-flight and queued requests."""
    batcher = make(setup, slots=1, chunk_tokens=2)
    q1 = batcher.submit([5, 9], 0.0, 1.0, 1000)  # long-running
    q2 = batcher.submit([7, 7], 0.0, 1.0, 1000)  # queued behind 1 slot
    q1.get(timeout=WAIT)  # first token flowing
    batcher.close()
    assert not batcher._thread.is_alive()

    def drain(q):
        while True:
            if q.get(timeout=10) is DONE:
                return True

    assert drain(q1) and drain(q2)


def test_worker_crash_fails_fast(setup):
    """An error in the step loop must reach every in-flight request (not
    hang), mark the batcher dead, and make later submits fail fast."""
    batcher = make(setup, slots=2, chunk_tokens=2)
    boom = RuntimeError("simulated device failure")

    def exploding_step(*a, **k):
        raise boom

    q1 = batcher.submit([5, 9, 13], 0.0, 1.0, 1000)
    q1.get(timeout=WAIT)  # admitted, first token flowing
    batcher._step_chunk = exploding_step
    got = []
    while True:
        item = q1.get(timeout=WAIT)
        if item is DONE:
            break
        got.append(item)
    assert any(isinstance(i, RuntimeError) for i in got)
    assert batcher.dead is boom
    with pytest.raises(RuntimeError, match="dead"):
        batcher.submit([1, 2], 0.0, 1.0, 10)
    batcher.close()


def test_paged_batcher_greedy_matches_ring(setup):
    """Page-table indirection and pooled storage must not change a single
    token against solo ring decoding."""
    batcher = make(setup, slots=3, chunk_tokens=4, kv_pages=16, page_size=16)
    try:
        queues = [batcher.submit(p, 0.0, 1.0, 12) for p in PROMPTS]
        got = [collect(q) for q in queues]
    finally:
        batcher.close()
    for p, g in zip(PROMPTS, got):
        assert g == solo_greedy(setup, p, 12), (p, g)


def test_paged_batcher_backpressure_and_reuse(setup):
    """A pool too small for all requests at once: the third request is held
    until a finish frees its pages, then completes on reused pages."""
    # each request needs ceil((len+max_new+1)/16) = 2 pages; page 0 reserved
    # + 4 allocatable -> two concurrent requests at most
    batcher = make(setup, slots=3, chunk_tokens=4, kv_pages=5, page_size=16)
    prompts = [[5, 9, 13], [77, 78, 79], [200, 201, 202, 203]]
    max_news = [24, 24, 12]
    try:
        queues = [batcher.submit(p, 0.0, 1.0, mn) for p, mn in zip(prompts, max_news)]
        got = [collect(q) for q in queues]
        assert len(batcher._free_pages) == 4
        assert batcher.stats()["backpressure_waits"] >= 1
    finally:
        batcher.close()
    for p, mn, g in zip(prompts, max_news, got):
        assert g == solo_greedy(setup, p, mn), (p, g)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32_pool", "int8_pool"])
def test_prefix_cache_warm_equals_cold(setup, kv_int8):
    """A request repeating an earlier prompt's full pages skips their
    prefill yet produces bit-identical output, also when only the prefix
    matches."""
    prefix = [(7 * i) % 200 + 1 for i in range(16)]  # one full 16-token page
    pa = prefix + [5, 9, 13, 2]
    pc = prefix + [100, 101]  # same first page, different tail
    kw = dict(slots=2, chunk_tokens=4, kv_pages=16, page_size=16, kv_int8=kv_int8)

    def cold(p):
        b = make(setup, **kw)
        try:
            return collect(b.submit(p, 0.0, 1.0, 10))
        finally:
            b.close()

    batcher = make(setup, **kw)
    try:
        got_a = collect(batcher.submit(pa, 0.0, 1.0, 10))
        assert batcher.prefix_hits == 0  # first sight: nothing to share
        got_b = collect(batcher.submit(pa, 0.0, 1.0, 10))  # exact repeat
        assert batcher.prefix_hits == 1
        got_c = collect(batcher.submit(pc, 0.0, 1.0, 10))  # prefix repeat
        assert batcher.prefix_hits == 2
    finally:
        batcher.close()
    assert got_b == got_a
    assert got_a == cold(pa)
    assert got_c == cold(pc)


def test_prefix_cache_warm_logits_bit_identical(setup):
    """The stronger form of warm == cold: the logits that seed the first
    sampled token are bit-equal whether the prefix was prefilled or found
    in the cache."""
    prompt = [(7 * i) % 200 + 1 for i in range(37)]
    batcher = make(setup, slots=2, chunk_tokens=4, kv_pages=16, page_size=16, prefill_chunk=16)
    seen = []
    orig = batcher._sample_first

    def spy(req, logits, offset):
        seen.append(logits[0, offset].clone())
        return orig(req, logits, offset)

    batcher._sample_first = spy
    try:
        collect(batcher.submit(prompt, 0.0, 1.0, 4))
        collect(batcher.submit(prompt, 0.0, 1.0, 4))
        assert batcher.prefix_hits == 2
    finally:
        batcher.close()
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])


def test_prefix_cache_eviction_under_pressure(setup):
    """Cached ref-0 pages are reclaimed (LRU) when a new request needs them."""
    # pool: page 0 scratch + 4 allocatable (= maxp, the minimum legal)
    batcher = make(setup, slots=2, chunk_tokens=4, kv_pages=5, page_size=16)
    try:
        prefix = [(3 * i) % 150 + 1 for i in range(16)]
        collect(batcher.submit(prefix + [5], 0.0, 1.0, 8))
        assert len(batcher._prefix_map) == 1  # block 0 cached, ref 0
        # needs ceil((40+8+1)/16) = 4 pages -> must evict the cached one
        big = [(11 * i) % 150 + 1 for i in range(40)]
        got = collect(batcher.submit(big, 0.0, 1.0, 8))
        assert len(batcher._prefix_map) == 2  # the big prompt's own 2 full pages
        assert all(r == 0 for r in batcher._page_ref[1:])
    finally:
        batcher.close()
    assert got == solo_greedy(setup, big, 8)


def test_prefix_cache_disabled(setup):
    batcher = make(setup, slots=2, chunk_tokens=4, kv_pages=16, page_size=16,
                   prefix_cache=False)
    try:
        p = [(7 * i) % 200 + 1 for i in range(20)]
        a = collect(batcher.submit(p, 0.0, 1.0, 10))
        b = collect(batcher.submit(p, 0.0, 1.0, 10))
        assert a == b
        assert batcher.prefix_hits == 0
        assert not batcher._prefix_map
    finally:
        batcher.close()


def test_flush_prefix_cache_frees_unused_pages(setup):
    batcher = make(setup, slots=2, chunk_tokens=4, kv_pages=8, page_size=16)
    try:
        collect(batcher.submit([(7 * i) % 200 + 1 for i in range(20)], 0.0, 1.0, 4))
        assert batcher.stats()["pages_cached"] == 1
        assert batcher.stats()["pages_free"] == 6
        batcher.flush_prefix_cache()
        assert batcher.stats()["pages_cached"] == 0
        assert batcher.stats()["pages_free"] == 7
    finally:
        batcher.close()


def test_per_request_seeds_diverge_and_reproduce(setup):
    """Sampling randomness is per request: identical prompts with different
    seeds diverge, the same (seed, prompt) reproduces, and a stream does
    not depend on the batch it shares, its slot or the chunk length."""
    prompt = [5, 9, 13, 2, 7, 40, 41]

    def run(seed, **kw):
        kw.setdefault("chunk_tokens", 4)
        b = make(setup, slots=2, **kw)
        try:
            return collect(b.submit(prompt, 1.5, 0.95, 12, seed=seed))
        finally:
            b.close()

    s1, s2 = run(1), run(2)
    assert s1 != s2  # different seeds -> different streams
    assert s1 == run(1)  # same seed reproduces
    assert s1 == run(1, chunk_tokens=3)  # chunk boundaries do not matter
    assert s1 == run(1, kv_pages=16, page_size=16)  # nor the cache form

    # concurrent identical prompts with different seeds in ONE batch
    b = make(setup, slots=2, chunk_tokens=4)
    try:
        q2 = b.submit(prompt, 1.5, 0.95, 12, seed=2)  # slots swapped
        q1 = b.submit(prompt, 1.5, 0.95, 12, seed=1)
        got1, got2 = collect(q1), collect(q2)
    finally:
        b.close()
    assert got1 == s1
    assert got2 == s2


def test_paged_rejects_indivisible_page_size(setup):
    with pytest.raises(ValueError, match="not divisible"):
        make(setup, slots=2, kv_pages=8, page_size=24)


def test_paged_pool_must_fit_one_full_request(setup):
    with pytest.raises(ValueError, match="one full-length request"):
        make(setup, slots=2, kv_pages=4, page_size=16)


def test_kv_int8_batcher_generates_and_reproduces(setup):
    """int8 paged pool: requests are served end to end and a (seed, prompt)
    pair reproduces exactly (quantized KV is deterministic)."""

    def run():
        b = make(setup, slots=2, chunk_tokens=4, kv_pages=16, page_size=16, kv_int8=True)
        try:
            qs = [
                b.submit([5, 9, 13, 2, 7], 0.0, 1.0, 12, seed=1),
                b.submit([(7 * i) % 200 + 1 for i in range(20)], 1.2, 0.95, 10, seed=2),
            ]
            out = [collect(q) for q in qs]
            assert b.stats()["kv_dtype"] == "int8"
            return out
        finally:
            b.close()

    first = run()
    assert 0 < len(first[0]) <= 12 and 0 < len(first[1]) <= 10
    assert first == run()


def test_paged_multichunk_prefill_matches_solo(setup):
    """Prompts longer than the prefill chunk run several chunked paged
    prefills; output still matches solo ring decoding, cold and warm."""
    batcher = make(setup, slots=2, chunk_tokens=4, kv_pages=16, page_size=16,
                   prefill_chunk=16)
    prompt = [(7 * i) % 200 + 1 for i in range(40)]  # 3 prefill chunks
    try:
        cold = collect(batcher.submit(prompt, 0.0, 1.0, 10))
        warm = collect(batcher.submit(prompt, 0.0, 1.0, 10))
        assert batcher.prefix_hits >= 2  # 2 full pages shared on repeat
    finally:
        batcher.close()
    assert cold == solo_greedy(setup, prompt, 10)
    assert warm == cold


def test_paged_interleaved_admission_under_load(setup):
    """A long multi-chunk prompt admits while another stream decodes; both
    streams still match solo decoding."""
    batcher = make(setup, slots=2, chunk_tokens=2, kv_pages=16, page_size=16,
                   prefill_chunk=16)
    short = [5, 9, 13]
    long_p = [(3 * i) % 190 + 1 for i in range(44)]  # 3 prefill chunks
    try:
        qa = batcher.submit(short, 0.0, 1.0, 14)
        first = qa.get(timeout=WAIT)  # A is decoding
        assert first is not DONE and not isinstance(first, Exception)
        qb = batcher.submit(long_p, 0.0, 1.0, 10)  # admits mid-decode
        got_a = (first if isinstance(first, list) else []) + collect(qa)
        got_b = collect(qb)
    finally:
        batcher.close()
    assert got_a == solo_greedy(setup, short, 14)
    assert got_b == solo_greedy(setup, long_p, 10)


def test_kv_int8_requires_paged_pool(setup):
    with pytest.raises(ValueError, match="kv_int8 requires"):
        make(setup, slots=2, kv_int8=True)


@pytest.mark.parametrize("kw", [{"mesh": object()}], ids=["mesh"])
def test_unported_options_raise(setup, kw):
    with pytest.raises(NotImplementedError, match="later slice"):
        make(setup, slots=2, **kw)


# ----------------------------------------------------------------------
# speculative steps
# ----------------------------------------------------------------------

REPEATING = [(7 * i) % 200 + 1 for i in range(20)]


def run_requests(setup, requests, **kw):
    """[(prompt, temperature, top_p, max_new, seed)] through one batcher, all
    submitted at once: (token lists, the batcher's final stats)."""
    b = make(setup, **kw)
    try:
        queues = [b.submit(p, t, tp, n, seed=s) for p, t, tp, n, s in requests]
        out = [collect(q) for q in queues]
        deadline = time.time() + WAIT
        while b.stats()["active"] and time.time() < deadline:
            time.sleep(0.01)
        return out, b.stats()
    finally:
        b.close()


@pytest.mark.parametrize("pool", [{}, {"kv_pages": 16, "page_size": 16, "prefill_chunk": 16}],
                         ids=["ring", "paged"])
def test_spec_streams_equal_plain_streams(setup, pool):
    """Greedy and sampled requests sharing a batch: speculation changes how
    many tokens a forward yields, never which."""
    rng = random.Random(3)
    requests = [(REPEATING, 0.0, 1.0, 24, 0),
                ([rng.randrange(1, 250) for _ in range(11)], 0.9, 0.95, 20, 7),
                ([5, 9, 5, 9, 5, 9, 5], 0.0, 1.0, 30, 0),
                ([rng.randrange(1, 250) for _ in range(30)], 1.2, 0.8, 12, 9)]
    plain, plain_stats = run_requests(setup, requests, slots=3, chunk_tokens=3, **pool)
    spec, stats = run_requests(setup, requests, slots=3, chunk_tokens=3, spec_k=3, spec_gram=2, **pool)
    assert spec == plain and all(len(ids) > 0 for ids in spec)
    assert "spec_tokens_per_step" not in plain_stats
    assert stats["spec_tokens_per_step"] >= 1.0
    if pool:
        assert stats["pages_free"] + stats["pages_cached"] == stats["pages_total"]


def test_spec_accepts_drafts_on_a_repeating_stream(setup):
    out, stats = run_requests(setup, [([5, 9, 5, 9, 5, 9, 5], 0.0, 1.0, 40, 0)], slots=2,
                              chunk_tokens=4, spec_k=3, spec_gram=2)
    assert out[0] == solo_greedy(setup, [5, 9, 5, 9, 5, 9, 5], 40)
    assert stats["spec_tokens_per_step"] > 1.0  # the tiny model falls into a cycle


def test_spec_composes_with_int4_weights_paged_pool_and_int8_kv():
    """The whole quantized stack in one batcher (the JAX package's
    ``test_int4_composes_with_spec_paged_int8kv``, at its sizes): the streams
    equal the ``spec_k = 0`` streams, warm equals cold, a rerun reproduces
    them, the pages come back and the acceptance is reported."""
    from outline_rag_tpu_torch.models import decoder as tdec

    cfg = tdec.DecoderConfig(vocab_size=512, hidden=256, layers=2, heads=4, kv_heads=2,
                             intermediate=512, max_cache=64, dtype=torch.float32)
    params = tdec.quantize_decoder_params_int4(tdec.fuse_decoder_params(
        tdec.init_decoder(cfg, torch.Generator().manual_seed(3), "cpu")))

    def run(spec_k):
        b = DecodeBatcher(params, cfg, slots=2, chunk_tokens=4, eos_id=0, spec_k=spec_k,
                          spec_gram=2, kv_pages=16, page_size=16, kv_int8=True,
                          prefill_chunk=16, device="cpu")
        try:
            cold = collect(b.submit(REPEATING, 0.8, 0.95, 10, seed=7))
            warm = collect(b.submit(REPEATING, 0.8, 0.95, 10, seed=7))
            greedy = collect(b.submit(REPEATING, 0.0, 1.0, 10, seed=7))
            assert b.prefix_hits >= 2
            deadline = time.time() + WAIT
            while b.stats()["active"] and time.time() < deadline:
                time.sleep(0.01)
            return cold, warm, greedy, b.stats()
        finally:
            b.close()

    cold, warm, greedy, stats = run(2)
    assert cold == warm and 0 < len(cold) <= 10
    assert run(2)[:3] == (cold, warm, greedy)
    assert run(0)[:3] == (cold, warm, greedy)
    assert stats["pages_free"] + stats["pages_cached"] == stats["pages_total"]
    assert stats["kv_dtype"] == "int8" and stats["spec_tokens_per_step"] >= 1.0


def test_spec_window_never_writes_a_shared_prefix_page(setup):
    """A verify window starts at or past the prompt's end, so its K/V lands
    in the row's own pages: the shared prompt pages of a warm admission stay
    bit-equal while it speculates."""
    b = make(setup, slots=2, chunk_tokens=2, spec_k=3, spec_gram=2, kv_pages=16, page_size=16,
             prefill_chunk=16)
    try:
        prompt = [(3 * i) % 97 + 1 for i in range(37)]  # two full pages and a tail
        first = collect(b.submit(prompt, 0.0, 1.0, 12))
        shared = [pg for pg in b._prefix_map.values()]
        assert len(shared) == 2
        before = b.cache.k[:, shared].clone()
        again = collect(b.submit(prompt, 0.0, 1.0, 12))
        assert again == first and b.prefix_hits == 2
        assert torch.equal(b.cache.k[:, shared], before)
    finally:
        b.close()


def test_spec_span_reserves_the_window(setup):
    """The pool grants ``spec_k`` more positions a request than without
    speculation, so a window never runs past the row's pages."""
    needs = {}
    for spec_k in (0, 3):
        b = make(setup, slots=1, chunk_tokens=2, spec_k=spec_k, kv_pages=16, page_size=16)
        try:
            b.submit(list(range(1, 14)), 0.0, 1.0, 18)  # 13 + 18 + 1 = 32 positions
            deadline = time.time() + WAIT
            while not b._row_pages[0] and time.time() < deadline:
                time.sleep(0.005)
            needs[spec_k] = len(b._row_pages[0])
        finally:
            b.close()
    assert needs == {0: 2, 3: 3}


def test_device_mismatch_raises(setup):
    cfg, params = setup[:2]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeBatcher(params, cfg, slots=2)  # the default device is the card


def test_cancel_reclaims_slot_and_pages(setup):
    """cancel(out): an abandoned stream's slot and pages are reclaimed at
    the next scheduling point; the queue still ends with DONE."""
    b = make(setup, slots=1, chunk_tokens=2, kv_pages=8, page_size=16)
    try:
        q1 = b.submit([5, 9, 13], 0.0, 1.0, 40)
        first = q1.get(timeout=WAIT)
        assert isinstance(first, list)
        q2 = b.submit([7, 8], 0.0, 1.0, 10)  # waits behind the 1 slot
        b.cancel(q1)
        got2 = collect(q2)  # can only complete if q1's slot was freed
        drained = collect(q1)
        assert len(drained) < 40 - 1
        deadline = time.time() + 10
        while time.time() < deadline and b.stats()["pages_free"] != 7:
            time.sleep(0.05)
        assert b.stats()["pages_free"] == 7  # all but scratch reclaimed
        assert b.stats()["active"] == 0
    finally:
        b.close()
    assert got2 == solo_greedy(setup, [7, 8], 10)


def test_concurrent_submit_cancel_fuzz(setup):
    """Many threads submitting and cancelling at random: every stream ends
    with DONE, no deadlock, all slots and pages reclaimed."""
    b = make(setup, slots=2, chunk_tokens=2, kv_pages=8, page_size=16)
    results: list[bool] = []
    lock = threading.Lock()

    def one(seed):
        rng = random.Random(seed)
        q = b.submit(
            [rng.randrange(1, 200) for _ in range(rng.randrange(2, 30))],
            0.8, 0.95, rng.randrange(1, 20), seed=seed,
        )
        if rng.random() < 0.5:
            time.sleep(rng.random() * 0.1)
            b.cancel(q)
        ok = False
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                item = q.get(timeout=1.0)
            except _q.Empty:
                continue
            if item is DONE:
                ok = True
                break
            assert not isinstance(item, Exception), item
        with lock:
            results.append(ok)

    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert all(not t.is_alive() for t in threads)
        assert len(results) == 16 and all(results)
        deadline = time.time() + 15
        while time.time() < deadline and (
            b.stats()["active"] or b.stats()["pages_free"] + b.stats()["pages_cached"] != 7
        ):
            time.sleep(0.05)
        st = b.stats()
        assert st["active"] == 0 and st["queued"] == 0
        assert st["pages_free"] + st["pages_cached"] == 7, st  # free or cached
        assert not b._live and not b._cancelled
    finally:
        b.close()


def test_burst_admissions_ramp_to_full_concurrency(setup):
    """A burst of paged arrivals reaches high decode concurrency fast: the
    worker spends idle-slot capacity on staged prefills (up to min(8, idle)
    chunks per iteration) instead of one chunk per decode chunk."""
    b = make(setup, slots=8, chunk_tokens=1, eos_id=-1, kv_pages=48, page_size=8,
             prefill_chunk=8)
    peak = [0]
    orig = b._step_chunk

    def counting_step(*a, **k):
        peak[0] = max(peak[0], sum(r is not None for r in b.active))
        return orig(*a, **k)

    b._step_chunk = counting_step
    try:
        qs = [
            b.submit([(5 * i + 13 * j) % 190 + 1 for i in range(32)], 0.0, 1.0, 8, seed=j + 1)
            for j in range(8)
        ]
        outs = [collect(q) for q in qs]
    finally:
        b.close()
    assert all(len(o) == 8 for o in outs)
    assert peak[0] >= 6, f"burst only reached {peak[0]} concurrent rows"


def test_submit_after_close_raises(setup):
    b = make(setup, slots=2, chunk_tokens=2)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit([5, 9], 0.0, 1.0, 4)


def test_bucket_ladder_reaches_max_cache(setup):
    b = make(setup, slots=2, prompt_buckets=(16, 32))
    try:
        assert b.prompt_buckets == (16, 32, 64)
        long_p = [(3 * i) % 190 + 1 for i in range(45)]  # above the top bucket given
        assert collect(b.submit(long_p, 0.0, 1.0, 6)) == solo_greedy(setup, long_p, 6)
    finally:
        b.close()
