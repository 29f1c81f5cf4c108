"""Prompt-lookup speculative decoding in the port
(``outline_rag_tpu_torch.models.decoder.propose_ngram`` /
``generate_chunk_spec``), tiny f32 decoder on the CPU.

``propose_ngram`` is integer code and is held equal to the JAX package's.
Greedy ``generate_chunk_spec`` is held to the JAX package's token for token
(logits agree to 1e-4 and greedy picks are far apart on this model). The
port's sampler draws other numbers than ``jax.random``, so sampled streams
are held to the port's own contract: the speculative loop emits exactly the
tokens of the plain positional loop (one token a forward, position q drawn
with ``key_at(base, q)``), whatever was accepted on the way."""

import dataclasses

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
    paged_kv_from_jax,
)

TABLE = np.array([[3, 5, 1, 7], [2, 4, 6, 8], [9, 10, 11, 12]], np.int32)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    jcfg = jdec.DecoderConfig.tiny()
    jparams = jdec.stack_decoder_params(jdec.init_decoder_params(jax.random.key(0), jcfg))
    cfg = decoder_config_from_jax(jcfg)
    return jcfg, jparams, cfg, decoder_from_jax(to_np(jparams), cfg, device="cpu")


def planted_buffers():
    """[B, C] buffers and positions: rows with the gram repeated twice (the
    later match wins), repeated once, never, ending at the edge of the known
    region, and sitting at position 1 (shorter than the gram)."""
    rng = np.random.default_rng(0)
    c = 64
    buf = rng.integers(100, 200, (6, c)).astype(np.int32)  # 100 values: grams of 3 rarely repeat
    pos = np.array([40, 40, 40, 12, 1, 57], np.int32)
    gram = [7, 8, 9]
    buf[0, 5:8] = gram; buf[0, 20:23] = gram; buf[0, 38:41] = gram   # two earlier matches
    buf[1, 10:13] = gram; buf[1, 38:41] = gram                        # one
    buf[2] = np.arange(c) + 300                                       # none
    buf[3, 7:10] = gram; buf[3, 10:13] = gram                         # the match ends where the suffix starts
    buf[4, :2] = [5, 5]                                               # pos < gram - 1
    buf[5, 30:33] = gram; buf[5, 55:58] = gram                        # the draft runs to the end of the buffer
    return buf, pos


@pytest.mark.parametrize("gram,k", [(3, 3), (2, 4), (3, 1), (1, 2)])
def test_propose_ngram_equals_jax(gram, k):
    buf, pos = planted_buffers()
    want = np.asarray(jdec.propose_ngram(jnp.asarray(buf), jnp.asarray(pos), gram=gram, k=k))
    got = tdec.propose_ngram(torch.from_numpy(buf), torch.from_numpy(pos), gram=gram, k=k)
    assert got.dtype == torch.int32 and tuple(got.shape) == (6, k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_propose_ngram_takes_the_latest_match():
    buf, pos = planted_buffers()
    got = tdec.propose_ngram(torch.from_numpy(buf), torch.from_numpy(pos), gram=3, k=3).numpy()
    np.testing.assert_array_equal(got[0], buf[0, 23:26])  # after the match at 20, not at 5
    np.testing.assert_array_equal(got[1], buf[1, 13:16])
    np.testing.assert_array_equal(got[2], buf[2, 0:3])  # no match: slot 0 onwards
    np.testing.assert_array_equal(got[3], buf[3, 10:13])


def prefill_both(model, kind, toks):
    jcfg, jparams, cfg, params = model
    b = toks.shape[0]
    if kind == "ring":
        jcache = jdec.init_cache(jcfg, b)
        tcache = tdec.init_cache(cfg, b, "cpu")
    else:
        jcache = jdec.init_paged_cache(jcfg, b, 13, 16, kv_dtype="int8" if kind == "paged_int8" else None)
        jcache = dataclasses.replace(jcache, table=jnp.asarray(TABLE[:b]))
        tcache = paged_kv_from_jax(to_np(jcache), device="cpu")
    jl, jcache = jdec.decoder_forward(jparams, jnp.asarray(toks), jcache, jnp.zeros((b,), jnp.int32), jcfg)
    with torch.inference_mode():
        tl, tcache = tdec.decoder_forward(params, torch.from_numpy(toks.copy()), tcache,
                                          torch.zeros(b, dtype=torch.int32), cfg)
    first = np.array(jnp.argmax(jl[:, -1], -1), np.int32)  # a writable copy
    assert first.tolist() == tl[:, -1].argmax(-1).tolist()
    return jcache, tcache, first


def prompt(b=2, t=9, seed=0):
    toks = np.random.default_rng(seed).integers(1, 256, (b, t)).astype(np.int32)
    toks[:, 5:8] = toks[:, 1:4]  # a repeated gram in the prompt
    return toks


def token_buffer(cfg, toks):
    buf = np.zeros((toks.shape[0], cfg.max_cache), np.int32)
    buf[:, : toks.shape[1]] = toks
    return buf


@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_greedy_generate_chunk_spec_equals_jax_token_for_token(model, kind):
    jcfg, jparams, cfg, params = model
    toks = prompt(seed=2)  # this model's greedy stream from here soon repeats itself
    jcache, tcache, first = prefill_both(model, kind, toks)
    buf = token_buffer(cfg, toks)
    t = toks.shape[1]
    want = jdec.generate_chunk_spec(
        jparams, jcache, jnp.asarray(buf), jnp.asarray(first), jnp.full((2,), t, jnp.int32),
        jax.random.key(1), jcfg, n_steps=12, draft_k=3, gram=2, temperature=0.0, top_p=1.0, eos_id=-1)
    with torch.inference_mode():
        got = tdec.generate_chunk_spec(
            params, tcache, torch.from_numpy(buf.copy()), torch.from_numpy(first.copy()),
            torch.full((2,), t, dtype=torch.int32), tdec.make_key(1, "cpu"), cfg, n_steps=12, draft_k=3,
            gram=2, temperature=0.0, top_p=1.0, eos_id=-1)
    w_out, w_cnt, w_buf, w_tok, w_pos = (np.asarray(want[i]) for i in (0, 1, 3, 4, 5))
    out, cnt, _, tbuf, tok, pos = got
    assert cnt.tolist() == w_cnt.tolist() and tok.tolist() == w_tok.tolist()
    assert pos.tolist() == w_pos.tolist()
    for r in range(2):
        assert out[r, : cnt[r]].tolist() == w_out[r, : w_cnt[r]].tolist()
        assert tbuf[r, : int(pos[r])].tolist() == w_buf[r, : int(w_pos[r])].tolist()
    assert int(cnt.max()) > 12  # drafts were accepted


def plain_positional(params, cfg, cache, first, pos, base, n, temperature, top_p):
    """One token a forward; the token for position q drawn with key_at(base, q)."""
    tok = torch.as_tensor(first, dtype=torch.int32)
    pos = torch.as_tensor(pos, dtype=torch.int32)
    out = []
    with torch.inference_mode():
        for _ in range(n):
            logits, cache = tdec.decoder_forward(params, tok[:, None], cache, pos, cfg)
            tok = tdec.sample_token(logits[:, -1], tdec.key_at(base, pos.long() + 1), temperature, top_p)
            pos = pos + 1
            out.append(tok)
    return torch.stack(out, dim=1)


def spec_stream(params, cfg, cache, buf, first, pos, key, n_steps, **kw):
    with torch.inference_mode():
        out, cnt, _, buf, tok, pos = tdec.generate_chunk_spec(
            params, cache, buf, torch.as_tensor(np.array(first), dtype=torch.int32),
            torch.as_tensor(pos, dtype=torch.int32), key, cfg, n_steps=n_steps, **kw)
    return [out[r, : cnt[r]].tolist() for r in range(out.shape[0])], cnt, buf, tok, pos


@pytest.mark.parametrize("kind", ["ring", "paged", "paged_int8"])
@pytest.mark.parametrize("temperature,top_p", [(0.0, 1.0), (0.9, 0.95)], ids=["greedy", "sampled"])
def test_spec_equals_plain_positional_loop(model, kind, temperature, top_p):
    """Rows diverge (other prompts, seeds and acceptance counts); every row's
    stream is the plain loop's."""
    _, _, cfg, params = model
    toks = prompt(b=3, seed=4)
    _, cache_a, first = prefill_both(model, kind, toks)
    _, cache_b, _ = prefill_both(model, kind, toks)
    seeds = torch.tensor([11, 12, 13])
    key0 = torch.zeros((), dtype=torch.int64)
    want = plain_positional(params, cfg, cache_a, first, [9, 9, 9], tdec.make_key(seeds, "cpu"), 40,
                            temperature, top_p)
    got, cnt, *_ = spec_stream(params, cfg, cache_b, torch.from_numpy(token_buffer(cfg, toks)),
                               first, [9, 9, 9], key0, 10, draft_k=3, gram=2, seeds=seeds,
                               temperature=temperature, top_p=top_p, eos_id=-1)
    for r in range(3):
        assert 10 <= len(got[r]) <= 40
        assert got[r] == want[r, : len(got[r])].tolist()
    if temperature == 0.0:
        assert int(cnt.max()) > 10 and len(set(cnt.tolist())) > 1  # accepted, and not in step


def test_spec_single_stream_key_convention(model):
    """Without seeds the base key is the key itself: key_at(key, q)."""
    _, _, cfg, params = model
    toks = prompt(b=1, seed=6)
    _, cache_a, first = prefill_both(model, "ring", toks)
    _, cache_b, _ = prefill_both(model, "ring", toks)
    key = tdec.make_key(5, "cpu")
    want = plain_positional(params, cfg, cache_a, first, [9], key.reshape(1), 24, 1.1, 0.9)
    got, *_ = spec_stream(params, cfg, cache_b, torch.from_numpy(token_buffer(cfg, toks)), first,
                          [9], key, 8, draft_k=2, gram=2, temperature=1.1, top_p=0.9, eos_id=-1)
    assert got[0] == want[0, : len(got[0])].tolist() and len(got[0]) >= 8


def test_spec_truncates_at_an_eos_inside_an_accepted_run(model):
    """With every draft accepted a step emits 4 samples; an eos that is the
    third of them ends the row there (inclusive), the fourth is dropped, the
    row freezes on eos, and its neighbour goes on."""
    _, _, cfg, params = model
    toks = prompt(b=2, seed=0)
    kw = dict(draft_k=3, gram=2, temperature=0.0, top_p=1.0, force_accept=True)
    _, cache, first = prefill_both(model, "ring", toks)
    free, *_ = spec_stream(params, cfg, cache, torch.from_numpy(token_buffer(cfg, toks)),
                           first, [9, 9], tdec.make_key(1, "cpu"), 3, eos_id=-1, **kw)
    assert [len(x) for x in free] == [12, 12]
    at = next(i for i in (2, 1, 3) if free[0][i] not in free[0][:i])  # inside the first run
    eos = free[0][at]
    _, cache2, _ = prefill_both(model, "ring", toks)
    got, cnt, _, tok, pos = spec_stream(
        params, cfg, cache2, torch.from_numpy(token_buffer(cfg, toks)), first, [9, 9],
        tdec.make_key(1, "cpu"), 3, eos_id=eos, **kw)
    assert got[0] == free[0][: at + 1] and int(cnt[0]) == at + 1
    assert int(tok[0]) == eos and int(pos[0]) == 9 + at + 1
    stop1 = free[1].index(eos) + 1 if eos in free[1] else 12
    assert got[1] == free[1][:stop1]


def test_spec_capacity_guard_freezes_a_row(model):
    """A row whose window would pass the cache's end emits nothing more (count
    0 for the step), its neighbour goes on, and the clamped window never
    writes over the row's last fed token."""
    _, _, cfg, params = model
    c = cfg.max_cache
    toks = prompt(b=2, seed=2)
    _, cache, first = prefill_both(model, "ring", toks)
    buf = torch.from_numpy(token_buffer(cfg, toks))
    pos = [c - 5, 9]  # row 0: room for one window of 4 (slots c-5 .. c-2), then none
    got, _, buf, tok, pos2 = spec_stream(params, cfg, cache, buf, first, pos, tdec.make_key(3, "cpu"), 4,
                                           draft_k=3, gram=2, temperature=0.0, top_p=1.0, eos_id=-1)
    assert 1 <= len(got[0]) <= 4 and len(got[1]) >= 4
    assert int(pos2[0]) == c - 5 + len(got[0])
    frozen_at = int(pos2[0])
    if frozen_at + 4 > c:  # the guard tripped: a further chunk emits nothing for row 0
        more, cnt2, *_ = spec_stream(params, cfg, cache, buf, tok, pos2, tdec.make_key(3, "cpu"), 2,
                                     draft_k=3, gram=2, temperature=0.0, top_p=1.0, eos_id=-1)
        assert more[0] == [] and int(cnt2[0]) == 0 and len(more[1]) >= 2


def test_spec_done_rows_are_skipped_and_force_accept_takes_every_draft(model):
    _, _, cfg, params = model
    toks = prompt(b=2, seed=3)
    _, cache, first = prefill_both(model, "ring", toks)
    buf = torch.from_numpy(token_buffer(cfg, toks))
    got, cnt, _, tok, pos = spec_stream(
        params, cfg, cache, buf, first, [9, 9], tdec.make_key(0, "cpu"), 3, draft_k=3, gram=2,
        temperature=0.0, top_p=1.0, eos_id=-1, done0=torch.tensor([False, True]),
        force_accept=True)
    assert cnt.tolist() == [12, 0] and got[1] == []  # 3 steps x (3 drafts + 1)
    assert int(tok[1]) == int(first[1]) and pos.tolist() == [21, 9]
