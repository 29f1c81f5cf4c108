"""The port's spans (``utils/profiling.py``): the recorder, the spans at the
layer boundaries (the fused query's stages, the query batcher's waits, the
decode worker's loop and a chat's admission, one request id across a chat
turn), and the benchmark's readers of them on synthetic runs."""

import asyncio
import threading
import time
import types
from pathlib import Path

import pytest
import torch

from outline_rag_tpu_torch.utils import profiling
from outline_rag_tpu_torch.utils.profiling import Metrics, current_request, metrics, request

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _mine(name, since, rid=None):
    return [s for s in metrics.spans(name, since) if rid is None or s.rid == rid]


# -- the recorder --------------------------------------------------------------


def test_spans_nest_and_name_their_parents_across_a_thread_and_a_to_thread_hop():
    m = Metrics()
    seen = {}

    def on_thread():
        with m.span("thread") as s:
            seen["thread"] = s

    async def main():
        with m.span("outer") as outer:
            with m.span("inner", k=1) as inner:
                pass
            t = threading.Thread(target=on_thread)
            t.start()
            t.join()

            def hop():
                with m.span("hop") as s:
                    return s

            hopped = await asyncio.to_thread(hop)
        return outer, inner, hopped

    outer, inner, hopped = asyncio.run(main())
    assert outer.parent is None and inner.parent == outer.id and inner.fields == {"k": 1}
    assert hopped.parent == outer.id and hopped.thread != outer.thread
    assert seen["thread"].parent is None  # a new thread inherits no span
    assert outer.t0 <= inner.t0 <= inner.t1 <= hopped.t0 <= hopped.t1 <= outer.t1
    assert [s.name for s in m.spans("outer")] == ["outer"] and m.recorded == 4


def test_request_ids_are_set_for_a_block_and_not_inherited_by_a_new_thread():
    m = Metrics()
    got = {}

    def on_thread():
        got["thread"] = current_request()
        with m.span("t") as s:
            got["span"] = s

    with request() as rid:
        with m.span("a") as a:
            pass
        with request(rid + 1000):
            assert current_request() == rid + 1000
        assert current_request() == rid
        t = threading.Thread(target=on_thread)
        t.start()
        t.join()
    assert current_request() is None
    assert a.rid == rid and got["thread"] is None and got["span"].rid is None
    with request() as other:
        assert other != rid


def test_spans_raises_when_the_ring_dropped_a_span_in_its_range(monkeypatch):
    monkeypatch.setattr(profiling, "RING", 4)
    m = Metrics()
    for i in range(6):
        m.add("x", float(i), float(i) + 0.5)
    assert m.recorded == 6
    assert [s.t0 for s in m.spans("x", 2.0)] == [2.0, 3.0, 4.0, 5.0]
    with pytest.raises(RuntimeError, match="dropped"):
        m.spans("x", 1.0)
    with pytest.raises(RuntimeError, match="dropped"):
        m.spans("x")


def test_spans_closed_by_many_threads_are_each_counted_once(monkeypatch):
    import sys

    monkeypatch.setattr(profiling, "RING", 500)
    m, threads, each = Metrics(), 16, 400
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def close():
            for _ in range(each):
                with m.span("x"):
                    pass

        pool = [threading.Thread(target=close) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    assert m.recorded == threads * each and len(m._ring) == 500
    assert m.snapshot()["x"]["count"] == threads * each
    assert len({s.id for s in m._ring}) == 500
    with pytest.raises(RuntimeError, match="dropped"):
        m.spans("x", m._lost_t0)  # the latest start among the dropped spans
    assert all(s.t0 > m._lost_t0 for s in m.spans("x", m._lost_t0 + 1e-9))


def test_timeit_is_a_span_that_still_feeds_the_snapshot():
    m = Metrics()
    with m.timeit("stage.a"):
        time.sleep(0.002)
    m.record("stage.b", 0.5)
    snap = m.snapshot()
    assert snap["stage.a"]["count"] == 1 and snap["stage.a"]["max_ms"] >= 2.0
    assert snap["stage.b"]["p50_ms"] == 500.0
    (s,) = m.spans("stage.a")
    assert s.fields == {} and s.t1 - s.t0 >= 0.002
    assert not hasattr(profiling, "trace") and not hasattr(m, "increment")


# -- the fused query and the query batcher --------------------------------------


@pytest.fixture(scope="module")
def service():
    from outline_rag_tpu_torch.engine import CrossEncoderReranker, EncoderEmbedder, RetrievalService
    from outline_rag_tpu_torch.index import VectorIndex
    from outline_rag_tpu_torch.models import EncoderConfig, init_encoder, init_reranker
    from outline_rag_tpu_torch.models.tokenizer import HashTokenizer

    cfg, tok = EncoderConfig.tiny(), HashTokenizer(1024)
    gen = torch.Generator().manual_seed(0)
    emb = EncoderEmbedder(init_encoder(cfg, gen, "cpu"), tok, max_tokens=64, seq_buckets=(32, 64))
    rr = CrossEncoderReranker(init_reranker(cfg, gen, "cpu"), tok, max_tokens=128)
    index = VectorIndex(dim=64, capacity=1024, dtype="int8r", device="cpu", token_width=32)
    texts = [f"chunk {i} about topic {i % 7}" for i in range(80)]
    tb = tok.batch(texts, 32, buckets=(32,))
    index.add_chunks([f"c{i}" for i in range(80)], emb.embed(texts), "s",
                     token_ids=tb.input_ids, token_mask=tb.attention_mask)
    svc = RetrievalService(index, emb, rr, top_k=12, rerank_k=3)
    assert svc.fused
    return svc


FUSED = ["fused.tokenize", "fused.encode", "fused.scan", "fused.rerank", "fused.fetch"]


def test_the_fused_query_has_one_span_a_stage_in_order_under_retrieve_fused(service):
    since = time.perf_counter()
    rows = service.retrieve_batch(["topic 1", "topic 2", "topic 3"])
    assert len(rows) == 3
    (top,) = metrics.spans("retrieve.fused", since)
    stages = [s for name in FUSED for s in metrics.spans(name, since)]
    assert [s.name for s in sorted(stages, key=lambda s: s.t0)] == FUSED
    assert all(s.parent == top.id and s.thread == top.thread for s in stages)
    assert all(top.t0 <= s.t0 <= s.t1 <= top.t1 for s in stages)
    for a, b in zip(sorted(stages, key=lambda s: s.t0), sorted(stages, key=lambda s: s.t0)[1:]):
        assert a.t1 <= b.t0


def test_every_ask_waits_under_the_batch_that_serves_it(service):
    from outline_rag_tpu_torch.engine import QueryBatcher

    since = time.perf_counter()

    async def main():
        b = QueryBatcher(service.retrieve_batch, window_ms=20, max_batch=4)
        try:
            with request() as rid:  # this ask starts the batcher: its drainer takes no id
                first = asyncio.create_task(b.retrieve("topic 0"))
            rest = [b.retrieve(f"topic {i}") for i in range(1, 7)]
            return rid, await asyncio.gather(first, *rest)
        finally:
            await b.stop()

    rid, rows = asyncio.run(main())
    assert len(rows) == 7 and all(len(r) == 3 for r in rows)
    waits = metrics.spans("batcher.wait", since)
    batches = {s.id: s for s in metrics.spans("batcher.batch", since)}
    assert len(waits) == 7 and sum(s.fields["n"] for s in batches.values()) == 7
    for w in waits:
        batch = batches[w.parent]
        assert w.rid in batch.fields["rids"] and w.t1 == batch.t0 and w.t0 <= w.t1
    assert len({w.rid for w in waits}) == 7 and rid in {w.rid for w in waits}
    assert all(s.rid is None for s in batches.values())
    fused = metrics.spans("retrieve.fused", since)
    assert sorted(s.parent for s in fused) == sorted(batches)


# -- the decode worker and a chat turn -----------------------------------------


def _decoder():
    from outline_rag_tpu_torch.models import decoder as tdec

    cfg = tdec.DecoderConfig(vocab_size=256, hidden=64, layers=2, heads=4, kv_heads=2,
                             intermediate=128, max_cache=128, dtype=torch.float32)
    return tdec.init_decoder(cfg, torch.Generator().manual_seed(5), "cpu"), cfg


def _collect(q):
    from outline_rag_tpu_torch.serve.decode_batcher import DONE

    out = []
    while True:
        item = q.get(timeout=120)
        if item is DONE:
            return out
        assert not isinstance(item, Exception), item
        out.extend(item)


WORKER = {"decode.stage", "decode.idle", "decode.launch", "decode.fetch", "decode.emit"}


def test_the_decode_workers_spans_tile_its_loop_and_each_request_is_queued_and_admitted():
    from outline_rag_tpu_torch.serve.decode_batcher import DecodeBatcher

    params, cfg = _decoder()
    since = time.perf_counter()
    b = DecodeBatcher(params, cfg, slots=2, chunk_tokens=4, eos_id=0, kv_pages=40,
                      page_size=16, prefill_chunk=16, device="cpu")
    try:
        prompt = [(7 * i) % 250 + 1 for i in range(40)]  # 40 tokens: 3 prefill chunks cold
        rids = [9_000_001 + i for i in range(4)]
        outs = [b.submit(prompt[: 36 + i], 0.0, 1.0, 10, seed=i + 1, rid=rid)
                for i, rid in enumerate(rids)]
        assert all(len(_collect(q)) > 0 for q in outs)
        time.sleep(0.25)  # a pass or two of waiting
    finally:
        b.close()
    worker = b._thread.ident
    top = sorted((s for name in WORKER for s in metrics.spans(name, since) if s.thread == worker),
                 key=lambda s: s.t0)
    assert {s.name for s in top} == WORKER
    stages = [i for i, s in enumerate(top) if s.name == "decode.stage"]
    assert len(stages) >= 4
    for i, j in zip(stages, stages[1:]):  # each pass: its spans cover it to within 1 ms
        spans = top[i:j]
        assert all(a.t1 <= c.t0 for a, c in zip(spans, spans[1:]))
        assert (top[j].t0 - top[i].t0) - sum(s.t1 - s.t0 for s in spans) < 1e-3
    for rid in rids:
        (queued,) = _mine("decode.queue", since, rid)
        (admit,) = _mine("decode.admit", since, rid)
        prefills = _mine("decode.prefill", since, rid)
        assert queued.t1 <= admit.t0 + 1e-6 and queued.fields["prompt_tokens"] >= 36
        assert admit.fields["chunks"] == len(prefills) >= 1
        assert all(p.parent == admit.id and admit.t0 <= p.t0 <= p.t1 <= admit.t1
                   for p in prefills)
        assert any(st.t0 <= p.t0 and p.t1 <= st.t1 for p in prefills for st in top
                   if st.name == "decode.stage")
        # each chunk counts the prompt's tokens it holds, not the padding
        ends = [(p.fields["start"], p.fields["start"] + p.fields["tokens"])
                for p in sorted(prefills, key=lambda p: p.fields["start"])]
        assert all(0 < e - s <= 16 for s, e in ends)
        assert all(a[1] == b[0] for a, b in zip(ends, ends[1:]))
        assert ends[-1][1] == queued.fields["prompt_tokens"]
    # the later requests share the first's full prompt pages
    assert max(_mine("decode.admit", since, r)[0].fields["shared_pages"] for r in rids) >= 2
    launches = [s for s in top if s.name == "decode.launch"]
    assert all(s.fields["steps"] == 4 and 1 <= s.fields["rows"] <= 2 for s in launches)


def test_a_chat_turn_carries_one_request_id_from_retrieval_to_admission():
    from outline_rag_tpu_torch.engine import QueryBatcher
    from outline_rag_tpu_torch.serve.llm import LocalChatProvider

    class Tok:
        eos_token_id = 0

        def encode(self, text):
            return [(ord(c) % 250) + 1 for c in text]

        def decode(self, ids, skip_special_tokens=True):
            return "".join(chr(97 + i % 26) for i in ids)

    params, cfg = _decoder()
    provider = LocalChatProvider(params, cfg, Tok(), eos_id=0, chunk_tokens=4, max_new_tokens=6,
                                 batch_slots=2, kv_pages=40, page_size=16, device="cpu")
    since = time.perf_counter()

    async def turn():
        batcher = QueryBatcher(lambda qs: [[q] for q in qs], window_ms=1)
        try:
            with request() as rid:
                await batcher.retrieve("what is a wolf")
                parts = [d["content"] async for d in provider.stream(
                    "local", [{"role": "user", "content": "tell me about wolves " * 3}],
                    temperature=0.0)]
                await provider.complete("local", [{"role": "user", "content": "classify"}])
            return rid, parts
        finally:
            await batcher.stop()

    try:
        rid, parts = asyncio.run(turn())
    finally:
        provider.close()
    assert parts
    assert len(_mine("batcher.wait", since, rid)) == 1
    assert len(_mine("decode.queue", since, rid)) == 2  # the stream's and complete()'s
    assert len(_mine("decode.admit", since, rid)) == 2
    assert len(_mine("decode.prefill", since, rid)) >= 2


def test_the_ask_routes_frames_are_produced_under_its_request_id():
    from outline_rag_tpu_torch.serve.app import _InRequest

    async def frames():
        for _ in range(3):
            await asyncio.sleep(0)
            yield current_request()

    async def main():
        body = _InRequest(41, frames())
        got = [f async for f in body]
        await body.aclose()
        return got, current_request()

    assert asyncio.run(main()) == ([41, 41, 41], None)


# -- the benchmark's readers of the spans ---------------------------------------


def _reader(name):
    from portbench.harness import load_module

    return load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


def _run(m, monkeypatch, device="cuda"):
    """A window [100, 110) s with the profiler's sub-window at [104, 105] s,
    its clock anchored so host time 104 s is 0 us; the device ran [0, 100],
    [300, 400] and [900, 1000] us of its first millisecond, then nothing
    until its end (idle: 200 + 500 + 999,000 us)."""
    from portbench.devtrace import Op, Profile

    monkeypatch.setattr(profiling, "metrics", m)
    profile = Profile(window_us=1e6, start_us=0.0, ranges=[], anchor_us=0.0, anchor_host=104.0,
                      device=[Op("k", 0, 100), Op("k", 300, 400), Op("k", 900, 1000)])
    return types.SimpleNamespace(w0=100.0, w1=110.0, traced=(104.0, 105.0), profile=profile,
                                 device=types.SimpleNamespace(type=device))


def _spans_ask(m):
    for t0, ms in ((101.0, 10), (102.0, 20), (103.0, 30), (99.0, 500), (104.5, 900)):
        m.add("batcher.wait", t0, t0 + ms / 1e3)  # before the window, in the sub-window: out
    # a batch open over [200, 500] us of the sub-window covers 200 us of idle time
    m.add("batcher.batch", 104.0002, 104.0005)


def _spans_chat(m):
    for i in range(21):
        m.add("decode.queue", 101.0 + i * 0.01, 101.0 + i * 0.01 + i / 1e3)
        m.add("decode.admit", 102.0 + i * 0.01, 102.0 + i * 0.01 + 2 * i / 1e3)
    m.add("decode.queue", 104.5, 104.6)
    # two passes: stage 10 ms holding a 6-ms prefill chunk, emit 2 ms; stage 3 ms, emit 1 ms
    m.add("decode.stage", 101.0, 101.010)
    m.add("decode.prefill", 101.002, 101.008)
    m.add("decode.emit", 101.5, 101.502)
    m.add("decode.stage", 102.0, 102.003)
    m.add("decode.emit", 102.5, 102.501)
    # the worker's chunks cover [200, 500] us of the sub-window
    m.add("decode.launch", 104.0002, 104.0004)
    m.add("decode.prefill", 104.0004, 104.0005)


READERS = [
    ("ask_queue_ms.ask", _spans_ask, 20.0),
    ("idle_outside_batches_pct.ask", _spans_ask, 100.0 * (999_700 - 200) / 999_700),
    ("admit_wait_p95_ms", _spans_chat, 19.0),
    ("admission_p95_ms", _spans_chat, 38.0),
    ("worker_sched_ms", _spans_chat, (4 + 2 + 3 + 1) / 2),
    ("idle_between_chunks_pct.chat", _spans_chat, 100.0 * (999_700 - 200) / 999_700),
]


@pytest.mark.parametrize("name,fill,want", READERS, ids=[r[0] for r in READERS])
def test_a_span_reader_gives_its_known_answer(monkeypatch, name, fill, want):
    m = Metrics()
    fill(m)
    assert _reader(name).read(_run(m, monkeypatch)) == pytest.approx(want)


@pytest.mark.parametrize("name", [r[0] for r in READERS])
def test_a_span_reader_raises_without_spans_and_is_silent_on_a_port_without_them(
        monkeypatch, name):
    read = _reader(name).read
    with pytest.raises(RuntimeError):
        read(_run(Metrics(), monkeypatch))
    assert read(_run(types.SimpleNamespace(), monkeypatch)) is None  # no span API


@pytest.mark.parametrize("name", ["idle_outside_batches_pct.ask", "idle_between_chunks_pct.chat"])
def test_idle_readers_read_zero_when_the_device_never_idles(monkeypatch, name):
    from portbench.devtrace import Op

    m = Metrics()
    _spans_ask(m)
    _spans_chat(m)
    run = _run(m, monkeypatch)
    run.profile.device = [Op("k", -10.0, 2e6)]
    assert _reader(name).read(run) == 0.0


@pytest.mark.parametrize("name", ["idle_outside_batches_pct.ask", "idle_between_chunks_pct.chat"])
def test_device_readers_give_nothing_without_a_card(monkeypatch, name):
    m = Metrics()
    _spans_ask(m)
    _spans_chat(m)
    assert _reader(name).read(_run(m, monkeypatch, device="cpu")) is None


# -- the idle arithmetic the idle readers share ---------------------------------


IDLE = [  # ranges (us), idle time covered by them; the synthetic run idles 999,700 us
    ([], 0.0),
    ([(200.0, 500.0)], 200.0),
    ([(150.0, 250.0), (200.0, 350.0), (850.0, 950.0)], 150.0 + 50.0),
    ([(-50.0, 2e6)], 999_700.0),
    ([(0.0, 100.0), (300.0, 400.0)], 0.0),
]


@pytest.mark.parametrize("ranges,covered", IDLE, ids=[str(i) for i in range(len(IDLE))])
def test_idle_outside_ranges_gives_its_known_answer(monkeypatch, ranges, covered):
    from portbench import idle

    p = _run(Metrics(), monkeypatch).profile
    assert idle.gaps(p) == [(100, 300), (400, 900), (1000, 1e6)]
    total, out = idle.outside(p, ranges)
    assert total == pytest.approx(999_700.0) and out == pytest.approx(999_700.0 - covered)


def test_idle_gaps_keep_to_the_sub_window_and_merge_joins_overlaps():
    from portbench import idle
    from portbench.devtrace import Op, Profile

    p = Profile(window_us=1000.0, start_us=100.0, ranges=[],
                device=[Op("k", 0, 150), Op("k", 120, 180), Op("k", 500, 600), Op("k", 1050, 1300),
                        Op("k", 1400, 1500)])
    assert idle.gaps(p) == [(180, 500), (600, 1050)]
    assert idle.merge([(5, 6), (1, 3), (2, 4), (4, 4.5)]) == [[1, 4.5], [5, 6]]
