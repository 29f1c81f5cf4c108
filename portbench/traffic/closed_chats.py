"""Closed-loop chats: ``sessions`` clients, each sending its next chat when
the last one has ended, through ``LocalChatProvider.stream``; with
``retrieve`` each chat first asks ``QueryBatcher.retrieve`` and quotes the
reranked chunks, as the app's RAG route does.

The mix file sets ``sessions``, ``retrieve``, ``system_tokens`` (a system
prompt every chat shares), ``question_words`` and ``answer_tokens``
([shortest, longest]), ``answer_median`` (answers are lognormal with
``answer_sigma``, clipped to the range), ``chunk_words`` (the words of a
quoted chunk, [shortest, longest]), ``greedy_every`` (every n-th chat is
greedy, the others sample at ``temperature`` and ``top_p``), ``ramp_s``
(sessions start evenly over this many seconds before the window) and
``sample`` (greedy chats the reference checks, the longest among them) and,
with retrieval, ``retrieval_sample`` (chats whose retrieved chunks it checks).

A chat ends after its drawn number of tokens, as an end-of-sequence token
would end it. Every seed gets the same sets of question and answer lengths
in another order. A chat is timed from when it was sent (before its
retrieval) to its first content delta; the tokens of every delta that
arrives in the window count toward the window's rate.
"""

from __future__ import annotations

import asyncio
import itertools
import time

import numpy as np

from portbench import correct
from portbench.weights import sub_seed
from portbench.words import draw_words

POOL = 512  # sizes in the set every seed shares


def needs(mix: dict) -> tuple:
    return ("decoder", "retrieval") if mix["retrieve"] else ("decoder",)


def sizes(mix: dict, seed: int) -> tuple[list[int], list[int]]:
    """``POOL`` question lengths and answer lengths, the same set for
    every seed, in the seed's order."""
    rng = np.random.default_rng(sub_seed(seed, "sizes"))
    lo, hi = mix["question_words"]
    q = lo + (np.arange(POOL) * (hi - lo + 1)) // POOL
    u = (np.arange(POOL) + 0.5) / POOL
    from statistics import NormalDist

    z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
    a_lo, a_hi = mix["answer_tokens"]
    a = np.clip(np.round(mix["answer_median"] * np.exp(mix["answer_sigma"] * z)), a_lo, a_hi)
    rng.shuffle(q)
    rng.shuffle(a)
    return [int(x) for x in q], [int(x) for x in a]


def chunk_text(seed: int, row: int, words: list[int], vocab: int) -> str:
    """The text of the chunk at ``row``: its own words, from the seed."""
    rng = np.random.default_rng(sub_seed(seed, "chunk", row))
    return draw_words(rng, int(rng.integers(words[0], words[1] + 1)), 0, vocab)


def chat(mix: dict, seed: int, i: int, sizes_, vocab: int) -> dict:
    q_len, a_len = sizes_[0][i % POOL], sizes_[1][i % POOL]
    rng = np.random.default_rng(sub_seed(seed, "chat", i))
    greedy = i % int(mix["greedy_every"]) == 0
    return {"kind": "chat", "i": i, "question": draw_words(rng, q_len, 0, vocab),
            "max_new": a_len, "greedy": greedy}


async def drive(run, stack) -> None:
    from outline_rag_tpu_torch.serve.chat import format_context

    mix, dec = run.mix, stack.decoder
    vocab = dec.cfg["vocab_size"]
    system = draw_words(np.random.default_rng(sub_seed(run.seed, "system")),
                        int(mix["system_tokens"]), 0, vocab)
    sizes_ = sizes(mix, run.seed)
    retrieval = stack.retrieval
    batcher = retrieval.batcher() if retrieval is not None else None
    if batcher is not None:
        await batcher.start()
    counter = itertools.count()
    records: list[dict] = []
    stop = asyncio.Event()

    async def one(r: dict) -> None:
        r["sent"] = r["start"] = time.perf_counter()
        messages_system = system
        if batcher is not None:
            res = await batcher.retrieve(r["question"])
            r["retrieved"] = time.perf_counter()
            r["result"] = [(c.chunk_id, c.score, c.rerank_score) for c in res]
            docs = [{"source_id": cid, "title": f"page {cid}", "url": f"/doc/{cid}",
                     "text": chunk_text(run.seed, int(cid[1:]), mix["chunk_words"], vocab)}
                    for cid, _, _ in r["result"]]
            context, _ = format_context(docs)
            messages_system = system + "\n\n" + context
        r["messages"] = [{"role": "system", "content": messages_system},
                         {"role": "user", "content": r["question"]}]
        temp = 0.0 if r["greedy"] else float(mix["temperature"])
        parts, r["pieces"] = [], []
        async for delta in dec.answering(r["max_new"]).stream(
                "local", r["messages"], temperature=temp, top_p=float(mix["top_p"])):
            now = time.perf_counter()
            if "first" not in r:
                r["first"] = now
            parts.append(delta["content"])
            r["pieces"].append((now, len(delta["content"].split())))
        r["text"] = "".join(parts)
        r["done"] = time.perf_counter()

    async def session(k: int, begin: float) -> None:
        await asyncio.sleep(max(0.0, begin - time.perf_counter()))
        while not stop.is_set():
            r = chat(mix, run.seed, next(counter), sizes_, vocab)
            records.append(r)
            try:
                await one(r)
            except Exception as exc:  # noqa: BLE001 — counted as failed
                r["error"] = repr(exc)
                r.setdefault("start", time.perf_counter())
                return

    await warm(dec, system, mix, run.seed, vocab, retrieval)
    if run.device.type == "cuda":
        import torch

        await asyncio.to_thread(torch.cuda.synchronize, run.device)
    t0 = time.perf_counter()
    n = int(mix["sessions"])
    ramp = float(mix["ramp_s"])
    tasks = [asyncio.create_task(session(k, t0 + ramp * k / n)) for k in range(n)]
    await asyncio.sleep(max(0.0, t0 + ramp - time.perf_counter()))
    await run.open_window()
    run.info["stats0"] = dec.provider.stats()
    await asyncio.sleep(max(0.0, run.w1 - time.perf_counter()))
    run.info["stats1"] = dec.provider.stats()
    stop.set()
    await asyncio.wait(tasks, timeout=run.w1 + run.drain_s - time.perf_counter())
    if batcher is not None:
        await batcher.stop()
    run.records = records
    run.info["encoded"] = list(dec.tokenizer.encoded)
    run.info["page_size"] = dec.cfg["serving"]["page_size"]


async def warm(dec, system: str, mix: dict, seed: int, vocab: int, retrieval) -> None:
    """A few short chats at the cell's prompt lengths (the prefill chunk,
    the decode chunk, sampling both ways) and, with retrieval, every batch
    size the query batcher can form."""
    rng = np.random.default_rng(sub_seed(seed, "warm"))
    if retrieval is not None:
        await retrieval.warm(rng)
    pad = draw_words(rng, 900 if mix["retrieve"] else 40, 0, vocab)
    for temp in (0.0, float(mix["temperature"])):
        msgs = [{"role": "system", "content": system + " " + pad},
                {"role": "user", "content": draw_words(rng, 20, 0, vocab)}]
        async for _ in dec.answering(40).stream("local", msgs, temperature=temp,
                                                top_p=float(mix["top_p"])):
            pass


def sample_chats(run) -> list[dict]:
    """Greedy chats sent in the window and answered in full: the longest
    answer and a draw from the seed."""
    done = [r for r in run.in_window("chat")
            if r["greedy"] and r.get("done") is not None and not r.get("error")]
    if not done:
        return []
    k = min(int(run.mix["sample"]), len(done))
    longest = max(range(len(done)), key=lambda i: len(done[i]["text"].split()))
    rng = np.random.default_rng(sub_seed(run.seed, "sample"))
    rest = [i for i in range(len(done)) if i != longest]
    picked = [longest] + sorted(rng.choice(rest, min(k - 1, len(rest)), replace=False).tolist())
    return [done[i] for i in picked]


def sample_retrievals(run) -> list[dict]:
    """Chats sent in the window whose retrieval answered, ``retrieval_sample``
    of them drawn from the seed: the asks whose chunks the reference checks."""
    done = [r for r in run.in_window("chat") if r.get("result") is not None]
    k = min(int(run.mix["retrieval_sample"]), len(done))
    rng = np.random.default_rng(sub_seed(run.seed, "sample_retrieval"))
    return [done[i] for i in sorted(rng.choice(len(done), k, replace=False))] if k else []


def check(run, control=None) -> list[dict]:
    out = correct.check_chats(run, sample_chats(run), control)
    if run.mix["retrieve"]:
        asks = [{"q": r["question"], "result": r["result"]} for r in sample_retrievals(run)]
        out += correct.check_asks(run, asks, control and control.get("asks"))
    return out


def controlled(run, stack) -> dict:
    """The configuration's lower precision on the sampled chats: the
    architecture's ``quantize``d weights, made once, in its ``lower`` over
    each prompt with its served tokens, and the first token it puts at each
    position; with retrieval, the sampled questions through the w8a8
    trunks."""
    import torch

    from outline_rag_tpu_torch.serve.llm import LocalChatProvider

    dec = stack.decoder
    qparams = run.arch.quantize(dec.provider.params)
    tok = dec.tokenizer
    out = {"tokens": {}}
    with torch.inference_mode():
        for r in sample_chats(run):
            ids = tok.encode(LocalChatProvider._render(dec.provider, r["messages"]))
            ids += tok.encode(r["text"])
            x = torch.tensor(ids, dtype=torch.int32, device=run.device)
            out["tokens"][r["i"]] = run.arch.lower(qparams, dec.model_cfg, x).argmax(-1).tolist()
    if run.mix["retrieve"]:
        from outline_rag_tpu_torch.models.encoder import quantize_encoder_

        ret = stack.retrieval
        quantize_encoder_(ret.embedder.encoder)
        quantize_encoder_(ret.cross.model.encoder)
        questions = [r["question"] for r in sample_retrievals(run)]
        step = ret.cfg["retrieval"]["batch_max"]
        out["asks"] = {}
        for s in range(0, len(questions), step):
            part = questions[s : s + step]
            for q, res in zip(part, ret.service.retrieve_batch(part)):
                out["asks"][q] = [(c.chunk_id, c.score, c.rerank_score) for c in res]
    return out
