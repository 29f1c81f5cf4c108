"""Open-loop asks: retrieval questions sent on a schedule, answered by
``QueryBatcher.retrieve`` over the fused retrieval service.

The mix file sets ``rate_per_s`` (asks a second), ``question_words``
([shortest, longest]), ``lead_s`` (seconds of the same traffic before the
window, so it opens on a queue in its steady state) and ``sample`` (asks the
reference checks). Every seed gets the same set of gaps and question lengths
in another order: the gaps are the exponential distribution's quantiles at
``(i + 1/2) / n`` scaled to fill the window, so the arrivals are Poisson in
shape and the offered load is the same in every run. Each ask is timed from
when it was due, so a stall delays every ask behind it.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from portbench import correct
from portbench.weights import sub_seed
from portbench.words import draw_words


def needs(mix: dict) -> tuple:
    return ("retrieval",)


def schedule(mix: dict, seed: int, seconds: float) -> tuple[np.ndarray, list[str]]:
    """Due times (seconds from the window's start; the lead-in is negative)
    and the distinct questions."""
    rng = np.random.default_rng(sub_seed(seed, "asks"))
    rate, lead = float(mix["rate_per_s"]), float(mix["lead_s"])
    span = lead + seconds
    n = max(1, round(rate * span))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= span / gaps.sum()
    rng.shuffle(gaps)
    due = np.cumsum(gaps) - gaps[0] - lead
    lo, hi = mix["question_words"]
    lengths = lo + (np.arange(n) * (hi - lo + 1)) // n
    rng.shuffle(lengths)
    seen, questions = set(), []
    for n_words in lengths:
        q = draw_words(rng, int(n_words), 0, 250_000)
        while q in seen:
            q = draw_words(rng, int(n_words), 0, 250_000)
        seen.add(q)
        questions.append(q)
    return due, questions


async def drive(run, stack) -> None:
    retrieval = stack.retrieval
    mix = run.mix
    await retrieval.warm(np.random.default_rng(sub_seed(run.seed, "warm")))
    due, questions = schedule(mix, run.seed, run.seconds)
    batcher = retrieval.batcher()
    await batcher.start()
    records = [{"kind": "ask", "q": q, "due": float(d)} for q, d in zip(questions, due)]

    async def one(r):
        r["sent"] = time.perf_counter()
        try:
            res = await batcher.retrieve(r["q"])
            r["result"] = [(c.chunk_id, c.score, c.rerank_score) for c in res]
        except Exception as exc:  # noqa: BLE001 — counted as failed
            r["error"] = repr(exc)
        r["done"] = time.perf_counter()

    # the lead-in runs before the window; the window opens at due time 0
    t_lead = time.perf_counter() - float(due[0])
    tasks, opened = [], False
    for r in records:
        if r["due"] >= 0 and not opened:
            w0 = await run.open_window()
            t_lead, opened = w0, True
        r["start"] = t_lead + r["due"]
        delay = r["start"] - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.create_task(one(r)))
    if not opened:
        await run.open_window()
    await asyncio.sleep(max(0.0, run.w1 - time.perf_counter()))
    await asyncio.wait(tasks, timeout=run.w1 + run.drain_s - time.perf_counter())
    await batcher.stop()
    for r in records:
        r["late_s"] = r["sent"] - r["start"] if "sent" in r else None
    run.records = records
    run.info["rerank_events"] = retrieval.rerank_events


def check(run, control=None) -> list[dict]:
    """The ask cell's numbers against the reference, on a sample of the
    asks answered in the window."""
    return correct.check_asks(run, sample_asks(run), control)


def sample_asks(run) -> list[dict]:
    rng = np.random.default_rng(sub_seed(run.seed, "sample"))
    done = [r for r in run.in_window("ask") if r.get("result")]
    k = min(int(run.mix["sample"]), len(done))
    return [done[i] for i in sorted(rng.choice(len(done), k, replace=False))] if k else []


def controlled(run, stack) -> dict:
    """The same sampled asks through the configuration's lower precision:
    the port's w8a8 trunks (``ENCODER_INT8``) in the encoder and the
    cross-encoder."""
    from outline_rag_tpu_torch.models.encoder import quantize_encoder_

    r = stack.retrieval
    quantize_encoder_(r.embedder.encoder)
    quantize_encoder_(r.cross.model.encoder)
    asks = sample_asks(run)
    out = {}
    step = r.cfg["retrieval"]["batch_max"]
    for s in range(0, len(asks), step):
        part = asks[s : s + step]
        got = r.service.retrieve_batch([a["q"] for a in part])
        for a, res in zip(part, got):
            out[a["q"]] = [(c.chunk_id, c.score, c.rerank_score) for c in res]
    return out
