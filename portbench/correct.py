"""The comparisons that decide ``correct``: what the timed path served,
against the plain references in ``portbench/reference/``, on the same inputs
made again from the seed. Each function computes several numbers; a
configuration compares those its ``correct.limits`` name, and the others are
reported by ``portbench/control.py`` only.

Asks (``check_asks``), over a sample of the asks answered in the window:

- ``dense_gap`` / ``dense_mean``: the largest / mean distance between a
  served chunk's retrieval score and the reference's f32 cosine of the same
  query and row (the query encoder, the int8r scan's exact rescore);
- ``rerank_gap`` / ``rerank_mean`` / ``rerank_p50``: the largest / mean /
  median distance between a served chunk's cross-encoder score and the
  reference's score of the same pair, over the sample's median spread of
  reference scores among an ask's exact top-k (the scale on which the
  ranking is decided);
- ``rank_gap``: the largest amount, on that scale, by which the reference's
  score of the chunk served at rank j lies below the reference's own j-th
  best among its exact top-k; ``rank_miss``: the share of ranks served with
  another chunk than the reference's.

Chats (``check_chats``), over a sample of greedy chats answered in the
window with the longest among them, the reference of the configuration's
architecture (``portbench/arch/<model_type>.py``) run once over each prompt
and its served tokens:

- ``token_gap`` / ``token_gap_mean``: the largest / mean amount by which the
  reference's logit of a served token lies below its best logit there;
  ``token_miss``: the share of served tokens that are not the reference's best.

With ``control``, the same numbers of the configuration's lower-precision
path (``portbench/control.py``) on the same requests: for a chat, the token
the control puts first at each position of the same prompt and tokens. The
control's numbers are held to the same limits (``control_correct``).
"""

from __future__ import annotations

import statistics

import torch

from portbench import weights
from portbench.reference import scan, xlmr
from portbench.words import WordTokenizer, render


def check_asks(run, asks: list[dict], control: dict | None = None) -> list[dict]:
    """``asks``: ``{"q", "result": [(chunk_id, dense, rerank), ...]}``."""
    if not asks:
        return [{"name": "asks_checked", "value": 1.0, "limit": 0.0}]
    cfg = run.config["retrieval_stack"]
    enc, rr, ix, r = cfg["encoder"], cfg["reranker"], cfg["index"], cfg["retrieval"]
    dev, seed = run.device, run.seed
    dtype = getattr(torch, cfg["serve_dtype"])
    width, k = r["query_width"], r["top_k"]
    with torch.inference_mode():
        q_ids = xlmr.query_rows([a["q"] for a in asks], enc["vocab_size"], width, dev)
        sd = weights.draw(weights.xlmr_layout(enc, False), dev, dtype, seed, "encoder")
        q = xlmr.embed(sd, enc, q_ids)
        away = weights.common_direction(sd, enc, seed, dev, width)
        del sd
        n_blocks = -(-ix["live_rows"] // ix["block"])

        def block(b):
            n = min(ix["block"], ix["live_rows"] - b * ix["block"])
            return weights.block_rows(dev, seed, b, n, ix["dim"], ix["token_width"],
                                      enc["vocab_size"], away)

        _, top = scan.exact_topk(q, ((b * ix["block"], block(b)[0]) for b in range(n_blocks)), k)
        outputs = [("", [a["result"] for a in asks])]
        if control is not None:
            outputs.append(("control_", [control[a["q"]] for a in asks]))
        want = {int(x) for x in top.flatten().tolist()}
        for _, results in outputs:
            want |= {int(cid[1:]) for res in results for cid, _, _ in res}
        rows = {}
        for b in sorted({w // ix["block"] for w in want}):
            vecs, ids, _ = block(b)
            for w in want:
                if w // ix["block"] == b:
                    rows[w] = (vecs[w - b * ix["block"]], ids[w - b * ix["block"]])
        sd = weights.draw(weights.xlmr_layout(rr, True), dev, dtype, seed, "reranker")
        scores = {}
        pairs, keys = [], []
        for i, a in enumerate(asks):
            cands = set(top[i].tolist())
            for _, results in outputs:
                cands |= {int(cid[1:]) for cid, _, _ in results[i]}
            for w in sorted(cands):
                chunk = rows[w][1].clone().long()
                chunk[0] = xlmr.EOS
                pairs.append(torch.cat([q_ids[i], chunk]))
                keys.append((i, w))
        got = xlmr.rerank(sd, rr, torch.stack(pairs))
        del sd
        for key, s in zip(keys, got.tolist()):
            scores[key] = s
    spreads, best = [], []
    for i in range(len(asks)):
        ref = sorted((scores[(i, int(w))] for w in top[i].tolist()), reverse=True)
        spreads.append(ref[0] - ref[-1])
        best.append(ref)
    scale = max(statistics.median(spreads), 1e-12)
    out = []
    for prefix, results in outputs:
        dense, rerank, rank, miss = [], [], [], []
        for i, res in enumerate(results):
            ref_order = sorted(top[i].tolist(), key=lambda w: -scores[(i, int(w))])
            for j, (cid, d, s) in enumerate(res):
                w = int(cid[1:])
                dense.append(abs(d - float(scan.dot(q[i], rows[w][0]))))
                rerank.append(abs(s - scores[(i, w)]) / scale)
                rank.append((best[i][j] - scores[(i, w)]) / scale)
                miss.append(float(w != int(ref_order[j])))
            if len(res) < min(r["rerank_k"], len(best[i])):
                rank.append(float("inf"))  # an answer short of its chunks
                miss.append(1.0)
        numbers = {"dense_gap": max(dense), "dense_mean": statistics.fmean(dense),
                   "rerank_gap": max(rerank), "rerank_mean": statistics.fmean(rerank),
                   "rerank_p50": statistics.median(rerank),
                   "rank_gap": max(rank), "rank_miss": statistics.fmean(miss)}
        out += _checks(run, numbers, prefix)
    return out


def _checks(run, numbers: dict, prefix: str) -> list[dict]:
    """Every number, each with its limit where the configuration compares
    it (``correct.limits``) and None where it is only reported."""
    limits = run.config["correct"]["limits"]
    return [{"name": prefix + k, "value": float(v),
             "limit": float(limits[k]) if k in limits else None} for k, v in numbers.items()]


def check_chats(run, chats: list[dict], control: dict | None = None) -> list[dict]:
    """``chats``: greedy chats with their ``messages`` and served ``text``."""
    if not chats:
        return [{"name": "chats_checked", "value": 1.0, "limit": 0.0}]
    cfg = run.config
    dev = run.device
    dtype = getattr(torch, cfg["serve_dtype"])
    tok = WordTokenizer(cfg["vocab_size"], cfg["serving"]["eos_token_id"])
    gaps: dict[str, list] = {"": [], "control_": []}
    with torch.inference_mode():
        sd = weights.draw(run.arch.layout(cfg), dev, dtype, run.seed, "decoder")
        for c in chats:
            prompt = tok.encode(render(c["messages"]))
            served = tok.encode(c["text"])
            if not served:
                continue
            ids = torch.tensor(prompt + served, device=dev)
            lg = run.arch.logits(sd, cfg, ids)
            at = torch.arange(len(prompt) - 1, len(prompt) + len(served) - 1, device=dev)
            rows = lg[at]
            top = rows.max(dim=-1).values
            gaps[""] += (top - rows.gather(1, ids[at + 1][:, None])[:, 0]).tolist()
            if control is not None:
                pick = torch.tensor(control["tokens"][c["i"]], device=dev)[at]
                gaps["control_"] += (top - rows.gather(1, pick[:, None])[:, 0]).tolist()
        del sd
    out = []
    for prefix, g in gaps.items():
        if prefix and control is None:
            continue
        if not g:
            out.append({"name": prefix + "tokens_checked", "value": 1.0, "limit": 0.0})
            continue
        out += _checks(run, {"token_gap": max(g), "token_gap_mean": statistics.fmean(g),
                             "token_miss": statistics.fmean(float(x > 0) for x in g)}, prefix)
    return out
