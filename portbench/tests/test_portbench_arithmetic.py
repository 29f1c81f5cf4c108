"""Percentiles and rates over every request, and the FLOP and byte counts
against hand counts."""

import statistics
import types

import numpy as np
import pytest

from portbench import roofline, stats
from portbench.harness import load_module
from portbench.tests.tiny import REPO

METRICS = REPO / "portbench" / "metrics"


def test_percentile_is_numpys_linear_percentile():
    x = np.random.default_rng(0).exponential(size=1001).tolist()
    for q in (0, 50, 95, 99, 100):
        assert stats.percentile(x, q) == pytest.approx(float(np.percentile(x, q)))
    assert stats.percentile([], 95) is None
    assert stats.percentile([3.0], 95) == 3.0


def test_spread_uses_the_statistics_quartiles():
    x = [10.0, 11.0, 12.0, 13.0, 20.0, 9.0]
    q1, med, q3 = statistics.quantiles(x, n=4)
    assert stats.spread(x) == pytest.approx((q3 - q1) / med)


def _run(records, w0=0.0, w1=10.0, **info):
    def in_window(kind=None):
        return [r for r in records if w0 <= r["start"] < w1 and (kind is None or r["kind"] == kind)]

    return types.SimpleNamespace(records=records, w0=w0, w1=w1, drain_s=90.0,
                                 in_window=in_window, info=info)


def test_ask_tail_is_over_every_ask_due_in_the_window_failures_included():
    records = [{"kind": "ask", "start": t / 10, "done": t / 10 + 0.1, "result": []}
               for t in range(95)]
    records += [{"kind": "ask", "start": 9.6 + i / 100, "error": "x"} for i in range(5)]
    records.append({"kind": "ask", "start": -1.0, "done": 50.0, "result": []})  # the lead-in
    p95 = load_module(METRICS / "ask_p95_ms.py").read(_run(records))
    assert len(_run(records).in_window("ask")) == 100
    # five failures count at the longest wait (w1 + 90 s): the 95th percentile sits between
    lat = sorted([100.0] * 95 + [(100.0 - (9.6 + i / 100)) * 1e3 for i in range(5)])
    assert p95 == pytest.approx(float(np.percentile(lat, 95)))
    p50 = load_module(METRICS / "ask_p50_ms.py").read(_run(records))
    assert p50 == pytest.approx(100.0)


def test_ttft_and_token_rate_count_every_chat_and_delta_in_the_window():
    records = [{"kind": "chat", "start": 1.0 + i, "first": 1.5 + i,
                "pieces": [(1.5 + i, 1), (2.0 + i, 16)]} for i in range(9)]
    records.append({"kind": "chat", "start": -2.0, "first": 0.0, "pieces": [(-1.0, 1), (0.5, 16)]})
    run = _run(records)
    assert load_module(METRICS / "ttft_p95_ms.py").read(run) == pytest.approx(500.0)
    # 8 chats' 17 tokens, the last chat's first token (its second delta lands at
    # the close), and the 16 of the older chat's delta that landed in the window
    assert load_module(METRICS / "gen_tokens_per_s.py").read(run) == pytest.approx(
        (8 * 17 + 1 + 16) / 10.0)


def test_xlmr_flops_by_hand():
    cfg = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2}
    # a layer: 4 h x h projections and 2 h x f, 2 FLOPs a multiply-add a token,
    # plus q.k and p.v: 2 x (2 x S x S x h) a row
    per_layer = 2 * 3 * 5 * (4 * 16 + 2 * 32) + 4 * 3 * 5 * 5 * 4
    assert roofline.xlmr_flops(cfg, 3, 5) == 2 * per_layer


def test_qwen2_token_flops_by_hand():
    cfg = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 3,
           "num_attention_heads": 2, "num_key_value_heads": 1, "vocab_size": 100}
    hd = 4
    proj = 8 * (2 * 4 + 2 * 4) + 2 * 4 * 8 + 3 * 8 * 16
    want = 2 * (3 * proj + 100 * 8) + 4 * 3 * 2 * hd * 11
    assert load_module(REPO / "portbench" / "arch" / "qwen2.py").token_flops(cfg, 10) == want


def test_scan_and_paged_bytes_by_hand():
    assert roofline.int8_scan_bytes(2, 10, 4, 3) == 10 * 4 + 8 * 10 + 2 * 8 + 8 * 2 * 3
    assert roofline.scan_ops(2, 10, 4) == 160
    cfg = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1}
    n_bytes, flops = roofline.paged_attention_cost(cfg, [5, 7], 1)
    # K and V of each row (1 KV head x 4 x 2 bytes a position), q in and out in bf16
    assert n_bytes == 2 * 4 * 2 * (5 + 7) + 2 * (2 * 2 * 2 * 4)
    assert flops == 4 * 2 * 4 * (5 + 7)
    _, f_chunk = roofline.paged_attention_cost(cfg, [6], 3)
    assert f_chunk == 4 * 2 * 4 * (4 + 5 + 6)  # causal: 4, 5 and 6 positions
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(0, 989e12) == pytest.approx(1.0)
