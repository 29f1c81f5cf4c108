"""Whole runs of the tiny cells on the CPU, with the harness's look for a
card skipped: the result's keys, a part found by name from a file dropped
into a copy, ``correct`` true on the port as it is and false with the timed
path broken underneath, and the control's numbers."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import REPO, make_root

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    torch.set_num_threads(2)
    return harness.Bench(make_root(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", ["tiny.ask", "tiny.rag", "tiny.general"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_runs_and_is_correct(bench, cell, trace):
    res = harness.execute(bench, cell, 2**31 + 5, 2.0, trace, device="cpu")
    assert list(res)[-1] == "checks" and all(k in res for k in KEYS)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, res
    want = {m["name"] for m in bench.metrics(cell, trace)}
    if not trace:
        assert set(res["metrics"]) == want  # every end-to-end metric
    else:  # device readings are left out on the CPU, the rest are there
        assert {"device_idle_pct.ask", "device_idle_pct.chat"} & want
        assert len(set(res["metrics"]) & want) >= 3
        # the traced sub-window: min(4 s, a third of the window), in the window
        assert res["device"]["window_s"] >= 0.9 * min(4.0, 2.0 / 3)
    json.dumps(res)


def test_a_metric_and_a_mix_dropped_in_are_found_by_name(tmp_path):
    root = make_root(tmp_path)
    (root / "portbench" / "metrics" / "asks_answered.py").write_text(
        "def read(run):\n    return float(len(run.in_window('ask')))\n")
    mix = json.loads((root / "portbench" / "traffic" / "tiny.asks.json").read_text())
    (root / "portbench" / "traffic" / "tiny.asks-slow.json").write_text(
        json.dumps(dict(mix, rate_per_s=5.0)))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny.ask-slow", "config": "tiny-retrieval",
                              "traffic": "tiny.asks-slow", "chips": 1, "why": "CPU"})
    spec["end_to_end"].append({"name": "asks_answered", "unit": "asks", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["tiny.ask-slow"]})
    for m in spec["end_to_end"]:
        if m["name"] == "setup_s":
            continue
        if "tiny.ask" in m.get("workloads", []):
            m["workloads"].append("tiny.ask-slow")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = harness.execute(harness.Bench(root), "tiny.ask-slow", 7, 2.0, False, device="cpu")
    assert res["metrics"]["asks_answered"]["value"] == res["attempted"] > 0


def _broken_answer(monkeypatch):
    from outline_rag_tpu_torch.engine import service

    real = service.RetrievalService.retrieve_batch

    def altered(self, queries):
        out = real(self, queries)
        for res in out:  # the best chunk swapped for another row
            if res:
                res[0].chunk_id = f"c{(int(res[0].chunk_id[1:]) + 1) % 3000}"
        return out

    monkeypatch.setattr(service.RetrievalService, "retrieve_batch", altered)


def _broken_token(monkeypatch):
    from outline_rag_tpu_torch.serve import decode_batcher

    real = decode_batcher.DecodeBatcher._step_chunk

    def altered(self, *state):
        toks, tok, pos = real(self, *state)
        return (toks + 1) % 511, tok, pos  # every served token one id off

    monkeypatch.setattr(decode_batcher.DecodeBatcher, "_step_chunk", altered)


@pytest.mark.parametrize("cell,fault", [("tiny.ask", _broken_answer),
                                        ("tiny.rag", _broken_answer),
                                        ("tiny.rag", _broken_token),
                                        ("tiny.general", _broken_token)],
                         ids=["ask-answer", "rag-answer", "rag-token", "general-token"])
def test_a_broken_timed_path_is_not_correct(bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = harness.execute(bench, cell, 11, 2.0, False, device="cpu")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["tiny.ask", "tiny.rag", "tiny.general"])
def test_the_control_is_computed_on_the_same_requests(bench, cell):
    """The lower-precision control at a tiny size: its numbers come back
    beside the program's and fail the same limits (its readings at the cells'
    sizes come from the card, ``portbench/control.py``); retrieval's w8a8
    trunks move the cross-encoder's scores by far more than float32
    rounding does."""
    res = harness.execute(bench, cell, 13, 2.0, False, device="cpu", control=True)
    assert res["correct"]
    assert set(res["control"]) == {"control_" + k for k in res["numbers"]}
    assert set(res["checks"]) <= set(res["numbers"])
    held = [res["control"]["control_" + k] <= c["limit"] for k, c in res["checks"].items()]
    assert res["control_correct"] is all(held)
    if cell != "tiny.general":  # at this size int8 weights serve float32's tokens
        assert res["control_correct"] is False
        assert res["control"]["control_rerank_gap"] > 30 * res["numbers"]["rerank_gap"]


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "ask.m3-int8r-1m.poisson", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode != 0 and out.stdout == ""
