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
from portbench.tests.tiny import CELLS, QWEN, REPO, make_root

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


TOY_ARCH = """\
from pathlib import Path

from portbench.harness import load_module

_qwen2 = load_module(Path(__file__).with_name("qwen2.py"))
_calls = Path(__file__).with_name("toy.calls")


def _wrap(name):
    def call(*args, **kwargs):
        with open(_calls, "a") as f:
            f.write(name + "\\n")
        return getattr(_qwen2, name)(*args, **kwargs)

    return call


layout, build, logits, quantize, lower, token_flops = (
    _wrap(n) for n in ("layout", "build", "logits", "quantize", "lower", "token_flops"))
"""


def _add_decoder_cell(root, model_type: str, like: str) -> str:
    """A configuration naming ``model_type`` and a cell of it under the
    traffic of the tiny cell ``like``, in every metric list that has it."""
    (root / "portbench" / "configs" / f"tiny-{model_type}.json").write_text(
        json.dumps(dict(QWEN, model_type=model_type)))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": f"tiny-{model_type}", "source": "tiny",
                            "file": f"portbench/configs/tiny-{model_type}.json", "reduced": [],
                            "why": "CPU"})
    cell = f"tiny.{model_type}"
    spec["workloads"].append({"name": cell, "config": f"tiny-{model_type}",
                              "traffic": CELLS[like][1], "chips": 1, "why": "CPU"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return cell


def test_an_architecture_dropped_in_is_found_by_name(tmp_path):
    """A decoder architecture is a file ``arch/<model_type>.py``: one that
    wraps Qwen2's parts serves, is checked, is controlled and is counted
    through each of them, and the run is correct."""
    root = make_root(tmp_path)
    (root / "portbench" / "arch" / "toy.py").write_text(TOY_ARCH)
    cell = _add_decoder_cell(root, "toy", "tiny.general")
    res = harness.execute(harness.Bench(root), cell, 17, 2.0, True, device="cpu", control=True)
    assert res["correct"] and res["attempted"] > 0, res["checks"]
    assert "decode_mfu" in res["metrics"] and res["control"]
    called = set((root / "portbench" / "arch" / "toy.calls").read_text().split())
    assert called == {"layout", "build", "logits", "quantize", "lower", "token_flops"}
    calls = (root / "portbench" / "arch" / "toy.calls").read_text().split()
    assert calls.count("quantize") == 1 and calls.count("lower") >= 2  # quantized once a run


def test_an_unknown_architecture_is_named_before_any_weight_is_drawn(tmp_path, monkeypatch):
    from portbench import weights

    root = make_root(tmp_path)
    cell = _add_decoder_cell(root, "nosuch", "tiny.rag")

    def drawn(*args, **kwargs):
        raise AssertionError("a weight was drawn")

    monkeypatch.setattr(weights, "draw", drawn)
    with pytest.raises(FileNotFoundError, match=r"arch/nosuch\.py"):
        harness.execute(harness.Bench(root), cell, 3, 1.0, False, device="cpu")


def test_the_sweep_builds_its_cell_and_reads_each_rate(bench, monkeypatch):
    """``sweep.py`` on the tiny ask cell: the stack built once through
    ``harness.build_stack``, a line a rate, the second rate without the
    warm-up."""
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script sets sys.path[0]
    sweep = harness.load_module(bench.root / "portbench" / "sweep.py")
    lines = list(sweep.sweep(bench, "tiny.ask", 2**31 + 9, 2.0, [10.0, 20.0],
                             torch.device("cpu")))
    assert [ln["rate"] for ln in lines] == [10.0, 20.0]
    for ln in lines:
        assert ln["due"] > 0 and ln["answered"] > 0 and ln["p95_ms"] >= ln["p50_ms"] > 0, ln
        assert isinstance(ln["sustained"], bool)


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
