"""The DeepSeek-V2 architecture in the benchmark, on the CPU: a tiny
``deepseek_v2`` configuration and cell added to the tiny root (``tiny.py``
as it is), run end to end and correct, not correct with the timed path
broken, its control; the published configuration's leaves, parameter count,
FLOPs and expert bytes; and ``moe_expert_roofline`` read from the port's
``moe.route`` records on a fake profile."""

import json
import types

import pytest
import torch

from outline_rag_tpu_torch.utils import profiling
from portbench import harness, roofline
from portbench.devtrace import Op, Profile
from portbench.tests.tiny import QWEN, REPO, make_root

CELL = "chat.deepseek-v2-lite.general"
TINY = {
    "retrieval_config": "tiny-retrieval", "model_type": "deepseek_v2", "hidden_size": 64,
    "num_attention_heads": 4, "num_key_value_heads": 4, "kv_lora_rank": 32,
    "qk_rope_head_dim": 16, "qk_nope_head_dim": 16, "v_head_dim": 16, "q_lora_rank": None,
    "n_routed_experts": 8, "num_experts_per_tok": 2, "n_shared_experts": 1,
    "moe_intermediate_size": 32, "first_k_dense_replace": 1, "moe_layer_freq": 1,
    "num_hidden_layers": 3, "intermediate_size": 128, "vocab_size": 512, "rms_norm_eps": 1e-6,
    "rope_theta": 10000, "norm_topk_prob": False, "routed_scaling_factor": 1.0,
    "scoring_func": "softmax", "topk_method": "greedy", "tie_word_embeddings": False,
    "attention_bias": False, "hidden_act": "silu", "max_position_embeddings": 512,
    "rope_scaling": {"type": "yarn", "factor": 4, "original_max_position_embeddings": 64,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707},
    "serve_dtype": "float32", "serving": QWEN["serving"],
    "correct": {"limits": {"token_gap_mean": 1e-3}},
}


def add_cell(root):
    """The tiny DeepSeek-V2 configuration and its cell ``tiny.dsv2`` (the
    tiny General mix) in the root's ``BENCHMARK.json``, in every metric list
    that has the real cell."""
    (root / "portbench" / "configs" / "tiny-dsv2.json").write_text(json.dumps(TINY))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-dsv2", "source": "tiny",
                            "file": "portbench/configs/tiny-dsv2.json", "reduced": [],
                            "why": "CPU"})
    spec["workloads"].append({"name": "tiny.dsv2", "config": "tiny-dsv2",
                              "traffic": "tiny.general", "chips": 1, "why": "CPU"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny.dsv2")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.Bench(root)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    torch.set_num_threads(2)
    return add_cell(make_root(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("trace", [False, True])
def test_the_tiny_cell_runs_and_is_correct(bench, trace):
    res = harness.execute(bench, "tiny.dsv2", 2**31 + 21, 2.0, trace, device="cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, res
    want = {m["name"] for m in bench.metrics("tiny.dsv2", trace)}
    if not trace:
        assert set(res["metrics"]) == want
    else:  # the device's readings are left out on the CPU
        assert "moe_expert_roofline" in want and "moe_expert_roofline" not in res["metrics"]
        assert {"decode_mfu", "decode_step_ms", "live_rows_mean"} <= set(res["metrics"])


def test_a_broken_timed_path_is_not_correct(bench, monkeypatch):
    from outline_rag_tpu_torch.serve import decode_batcher

    real = decode_batcher.DecodeBatcher._step_chunk

    def altered(self, *state):
        toks, tok, pos = real(self, *state)
        return (toks + 1) % 511, tok, pos  # every served token one id off

    monkeypatch.setattr(decode_batcher.DecodeBatcher, "_step_chunk", altered)
    res = harness.execute(bench, "tiny.dsv2", 11, 2.0, False, device="cpu")
    assert not res["correct"], res["checks"]


def test_the_control_is_computed_on_the_same_requests(bench):
    res = harness.execute(bench, "tiny.dsv2", 13, 2.0, False, device="cpu", control=True)
    assert res["correct"]
    assert set(res["control"]) == {"control_" + k for k in res["numbers"]}
    held = [res["control"]["control_" + k] <= c["limit"] for k, c in res["checks"].items()]
    assert res["control_correct"] is all(held)


def _published():
    bench = harness.Bench(REPO)
    cfg = bench.config(bench.cell(CELL)["config"])
    return bench.arch(cfg), cfg


def test_the_published_layout_counts_15_7_billion_parameters():
    """27 layers: the dense one, then 26 of 64 experts each laid out gate,
    up, gate, up, ... then every down, so the loader takes views."""
    arch, cfg = _published()
    leaves = arch.layout(cfg)
    total = sum(torch.Size(shape).numel() for _, shape, _ in leaves)
    assert total == pytest.approx(15.7e9, rel=0.01)
    names = [n for n, _, _ in leaves]
    at = names.index("model.layers.1.mlp.experts.0.gate_proj.weight")
    assert names[at + 1] == "model.layers.1.mlp.experts.0.up_proj.weight"
    assert names[at + 2] == "model.layers.1.mlp.experts.1.gate_proj.weight"
    assert names[at + 128] == "model.layers.1.mlp.experts.0.down_proj.weight"
    assert "model.layers.0.mlp.gate_proj.weight" in names and len(set(names)) == len(names)


def test_flops_and_expert_cost_at_the_published_widths():
    """2 x 2.45e9 weights a token meet (DeepSeek-V2-Lite's 2.4B active)
    and attention's 2 x 16 x (192 + 128) a position a layer; an expert
    layer-step at 64 rows reads 64 experts' 17.3 MB each."""
    arch, cfg = _published()
    active = (27 * (2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048)
              + 3 * 2048 * 10944 + 26 * (8 * 3 * 2048 * 1408 + 2048 * 64) + 102400 * 2048)
    assert active == pytest.approx(2.45e9, rel=0.01)
    assert arch.token_flops(cfg, 0) == 2 * active + 2 * 27 * 16 * 320
    assert arch.token_flops(cfg, 99) - arch.token_flops(cfg, 0) == 99 * 2 * 27 * 16 * 320
    n_bytes, flops = arch.expert_cost(cfg, 64, 384)
    assert n_bytes == 2 * (64 * 3 * 2048 * 1408 + 384 * 2 * 2048)
    assert flops == 384 * 6 * 2048 * 1408


def test_the_roofline_reads_the_route_records_and_the_grouped_kernels(monkeypatch):
    """Two records inside the traced sub-window and one past it; grouped
    kernels inside the records' ranges count, others and those outside do
    not."""
    arch, cfg = _published()
    metrics = profiling.Metrics()
    monkeypatch.setattr(profiling, "metrics", metrics)
    fields = [dict(kind="decode", rows=64, steps=16, pairs=64 * 6 * 26 * 16,
                   experts_hit=26 * 16 * 64, expert_tokens_max=20),
              dict(kind="prefill", rows=1, steps=1, pairs=256 * 6 * 26, experts_hit=26 * 64,
                   expert_tokens_max=90),
              dict(kind="decode", rows=64, steps=16, pairs=1, experts_hit=1, expert_tokens_max=1)]
    for i, f in enumerate(fields):  # host seconds 10.1-10.2, 10.3-10.4, 14.0-14.1
        t0 = (10.1, 10.3, 14.0)[i]
        metrics.add("moe.route", t0, t0 + 0.1, **f)
    grouped = "void cutlass::device_kernel<cutlass::gemm::GroupProblemShape<int>>"
    device = [Op(grouped, 0.11e6, 0.15e6), Op("elementwise_kernel", 0.16e6, 0.17e6),
              Op(grouped, 0.31e6, 0.32e6), Op(grouped, 0.25e6, 0.26e6)]  # the last between
    profile = Profile(4e6, 0.0, device, [], anchor_us=0.0, anchor_host=10.0)
    run = types.SimpleNamespace(profile=profile, traced=(10.0, 14.05), w0=9.0, arch=arch,
                                config=cfg)
    read = harness.load_module(REPO / "portbench" / "metrics" / "moe_expert_roofline.py").read
    bound = sum(roofline.bound_s(*arch.expert_cost(cfg, f["experts_hit"], f["pairs"]))
                for f in fields[:2])
    assert read(run) == pytest.approx(100 * bound * 1e6 / (0.04e6 + 0.01e6))
    assert read(types.SimpleNamespace(**{**vars(run), "arch": types.SimpleNamespace()})) is None
