"""A copy of the benchmark at a size the CPU runs in seconds: the same
harness, generators, readers and references, with tiny configurations and
mixes written into a temporary root beside a copy of ``BENCHMARK.json``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

XLMR = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "max_position_embeddings": 130, "vocab_size": 1024,
        "type_vocab_size": 1, "pad_token_id": 1, "layer_norm_eps": 1e-05}
RETRIEVAL = {
    **XLMR, "reranker": dict(XLMR), "serve_dtype": "float32",
    "index": {"rows": 4096, "live_rows": 3000, "dim": 64, "dtype": "int8r", "token_width": 16,
              "rescore_m": 32, "block": 512},
    "retrieval": {"top_k": 12, "rerank_k": 3, "query_width": 64, "batch_window_ms": 4.0,
                  "batch_max": 8, "batch_in_flight": 2},
    "correct": {"limits": {"dense_mean": 1e-5}},
}
QWEN = {
    "retrieval_config": "tiny-retrieval", "model_type": "qwen2", "hidden_size": 64,
    "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
    "max_position_embeddings": 512, "rms_norm_eps": 1e-06, "rope_theta": 1000000.0,
    "tie_word_embeddings": True, "vocab_size": 512, "serve_dtype": "float32",
    "serving": {"batch_slots": 4, "page_size": 16, "kv_pages": 129, "prefix_cache": True,
                "kv_int8": False, "max_new_tokens": 32, "chunk_tokens": 4, "eos_token_id": 511},
    "correct": {"limits": {"token_gap_mean": 1e-3, "dense_mean": 1e-5}},
}
MIXES = {
    "tiny.asks": {"kind": "open_asks", "rate_per_s": 20.0, "question_words": [6, 30],
                  "lead_s": 0.5, "sample": 8},
    "tiny.rag": {"kind": "closed_chats", "sessions": 3, "retrieve": True, "system_tokens": 32,
                 "question_words": [6, 10], "answer_tokens": [8, 24], "answer_median": 12,
                 "answer_sigma": 0.6, "chunk_words": [20, 30], "greedy_every": 2,
                 "temperature": 0.7, "top_p": 0.9, "ramp_s": 0.5, "sample": 2,
                 "retrieval_sample": 4},
    "tiny.general": {"kind": "closed_chats", "sessions": 3, "retrieve": False,
                     "system_tokens": 32, "question_words": [6, 12], "answer_tokens": [8, 24],
                     "answer_median": 16, "answer_sigma": 0.35, "chunk_words": [0, 0],
                     "greedy_every": 2, "temperature": 0.7, "top_p": 0.9, "ramp_s": 0.5,
                     "sample": 2},
}
# tiny cell -> (configuration, mix, the cell it stands for)
CELLS = {"tiny.ask": ("tiny-retrieval", "tiny.asks", "ask.m3-int8r-1m.poisson"),
         "tiny.rag": ("tiny-decoder", "tiny.rag", "chat.qwen2.5-1.5b.rag"),
         "tiny.general": ("tiny-decoder", "tiny.general", "chat.qwen2.5-1.5b.general")}


def make_root(tmp: Path) -> Path:
    """A benchmark root under ``tmp``: the repo's ``portbench/`` copied, the
    tiny parts added, and ``BENCHMARK.json`` with the tiny cells added to
    the repo's."""
    root = Path(tmp) / "bench"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, cfg in (("tiny-retrieval", RETRIEVAL), ("tiny-decoder", QWEN)):
        path = f"portbench/configs/{name}.json"
        (root / path).write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "tiny", "file": path, "reduced": [],
                                "why": "CPU"})
    for name, mix in MIXES.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, (config, traffic, _) in CELLS.items():
        spec["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                  "chips": 1, "why": "CPU"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [c for c, (_, _, real) in CELLS.items() if real in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
