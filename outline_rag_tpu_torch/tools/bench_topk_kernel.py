"""What the float scan's selection costs on the card: the full scan beside
its floors; and the scans of several checkouts side by side.

    python -m outline_rag_tpu_torch.tools.bench_topk_kernel [N] [B] [MODE ...]
    python -m outline_rag_tpu_torch.tools.bench_topk_kernel --scan DIR [DIR ...]

The port's counterpart of the JAX package's ``tools/bench_topk_kernel.py``.
Run it on a machine with one CUDA card and ``nvcc``. Variants a mode (fp32,
bf16, f32x2; default all three):

  full    — ``topk_float`` at K = 12, the serving scan
  nomerge — ``topk_floor``: every score, then only a running maximum
  matmul  — ``topk_floor(variant="matmul")``: the maximum over each tile's
            first row only (fp32 and bf16; the f32x2 floor has ``nomerge``
            alone, as in the JAX tool)

over a seeded corpus of N unit rows x 1024 (default 1,048,576) and B queries
(default 32). ``full - nomerge`` is the selection's cost. Each time is the
median of 10 CUDA-event timings (``BENCH_RUNS``). One JSON line a mode, with
the card's name and power limit.

With ``--scan``, each ``DIR`` is a checkout of this repository (an older one
unpacked with ``git archive``, or ``.``); for each, in the order given, a
fresh process starts in that directory, builds that checkout's kernels and
times its ``topk_float`` at K = 64 over the same seeded 1,048,576 x 1024
corpus in each mode, at B = 32 and 128, and at the serving shape B = 32,
K = 12; then its ``topk_int8`` the same way over a seeded 1,048,576 x 1024
int8 corpus (one JSON line a checkout). Give an
older checkout on both sides of a newer one (``old new new old``) to see the
spread beside the difference.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

from outline_rag_tpu_torch.ops.topk import FLOAT_MODES, split_f32_bf16x2, topk_float, topk_floor
from outline_rag_tpu_torch.tools.timing import card, cuda_ms

DIM, TOP_K = 1024, 12

# one checkout's scan, on inputs every checkout draws alike
_SCAN = """
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
from outline_rag_tpu_torch.ops.topk import split_f32_bf16x2, topk_float, topk_int8
from outline_rag_tpu_torch.tools.timing import cuda_ms
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", torch.cuda.current_device())
g = torch.Generator(device=dev).manual_seed(11)
corpus = torch.nn.functional.normalize(torch.randn((1 << 20, 1024), generator=g, device=dev), dim=1)
queries = {b: torch.nn.functional.normalize(torch.randn((b, 1024), generator=g, device=dev), dim=1)
           for b in (32, 128)}
penalty = torch.zeros(corpus.shape[0], device=dev)
store = {"fp32": lambda x: x, "bf16": lambda x: x.to(torch.bfloat16), "f32x2": split_f32_bf16x2}
out = {}
for mode, cast in store.items():
    c = cast(corpus)
    for b, q in queries.items():
        qc = cast(q)
        out[mode + "_b" + str(b) + "_ms"] = cuda_ms(lambda: topk_float(qc, c, 64, penalty, mode))
    qc = cast(queries[32])  # the serving scan: B = 32, K = 12
    out[mode + "_b32_k12_ms"] = cuda_ms(lambda: topk_float(qc, c, 12, penalty, mode))
    del c
    torch.cuda.empty_cache()
codes = torch.randint(-127, 128, (1 << 20, 1024), generator=g, device=dev, dtype=torch.int8)
cscale = (torch.rand(1 << 20, generator=g, device=dev) + 0.5) / 127
for b in (32, 128):
    qc = torch.randint(-127, 128, (b, 1024), generator=g, device=dev, dtype=torch.int8)
    qs = (torch.rand(b, generator=g, device=dev) + 0.5) / 127
    out["int8_b" + str(b) + "_ms"] = cuda_ms(lambda: topk_int8(qc, qs, codes, cscale, 64, penalty))
    if b == 32:
        out["int8_b32_k12_ms"] = cuda_ms(lambda: topk_int8(qc, qs, codes, cscale, 12, penalty))
print(json.dumps(out))
"""


def bench_mode(queries: torch.Tensor, corpus: torch.Tensor, mode: str, runs: int = 10) -> dict:
    """Times of the variants for ``queries`` and ``corpus`` as ``mode``
    stores them: ``{variant}_ms``, and the corpus bytes a second of each."""
    calls = {"full": lambda: topk_float(queries, corpus, TOP_K, None, mode),
             "nomerge": lambda: topk_floor(queries, corpus, mode, "nomerge")}
    if mode != "f32x2":
        calls["matmul"] = lambda: topk_floor(queries, corpus, mode, "matmul")
    row = {"mode": mode, "N": corpus.shape[0], "B": queries.shape[0], "D": DIM, "K": TOP_K}
    for variant, call in calls.items():
        ms = cuda_ms(call, runs)
        row[f"{variant}_ms"] = ms
        row[f"{variant}_gb_per_s"] = corpus.numel() * corpus.element_size() / ms / 1e6
    row["selection_ms"] = row["full_ms"] - row["nomerge_ms"]
    return row


def store(x: torch.Tensor, mode: str) -> torch.Tensor:
    """f32 rows as ``mode`` stores them."""
    if mode == "fp32":
        return x
    return x.to(torch.bfloat16) if mode == "bf16" else split_f32_bf16x2(x)


def scan_checkouts(directories: list[str]) -> None:
    """``--scan``: each checkout's ``topk_float`` and ``topk_int8`` in a fresh
    process of its own."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    smi = card()
    for i, directory in enumerate(directories):
        done = subprocess.run([sys.executable, "-c", _SCAN], cwd=directory, env=env,
                              capture_output=True, text=True, check=False)
        if done.returncode != 0:
            raise RuntimeError(f"the scan in {directory} failed:\n" + done.stderr[-2000:])
        times = json.loads(done.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "checkout": directory, **times, "card": smi}), flush=True)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("bench_topk_kernel: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if argv[:1] == ["--scan"]:
        scan_checkouts(argv[1:] or ["."])
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    n = int(argv[0]) if argv else 1_048_576
    b = int(argv[1]) if len(argv) > 1 else 32
    modes = argv[2:] or list(FLOAT_MODES)
    runs = int(os.environ.get("BENCH_RUNS", 10))
    g = torch.Generator(device=dev).manual_seed(0)
    corpus = torch.randn((n, DIM), generator=g, device=dev)
    corpus.div_(corpus.norm(dim=1, keepdim=True))
    queries = torch.randn((b, DIM), generator=g, device=dev)
    queries.div_(queries.norm(dim=1, keepdim=True))
    smi = card()
    for mode in modes:
        stored = store(corpus, mode)
        print(json.dumps({**bench_mode(store(queries, mode), stored, mode, runs), "card": smi}),
              flush=True)
        del stored
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
