"""The port's spans (``outline_rag_tpu_torch/utils/profiling.py``) read on the card.

    python3 tools/port_spans.py cost
        the host cost of one span (``metrics.span``, ``metrics.timeit``) and
        of one recorded span (``metrics.add``), with the ring full;
    python3 tools/port_spans.py cell --workload W --seed N --seconds S
        one traced run of a cell of ``BENCHMARK.json``, as
        ``portbench/run.py --trace 1`` makes it (``harness.execute``). Prints
        its result line's metrics, device and ``correct``; the device's idle
        time in the profiled sub-window by the innermost port span open at
        each idle stretch's middle, and the share of it inside the decode
        worker's spans; and, for chats, the medians of a turn's parts of its
        time to first token (retrieval, ``decode.queue``, ``decode.admit``)
        beside the median time to first token.

Run from the root of a checkout on a machine with the card; each prints one
JSON line, and ``cell`` refuses to run without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
CACHE = ROOT / ".portbench_cache"  # the kernel builds where portbench/run.py keeps them
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import torch  # noqa: E402

from outline_rag_tpu_torch.utils import profiling  # noqa: E402

WORKER = ("decode.stage", "decode.idle", "decode.launch", "decode.fetch", "decode.emit")


def card() -> str:
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return "no card"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def cost(n: int = 200_000) -> dict:
    """Microseconds a span costs the host, in steady state (the ring full)."""
    m = profiling.Metrics()
    out = {"card": card(), "torch": torch.__version__}
    t = time.perf_counter()
    for _ in range(n):
        pass
    loop = time.perf_counter() - t
    for label, body in (("host_span_us", lambda: m.span("cost.host")),
                        ("timeit_us", lambda: m.timeit("cost.timeit"))):
        t = time.perf_counter()
        for _ in range(n):
            with body():
                pass
        out[label] = 1e6 * (time.perf_counter() - t - loop) / n
    t = time.perf_counter()
    for _ in range(n):
        m.add("cost.add", 0.0, 1.0)
    out["add_us"] = 1e6 * (time.perf_counter() - t - loop) / n
    out["ring"] = {"recorded": m.recorded, "capacity": profiling.RING}
    return out


def _idle(p, cover: dict) -> dict:
    """Idle time of the sub-window by the innermost span open at each idle
    stretch's middle (``cover``: name -> placed ops), the ten longest
    stretches, and the share of idle time inside any span of ``WORKER``."""
    from portbench import idle

    gaps = idle.gaps(p)
    ranges = [(name, r) for name, ops in cover.items() for r in ops]
    by, named = {}, []
    for s, e in gaps:
        mid = (s + e) / 2
        inside = [(r.end - r.start, name) for name, r in ranges if r.start <= mid <= r.end]
        name = min(inside)[1] if inside else "no port span"
        by[name] = by.get(name, 0.0) + (e - s)
        named.append((e - s, name))
    total = sum(e - s for s, e in gaps)
    worker = [(r.start, r.end) for name, r in ranges if name in WORKER]
    named.sort(reverse=True)
    return {"idle_s": total / 1e6, "window_s": p.window_us / 1e6,
            "idle_s_by_span": {k: v / 1e6 for k, v in sorted(by.items(), key=lambda kv: -kv[1])},
            "longest_gaps": [[name, us / 1e6] for us, name in named[:10]],
            "idle_share_in_worker_spans": (idle.covered(gaps, worker) / total
                                           if total and worker else None)}


def _turns(run) -> dict:
    """A chat turn's parts of its time to first token, for the chats sent in
    the window: its retrieval (its ask's ``batcher.wait``, which starts as the
    chat is sent, to the end of the ``batcher.batch`` it names as parent), the
    hand-off to ``submit``, ``decode.queue``, ``decode.admit`` and the
    delivery of the first token. A turn's decode spans are the first
    ``decode.queue`` submitted after its retrieval returned, and the
    ``decode.admit`` of the same request id. Medians of each part and of the
    time to first token, over all turns and over those that miss the
    profiler's sub-window (``portbench/window.py::untraced``)."""
    from portbench.window import untraced

    m = profiling.metrics
    batches = {s.id: s for s in m.spans("batcher.batch", run.w0 - 120)}
    waits = sorted(m.spans("batcher.wait", run.w0 - 120), key=lambda s: s.t0)
    queues = sorted(m.spans("decode.queue", run.w0 - 120), key=lambda s: s.t0)
    admits = {s.rid: s for s in m.spans("decode.admit", run.w0 - 120)}
    taken, turns = set(), []
    for r in sorted(run.in_window("chat"), key=lambda r: r["start"]):
        if "first" not in r:
            continue
        t = {"ttft": r["first"] - r["start"]}
        w = min(waits, key=lambda s: abs(s.t0 - r["start"]), default=None)
        if w is not None and abs(w.t0 - r["start"]) < 1e-3 and w.parent in batches:
            b = batches[w.parent]
            t["retrieval"] = b.t1 - w.t0
        after = r.get("retrieved", r["start"])
        q = next((s for s in queues if s.t0 >= after and s.id not in taken), None)
        if q is not None and q.t0 - after < 1.0 and q.rid in admits:
            taken.add(q.id)
            a = admits[q.rid]
            t.update(handoff=q.t0 - after, queue=q.t1 - q.t0, admit=a.t1 - a.t0,
                     deliver=r["first"] - a.t1, spans_sum=t.get("retrieval", 0.0)
                     + (q.t1 - q.t0) + (a.t1 - a.t0))
        t["untraced"] = untraced(run, r["start"], r["first"])
        turns.append(t)

    def medians(ts):
        keys = ("ttft", "retrieval", "handoff", "queue", "admit", "deliver", "spans_sum")
        out = {f"{k}_p50_ms": 1e3 * statistics.median(v)
               for k in keys if (v := [t[k] for t in ts if k in t])}
        out["turns"] = len(ts)
        out["linked"] = sum("queue" in t for t in ts)
        out["queue_over_ttft"] = sum(t.get("queue", 0.0) > t["ttft"] for t in ts)
        return out

    return {"all": medians(turns), "untraced": medians([t for t in turns if t["untraced"]])}


class _Keeping:
    """The benchmark's parts, keeping the run that its metric readers read."""

    def __init__(self, bench):
        self.bench, self.run = bench, None

    def __getattr__(self, name):
        return getattr(self.bench, name)

    def reader(self, metric: str):
        read = self.bench.reader(metric).read

        def keep(run):
            self.run = run
            return read(run)

        return types.SimpleNamespace(read=keep)


def cell(workload: str, seed: int, seconds: float) -> dict:
    from portbench import harness

    if not torch.cuda.is_available():
        raise SystemExit("port_spans cell: needs a CUDA device")
    bench = _Keeping(harness.Bench(ROOT))
    result = harness.execute(bench, workload, seed, seconds, True)
    run = bench.run
    out = {"card": card(), "workload": workload, "seed": seed, "seconds": seconds,
           "correct": result["correct"], "attempted": result["attempted"],
           "failed": result["failed"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "device": result["device"]}
    p = run.profile
    t0, t1 = run.traced
    names = ("batcher.batch", "retrieve.fused", "fused.tokenize", "fused.encode", "fused.scan",
             "fused.rerank", "fused.fetch", "decode.prefill", *WORKER)
    cover = {name: [p.place(name, s.t0, s.t1) for s in profiling.metrics.spans(name, run.w0)
                    if s.t1 >= t0 and s.t0 <= t1] for name in names}
    out["idle"] = _idle(p, cover)
    if run.in_window("chat"):
        out["ttft_parts"] = _turns(run)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("cost", "cell"))
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    out = cost() if args.what == "cost" else cell(args.workload, args.seed, args.seconds)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
