"""One run of one cell: build the system, warm it, measure for the window,
read the metrics, check the outputs against the reference, print the result.

Every part is found by name. ``BENCHMARK.json`` names the cell; the cell names
its configuration (``configs[].file``) and its traffic mix
(``portbench/traffic/<mix>.json``); the mix names its generator
(``portbench/traffic/<kind>.py``); each metric is read by
``portbench/metrics/<metric>.py``. Adding a cell, a mix or a metric adds files
and entries and edits none.

A generator module provides ``needs(mix)`` (the parts of the stack it drives),
``async drive(run, stack)`` (warm up, call ``await run.open_window()``, send
the traffic until ``run.w1``, wait for its answers, fill ``run.records``) and
``check(run, control=None)`` (the numbers compared with the reference, each
with its limit). ``controlled(run, stack)`` gives what the configuration's
lower-precision path produces for the sampled requests (``portbench/
control.py``).

A metric module provides ``read(run) -> float | None``; None leaves the metric
out of the line.

A decoder configuration names its architecture by the published config's
``model_type``, and ``portbench/arch/<model_type>.py`` provides ``layout(cfg)``
(the state dict's leaves, in the order the seeded draw cuts them),
``build(cfg, sd, device, dtype) -> (params, model_cfg)`` (the port's loader;
it may consume ``sd``), ``logits(sd, cfg, ids)`` (the plain reference, as a
rule imported from ``reference/<model_type>.py``), the control as
``quantize(params) -> qparams`` (once a run) and ``lower(qparams, model_cfg,
ids) -> logits``, and ``token_flops(cfg, context)``. Each takes plain values,
not the harness's objects.
"""

from __future__ import annotations

import asyncio
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from portbench import devtrace
from portbench.stack import Stack

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "outline_rag_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    if not path.exists():
        raise FileNotFoundError(f"no such benchmark part: {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_part_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the parts it names, under ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")
        self.parts = self.root / "portbench"

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration as run; one that names ``retrieval_config``
        gets that configuration's retrieval stack."""
        entry = next((c for c in self.spec["configs"] if c["name"] == name), None)
        if entry is None:
            raise KeyError(f"no configuration {name!r} in BENCHMARK.json")
        cfg = load_json(self.root / entry["file"])
        if "retrieval_config" in cfg:
            cfg["retrieval_stack"] = self.config(cfg["retrieval_config"])["retrieval_stack"]
        elif "retrieval" in cfg:
            cfg["retrieval_stack"] = {
                "encoder": {k: v for k, v in cfg.items() if not isinstance(v, (dict, list))},
                "reranker": cfg["reranker"], "index": cfg["index"],
                "retrieval": cfg["retrieval"], "serve_dtype": cfg["serve_dtype"],
            }
        return cfg

    def mix(self, name: str) -> dict:
        return load_json(self.parts / "traffic" / f"{name}.json")

    def generator(self, mix: dict):
        return load_module(self.parts / "traffic" / f"{mix['kind']}.py")

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of ``cell`` prints: end-to-end without
        tracing, per-layer with it."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        return load_module(self.parts / "metrics" / f"{metric}.py")

    def arch(self, config: dict):
        """The decoder architecture the configuration's ``model_type`` names."""
        return load_module(self.parts / "arch" / f"{config['model_type']}.py")


class Run:
    """One run: what the generator drives and what the metric readers read.

    Times are ``time.perf_counter`` seconds; the window is ``[w0, w1)``.
    ``records`` holds one dict a request (``start`` is when it was due or
    sent); ``info`` what the readers need of the built stack."""

    def __init__(self, bench: Bench, workload: str, seed: int, seconds: float, trace: bool,
                 device, t0: float | None = None):
        self.t_start = time.perf_counter() if t0 is None else t0
        self.bench, self.workload, self.seed = bench, workload, int(seed)
        self.seconds, self.trace, self.device = float(seconds), bool(trace), device
        self.cell = bench.cell(workload)
        self.config = bench.config(self.cell["config"])
        self.mix = bench.mix(self.cell["traffic"])
        self.gen = bench.generator(self.mix)
        # found before any weight is drawn
        self.arch = bench.arch(self.config) if "decoder" in self.gen.needs(self.mix) else None
        self.records: list[dict] = []
        self.setup_s = self.w0 = self.w1 = None
        self.drain_s = 90.0  # the longest wait for answers past the window's close
        self.profile: devtrace.Profile | None = None
        self.info: dict = {}  # filled by the generator for the readers
        self.rec = None
        self._tracer = self._poller = None
        self.worker_polls = False  # the decode worker starts and stops the profiler
        self.traced = None  # (t0, t1): the profiler's sub-window on the host's clock

    def in_window(self, kind: str | None = None) -> list[dict]:
        return [r for r in self.records
                if self.w0 <= r["start"] < self.w1 and (kind is None or r["kind"] == kind)]

    def warm_profiler(self) -> None:
        """A traced run starts the profiler once during set-up, so that
        starting it inside the window costs less."""
        if self.trace and self.device.type == "cuda":
            with _profiler():
                torch.ones(1, device=self.device).add_(1)
                torch.cuda.synchronize(self.device)

    async def open_window(self) -> float:
        """Set-up ends here: the window opens (and, traced, the profiler's
        sub-window is scheduled in its middle third)."""
        now = time.perf_counter()
        self.setup_s = now - self.t_start
        self.w0, self.w1 = now, now + self.seconds
        if self.trace:
            start = now + self.seconds / 3
            cpu = not self.worker_polls
            self._tracer = devtrace.Tracer(lambda: _profiler(cpu), start,
                                           start + min(4.0, self.seconds / 3), self._sync,
                                           lambda: devtrace.anchor(self.device))
            if not self.worker_polls:
                self._poller = asyncio.create_task(self._poll_on_time())
        return self.w0

    async def _poll_on_time(self) -> None:
        """Start and stop the profiler from this thread, at their times."""
        for at in (self._tracer.start_at, self._tracer.stop_at):
            await asyncio.sleep(max(0.0, at - time.perf_counter()))
            self._tracer.poll()

    def poll(self) -> None:
        """Start or stop the profiler when due: called by the decode worker
        between its chunks (``stack.py``)."""
        if self._tracer is not None:
            self._tracer.poll()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    async def close_window(self) -> None:
        """Wait for the traced sub-window, polled by the decode worker when
        there is one, else by this thread at its start and stop."""
        tracer = self._tracer
        if tracer is None:
            return
        if self.worker_polls:
            await asyncio.to_thread(tracer.done.wait, 120.0)
        else:
            await self._poller
        if tracer.span is None:
            return
        self.traced = tracer.span
        self.profile = devtrace.from_profiler(tracer.prof, tracer.span, tracer.anchor)
        # the benchmark's spans on the profiler's clock, to name the device's idle gaps
        for name in ("retrieve_batch", "decode_chunk", "prefill_chunk"):
            for t0, t1, _ in self.rec.spans.get(name, []):
                if t1 >= self.traced[0] and t0 <= self.traced[1]:
                    self.profile.ranges.append(self.profile.place(name, t0, t1))


def _profiler(cpu: bool = True):
    """A profiler of the card's operations and every thread's CUDA calls,
    with the host's operators (``cpu``) when the event loop's thread runs it,
    as in the runs that proved the ask cell. Run by the decode worker it
    records the card alone: the worker's PyTorch operators would stall it for
    seconds when the profiler stops."""
    acts = [torch.profiler.ProfilerActivity.CPU] if cpu or not torch.cuda.is_available() else []
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def build_stack(run: Run) -> Stack:
    """The parts ``run``'s traffic needs, built from its seed on its device."""
    return Stack(run.config, run.gen.needs(run.mix), run.seed, run.device, run.trace, run.arch)


def execute(bench: Bench, workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t0: float | None = None, control: bool = False) -> dict:
    """One run of ``workload``; returns the result line as a dict (its
    ``checks`` key last). Set-up is counted from ``t0`` (``perf_counter``),
    by default from this call. With ``control``, the configuration's
    lower-precision path is run on the same sampled requests after the
    window, and its numbers come back under ``control``, with its verdict
    by the same limits under ``control_correct`` (``portbench/control.py``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    run = Run(bench, workload, seed, seconds, trace, dev, t0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    stack = build_stack(run)
    run.rec = stack.rec
    run.warm_profiler()
    asyncio.run(_drive(run, stack))
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    metrics = {}
    for m in bench.metrics(workload, trace):
        value = bench.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    lower = run.gen.controlled(run, stack) if control else None
    stack.close()
    del stack
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    numbers = run.gen.check(run, lower)
    controls = [c for c in numbers if c["name"].startswith("control_")]
    numbers = [c for c in numbers if not c["name"].startswith("control_")]
    checks = [c for c in numbers if c["limit"] is not None]
    ours = run.in_window()
    failed = sum(1 for r in ours if r.get("error") or r.get("done") is None)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "count": int(run.cell["chips"]),
        "memory_peak_bytes": int(memory_peak),
    }
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks) and bool(checks),
        "attempted": len(ours),
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
    }
    if run.profile is not None:
        device_info["busy_s"] = run.profile.busy_us / 1e6
        device_info["window_s"] = run.profile.window_us / 1e6
        result["breakdown"] = {"device_ops": run.profile.device_ops(),
                               "idle_gaps": run.profile.idle_gaps()}
    if control:  # every number of both sides, compared or not; the control's verdict
        result["numbers"] = {c["name"]: c["value"] for c in numbers}
        result["control"] = {c["name"]: c["value"] for c in controls}
        held = [c for c in controls if c["limit"] is not None]
        result["control_correct"] = all(c["value"] <= c["limit"] for c in held) and bool(held)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


async def _drive(run: Run, stack: Stack) -> None:
    if stack.decoder is not None:  # its worker starts and stops the profiler between chunks
        stack.decoder.tracer = run
        run.worker_polls = True
    await run.gen.drive(run, stack)
    await run.close_window()


def main(argv=None, t0: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench(HERE.parent)
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = execute(bench, args.workload, args.seed, args.seconds, bool(args.trace), t0=t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

