"""The knee of an open-loop cell: the highest offered rate it sustains with
no growing backlog, by one sweep on the card.

    python3 portbench/sweep.py --workload <name> --seed <n> --seconds <s> --rates 60,90,...

Builds the cell once, then runs a window at each rate in turn (the mix's own
file with ``rate_per_s`` replaced) and prints one JSON line a rate: the asks
due in the window and the asks answered in it (any ask, the lead-in's too),
the backlog (asks due and not yet answered) when the window opens and when
it closes, p50 and p95 from when each ask was due, and the growth of the
latency (the median of the window's last fifth of asks over that of its
first fifth). A rate is sustained when the backlog grows by no more than 3%
of the asks due in the window, so that the window answers what it is
offered, and the latency does not grow (growth under 1.3). The knee is the
highest rate sustained; a mix's ``rate_per_s`` is set from it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path[0] = str(ROOT)


def sweep(bench, workload: str, seed: int, seconds: float, rates, device, t0=None):
    """Build ``workload``'s stack once on ``device``, then yield one dict a
    rate of ``rates`` (asks a second), as the module's docstring says."""
    from portbench import harness
    from portbench.stats import percentile

    first = harness.Run(bench, workload, seed, seconds, False, device, t0)
    stack = harness.build_stack(first)
    warmed = False
    try:
        for rate in rates:
            run = harness.Run(bench, workload, seed, seconds, False, device)
            run.mix = dict(run.mix, rate_per_s=rate)
            run.rec = stack.rec
            if warmed:
                async def no_warm(rng):
                    return None
                stack.retrieval.warm = no_warm
            asyncio.run(run.gen.drive(run, stack))
            warmed = True
            asks = sorted(run.in_window("ask"), key=lambda r: r["start"])
            done = [r for r in asks if r.get("result") is not None]
            lat = [(r["done"] - r["start"]) * 1e3 for r in done]
            fifth = max(1, len(done) // 5)
            growth = (statistics.median(lat[-fifth:]) / statistics.median(lat[:fifth])
                      if lat else None)

            def backlog(t):
                return sum(1 for r in run.records
                           if r["start"] <= t and (r.get("done") is None or r["done"] > t))

            answered = sum(1 for r in run.records
                           if r.get("done") is not None and run.w0 <= r["done"] < run.w1)
            grew = backlog(run.w1) - backlog(run.w0)
            yield {"rate": rate, "due": len(asks), "answered": answered,
                   "answered_per_s": answered / seconds,
                   "backlog_open": backlog(run.w0), "backlog_close": backlog(run.w1),
                   "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
                   "latency_growth": growth,
                   "sustained": grew <= 0.03 * len(asks) and growth is not None and growth < 1.3}
    finally:
        stack.close()


def main() -> int:
    import torch

    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True, help="comma-separated asks a second")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    for line in sweep(harness.Bench(ROOT), args.workload, args.seed, args.seconds,
                      [float(r) for r in args.rates.split(",")], dev, T0):
        print(json.dumps(dict(line, device=torch.cuda.get_device_name(dev))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
