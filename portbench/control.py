"""The readings a cell's limits are set from, on the card.

    python3 portbench/control.py --workload <name> --seeds 11,12,... --seconds <s>

For each seed, in one process: a run of the cell as the benchmark runs it
(a window of ``--seconds`` at the cell's own load), then the configuration's
lower-precision path on the same sampled requests (the port's w8a8 trunks
for retrieval, its int8 weights for the decoder), both compared with the
reference. One JSON line a seed: the program's verdict (``correct``) and
numbers, and the control's verdict by the same limits (``control_correct``,
which has to read false) and numbers. The benchmark's own runs never run
the control.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path[0] = str(ROOT)


def main() -> int:
    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    bench = harness.Bench(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res = harness.execute(bench, args.workload, seed, args.seconds, False, control=True)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t,
                          "correct": res["correct"],
                          "control_correct": res["control_correct"], "metrics": res["metrics"],
                          "numbers": res["numbers"], "control": res["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
