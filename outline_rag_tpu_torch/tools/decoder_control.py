"""The decoder phase of ``chip_smoke.py`` alone, for one checkout or several.

    python -m outline_rag_tpu_torch.tools.decoder_control [--logs LOGS] [DIR ...]

Host-bound decode times move by 2x between machines and runs, so the decoder
numbers of two trees can be compared only when both run on one machine, one
after the other.
Each ``DIR`` (default: the current directory) is a checkout of this
repository that holds a ``chip_smoke.py``; for each, in the order given, a
fresh process starts in that directory, builds that checkout's kernels and
runs its ``chip_smoke.decoder_phase`` and nothing before it: no kernel phase,
no CUDA-graph capture, no ring of cold weights. Give a directory twice, or
an older checkout on both sides of a newer one (``old new new old``), to see
the spread beside the difference.

One JSON line a run is printed: the checkout, the card's name and power
limit, and for every configuration the burst's tokens a second, its timed
decode step and the ``decode_profile`` step, device time and launches. With
``--logs`` the whole output of run ``i`` goes to
``LOGS/decoder_control_<i>.log``.
Run it on a machine with one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from outline_rag_tpu_torch.tools.timing import card

# what chip_smoke.main() does before its decoder phase, and nothing else
_RUN = """
import os, sys
sys.path.insert(0, os.getcwd())
os.environ["DECODER_INT8_MODE"] = "kernel"
os.environ["DECODER_INT4_MODE"] = "w4a8"
import torch
import chip_smoke
from outline_rag_tpu_torch.device import resolve_device
from outline_rag_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = resolve_device("cuda")
_build.build_library()
chip_smoke.decoder_phase(torch, dev, 0)
"""

BURST_KEYS = ("tokens_per_s", "decode_step_ms", "ttft_p50_ms", "wall_s")
PROFILE_KEYS = ("decode_step_ms", "device_ms_per_step", "launches_per_step")


def summarize(lines: list[str]) -> dict:
    """The burst and profile numbers of every configuration, from the JSON
    lines that a decoder phase printed."""
    out: dict[str, dict] = {}
    for line in lines:
        try:
            row = json.loads(line)
        except ValueError:
            continue
        if not isinstance(row, dict) or "config" not in row:
            continue
        keys = {"decoder": BURST_KEYS, "decode_profile": PROFILE_KEYS}.get(row.get("phase"))
        if keys:
            prefix = "burst_" if row["phase"] == "decoder" else "profile_"
            out.setdefault(row["config"], {}).update(
                {prefix + k: row[k] for k in keys if k in row})
    return out


def run_checkout(directory: Path, log: Path | None) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-c", _RUN], cwd=directory, env=env,
                          capture_output=True, text=True, check=False)
    if log is not None:
        log.write_text(done.stdout + "\n--- stderr ---\n" + done.stderr)
    if done.returncode != 0:
        raise RuntimeError(f"the decoder phase of {directory} failed:\n" + done.stderr[-2000:])
    return {"checkout": str(directory), "seconds": time.perf_counter() - t0,
            "configs": summarize(done.stdout.splitlines())}


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--logs", type=Path, default=None)
    parser.add_argument("checkouts", nargs="*", type=Path, default=[Path(".")])
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("decoder_control: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if args.logs is not None:
        args.logs.mkdir(parents=True, exist_ok=True)
    smi = card()
    for i, directory in enumerate(args.checkouts):
        log = None if args.logs is None else args.logs / f"decoder_control_{i}.log"
        print(json.dumps({"run": i, **run_checkout(directory.resolve(), log), "card": smi}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
