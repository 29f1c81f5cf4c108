"""The decoder phase of ``chip_smoke.py`` alone, for one checkout or several.

    python -m outline_rag_tpu_torch.tools.decoder_control [--logs LOGS] [--paged] [DIR ...]

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
``LOGS/decoder_control_<i>.log``. With ``--paged`` each run times that
checkout's ``paged_attention`` instead, on seeded inputs that are the same
in every checkout: ``device_ms`` (``tools/timing.py::cuda_ms_many``) and
``chip_smoke.paged_bound`` at the three shapes the decoder launches (B = 64,
T = 1 at row lengths 1-2,047; B = 8, T = 4; B = 1, T = 256 from 512), on a
bf16 and an int8 pool.
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

# the paged kernel alone, at the decoder's shapes, on inputs every checkout
# draws alike (``testing.paged_attention_case`` predates this tool)
_PAGED = """
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke
from outline_rag_tpu_torch.ops.paged_attention import paged_attention
from outline_rag_tpu_torch.testing import paged_attention_case
from outline_rag_tpu_torch.tools.timing import cuda_ms_many
dev = torch.device("cuda", torch.cuda.current_device())
g = torch.Generator(device=dev).manual_seed(7)
out = {}
for kv in ("bf16", "int8"):
    lens = torch.randint(1, 2048, (64,), generator=g, device=dev)
    shapes = {"b64_t1": (64, 1, paged_attention_case(dev, g, 64, 1, kv, pos=lens - 1)),
              "b8_t4": (8, 4, paged_attention_case(dev, g, 8, 4, kv)),
              "b1_t256_512": (1, 256, paged_attention_case(dev, g, 1, 256, kv, pos=[512]))}
    for name, (b, t, a) in shapes.items():
        out[kv + "_" + name] = {"device_ms": cuda_ms_many(lambda: paged_attention(*a))["device_ms"],
                                **chip_smoke.paged_bound(b, t, kv, a[4])}
print(json.dumps({"config": "paged_attention", "phase": "paged", **out}))
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
        if row.get("phase") == "paged":
            out["paged_attention"] = {k: v for k, v in row.items() if k not in ("config", "phase")}
            continue
        keys = {"decoder": BURST_KEYS, "decode_profile": PROFILE_KEYS}.get(row.get("phase"))
        if keys:
            prefix = "burst_" if row["phase"] == "decoder" else "profile_"
            out.setdefault(row["config"], {}).update(
                {prefix + k: row[k] for k in keys if k in row})
    return out


def run_checkout(directory: Path, log: Path | None, code: str = _RUN) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-c", code], cwd=directory, env=env,
                          capture_output=True, text=True, check=False)
    if log is not None:
        log.write_text(done.stdout + "\n--- stderr ---\n" + done.stderr)
    if done.returncode != 0:
        raise RuntimeError(f"the run in {directory} failed:\n" + done.stderr[-2000:])
    return {"checkout": str(directory), "seconds": time.perf_counter() - t0,
            "configs": summarize(done.stdout.splitlines())}


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--logs", type=Path, default=None)
    parser.add_argument("--paged", action="store_true",
                        help="time each checkout's paged_attention instead of its decoder phase")
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
        run = run_checkout(directory.resolve(), log, _PAGED if args.paged else _RUN)
        print(json.dumps({"run": i, **run, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
