"""Multi-process index builds and data-parallel training in the port
(``outline_rag_tpu_torch/parallel/multihost.py``, ``models/train.py::
make_dp_train_step``) over ``torch.distributed`` with the ``gloo`` backend:
two processes on this machine, each with a time limit of its own.

- ``build_and_query_demo`` (mirrors ``tests/test_multihost.py``): each
  process makes its slice, the global sharded query gives the same answer on
  both, equal to a single-process scan of the union bit for bit and to the
  numpy oracle within 2e-5 (the JAX test's tolerance);
- the data-parallel contrastive step over two processes gives the
  single-device step's loss (rtol 1e-5, as
  ``tests/test_train.py::test_dp_sharded_step_matches_single``), its
  gradient (read back from AdamW's first moment) within 1e-5 relative L2 of
  the single-device gradient in every leaf and, after the update, its
  parameters within 1e-6;
- the padding and slicing arithmetic of ``global_row_sharded`` /
  ``host_slice`` without processes.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from outline_rag_tpu_torch.ops.topk import NEG
from outline_rag_tpu_torch.parallel import data_mesh
from outline_rag_tpu_torch.parallel.multihost import (
    ProcessMesh,
    _host_slice,
    global_row_sharded,
    init_multihost,
)

ROOT = Path(__file__).resolve().parents[1]
WAIT = 300  # seconds a process may take

_DEMO = r"""
import json, sys
import numpy as np
from outline_rag_tpu_torch.parallel.multihost import (
    build_and_query_demo, host_slice, init_multihost, process_count,
)
coord, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
init_multihost(coord, 2, pid, backend="gloo")
assert process_count() == 2
rng = np.random.default_rng(99)
queries = rng.standard_normal((8, 64)).astype(np.float32)
queries /= np.linalg.norm(queries, axis=1, keepdims=True)
vals, idx = build_and_query_demo(chunks_per_host=4096, dim=64, queries=queries, k=5,
                                 devices=["cpu"] * 4)
lo, hi = host_slice(8192)
json.dump({"pid": pid, "slice": [lo, hi], "vals": vals.tolist(), "idx": idx.tolist()},
          open(out_path, "w"))
"""

_DP = r"""
import json, pickle, sys
import numpy as np, torch
from outline_rag_tpu_torch.models import train as tt
from outline_rag_tpu_torch.models.convert import encoder_from_jax
from outline_rag_tpu_torch.models.encoder import EncoderConfig
from outline_rag_tpu_torch.parallel.multihost import init_multihost

coord, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
init_multihost(coord, 2, pid, backend="gloo")
torch.set_num_threads(1)
cfg = EncoderConfig.tiny()
params = pickle.load(open(sys.argv[4], "rb"))  # the JAX package's init, as numpy
rng = np.random.default_rng(1)
b, s = 8, 16
batch = {k: rng.integers(3, cfg.vocab_size, size=(b, s)).astype(np.int64) for k in ("q_ids", "p_ids")}
batch["q_mask"] = np.ones((b, s), np.int64)
batch["p_mask"] = np.ones((b, s), np.int64)
batch["p_mask"][2, 11:] = 0
local = {k: torch.from_numpy(v[pid * 4:(pid + 1) * 4]) for k, v in batch.items()}
opt = tt.make_optimizer(lr=1e-4)
state = tt.init_train_state(encoder_from_jax(params, cfg, device="cpu"), opt)
state, metrics = tt.make_dp_train_step(cfg, opt)(state, local)
json.dump({"loss": float(metrics["loss"]),
           "params": {n: p.detach().numpy().ravel().tolist()[:64]
                      for n, p in state.params.named_parameters()},
           "mu": {n: m.numpy().ravel().tolist() for n, m in state.opt_state.mu.items()}},
          open(out_path, "w"))
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two(tmp_path, script: str, *args: str) -> list[dict]:
    coord = f"127.0.0.1:{_free_port()}"
    worker = tmp_path / "worker.py"
    worker.write_text(script)
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, str(worker), coord, str(i), str(outs[i]), *args], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)
    ]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WAIT)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(logs)
    return [json.loads(o.read_text()) for o in outs]


def test_two_process_build_and_query(tmp_path):
    r0, r1 = _run_two(tmp_path, _DEMO)
    assert r0["vals"] == r1["vals"] and r0["idx"] == r1["idx"]
    assert r0["slice"] == [0, 4096] and r1["slice"] == [4096, 8192]

    rng = np.random.default_rng(99)
    queries = rng.standard_normal((8, 64)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    blocks = []
    for h in range(2):
        b = np.random.default_rng(h).standard_normal((4096, 64)).astype(np.float32)
        blocks.append(b / np.linalg.norm(b, axis=1, keepdims=True))
    corpus = np.concatenate(blocks, axis=0)
    scores = queries @ corpus.T
    want_idx = np.argsort(-scores, axis=1, kind="stable")[:, :5]
    np.testing.assert_allclose(np.asarray(r0["vals"]), np.take_along_axis(scores, want_idx, 1),
                               atol=2e-5, rtol=2e-5)
    assert (np.asarray(r0["idx"]) == want_idx).mean() > 0.99
    # a single process scanning the union: the same rows and values, bit for bit
    from outline_rag_tpu_torch.ops.topk import cosine_topk

    v, i = cosine_topk(torch.from_numpy(queries), torch.from_numpy(corpus), 5)
    assert i.tolist() == r0["idx"] and v.tolist() == r0["vals"]


def test_two_process_dp_contrastive_step_matches_single(tmp_path):
    import jax

    from outline_rag_tpu.models import encoder as je
    from outline_rag_tpu.models import train as jt
    from outline_rag_tpu_torch.models import train as tt
    from outline_rag_tpu_torch.models.convert import encoder_from_jax
    from outline_rag_tpu_torch.models.encoder import EncoderConfig

    cfg = EncoderConfig.tiny()
    params = jax.tree_util.tree_map(np.asarray, je.init_encoder_params(jax.random.key(0),
                                                                       je.EncoderConfig.tiny()))
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(params, f)
    r0, r1 = _run_two(tmp_path, _DP, str(tmp_path / "params.pkl"))
    assert r0 == r1  # every process applied the same update

    rng = np.random.default_rng(1)
    b, s = 8, 16
    batch = {k: rng.integers(3, cfg.vocab_size, size=(b, s)).astype(np.int64)
             for k in ("q_ids", "p_ids")}
    batch["q_mask"] = np.ones((b, s), np.int64)
    batch["p_mask"] = np.ones((b, s), np.int64)
    batch["p_mask"][2, 11:] = 0
    opt = tt.make_optimizer(lr=1e-4)
    state = tt.init_train_state(encoder_from_jax(params, cfg, device="cpu"), opt)
    state, metrics = tt.make_train_step(cfg, opt)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(r0["loss"], float(metrics["loss"]), rtol=1e-5)
    for n, p in state.params.named_parameters():
        np.testing.assert_allclose(r0["params"][n], p.detach().numpy().ravel()[:64], rtol=0,
                                   atol=1e-6)
    # the gradient itself, read back from AdamW's first moment ((1 - b1) * g
    # after one step): the update of a first step, g / |g|, is blind to a
    # gradient counted once per process or averaged, this is not. Each
    # leaf within 1e-5 of the single-device gradient in relative L2.
    for n, m in state.opt_state.mu.items():
        want = m.numpy().ravel()
        got = np.asarray(r0["mu"][n], np.float32)
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want), n
    # and the JAX package's single-device step on the same batch
    jopt = jt.make_optimizer(lr=1e-4)
    jstep = jax.jit(jt.make_train_step(je.EncoderConfig.tiny(), jopt))
    _, jm = jstep(jt.init_train_state(params, jopt),
                  {k: v.astype(np.int32) for k, v in batch.items()})
    np.testing.assert_allclose(r0["loss"], float(jm["loss"]), rtol=1e-5)


def test_global_row_sharded_pads_and_places_blocks():
    """Unequal blocks pad to ceil(n_global / world) rows; penalty rows pad
    with the NEG tombstone; the default n_global assumes equal blocks."""
    local = data_mesh(devices=["cpu", "cpu"])
    last = ProcessMesh(local, rank=2, world=3)
    lo, hi = _host_slice(10, 2, 3)
    assert (lo, hi) == (8, 10)
    rows = np.arange(2 * 4, dtype=np.float32).reshape(2, 4)
    g = global_row_sharded(rows, last, n_global=10)
    assert tuple(g.shape) == (12, 4) and g.rows_per_process == 4
    got = g.local.cpu().numpy()
    np.testing.assert_array_equal(got[:2], rows)
    assert (got[2:] == 0).all()
    pen = global_row_sharded(np.zeros(2, np.float32), last, n_global=10, penalty=True)
    assert (pen.local.cpu().numpy()[2:] == np.float32(NEG)).all()
    assert [b.shape[0] for b in pen.local.blocks] == [2, 2]
    with pytest.raises(ValueError, match="rows a process"):
        global_row_sharded(np.zeros((5, 4), np.float32), last, n_global=10)


def test_init_multihost_needs_its_backend_named():
    init_multihost()  # single process: nothing to join
    with pytest.raises(ValueError, match="backend"):
        init_multihost("127.0.0.1:1", 2, 0)


def test_dryrun_multichip_on_cpu():
    """The port's dry run over four CPU entries: the data-parallel step in
    two gloo processes equal to one device's, the sharded scan, the mesh
    fused query over f32x2 and int8r indexes, and the served TP decode."""
    from outline_rag_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    assert dryrun_multichip(4, "cpu").startswith("dryrun_multichip ok: 4 entries of cpu")
