"""Parity of the port's int8 scan top-K with the JAX package's Pallas
kernel (interpret mode on the CPU), and of its oracle and merge helpers.

Inputs come from numpy with a seed and go to both packages. On CPU tensors
``topk_int8`` runs its plain PyTorch twin; the CUDA kernel itself is held
to that twin on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from outline_rag_tpu.ops.quant import int8_topk as jax_int8_topk
from outline_rag_tpu.ops.topk import merge_topk as jax_merge_topk
from outline_rag_tpu.ops.topk import topk_xla
from outline_rag_tpu_torch.ops import topk as port_topk
from outline_rag_tpu_torch.ops.topk import (
    NEG,
    merge_topk,
    topk_int8,
    topk_int8_plain,
    topk_plain,
)

torch.set_num_threads(1)

N, D = 2048, 64
BLOCK_N = 256


def _int8_case(seed, b, n_dead_frac=0.05, n_live=None):
    """Seeded int8 codes and scales with tombstones, and 9 copies of one
    row (query 0 is that row, so the copies tie at its top)."""
    rng = np.random.default_rng(seed)
    corpus = rng.integers(-127, 128, (N, D), dtype=np.int8)
    cscale = (rng.uniform(0.5, 1.5, N) / 127).astype(np.float32)
    src, dups = 7, rng.choice(np.arange(8, N), 9, replace=False)
    corpus[dups] = corpus[src]
    cscale[dups] = cscale[src]
    q = rng.integers(-127, 128, (b, D), dtype=np.int8)
    q[0] = corpus[src]
    qscale = (rng.uniform(0.5, 1.5, b) / 127).astype(np.float32)
    penalty = np.where(rng.random(N) < n_dead_frac, NEG, 0.0).astype(np.float32)
    penalty[[src, *dups]] = 0.0
    if n_live is not None:
        penalty[:] = NEG
        penalty[rng.choice(N, n_live, replace=False)] = 0.0
    return q, qscale, corpus, cscale, penalty


def _jax_scan(q, qscale, corpus, cscale, penalty, k):
    v, i = jax_int8_topk(
        jnp.asarray(q), jnp.asarray(qscale), jnp.asarray(corpus),
        jnp.asarray(cscale), k, jnp.asarray(penalty), impl="pallas",
        block_n=BLOCK_N,
    )
    return np.asarray(v), np.asarray(i)


def _port_scan(fn, q, qscale, corpus, cscale, penalty, k):
    v, i = fn(
        torch.from_numpy(q), torch.from_numpy(qscale), torch.from_numpy(corpus),
        torch.from_numpy(cscale), k, torch.from_numpy(penalty),
    )
    return v.numpy(), i.numpy()


@pytest.mark.parametrize("b", [5, 37])
@pytest.mark.parametrize("k", [12, 64])
def test_plain_scan_matches_pallas_interpret(b, k):
    case = _int8_case(b * 100 + k, b)
    jv, ji = _jax_scan(*case, k)
    pv, pi = _port_scan(topk_int8_plain, *case, k)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, jv)
    # the duplicated rows tie at query 0's top, lowest row first
    assert list(pi[0, :10]) == sorted(pi[0, :10])


def test_plain_scan_dead_slots_match_pallas_interpret():
    """Fewer live rows than K: the unfilled slots are (NEG, 0) in both."""
    case = _int8_case(3, 8, n_live=10)
    jv, ji = _jax_scan(*case, 64)
    pv, pi = _port_scan(topk_int8_plain, *case, 64)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pv, jv)
    assert (pv[:, 10:] == np.float32(NEG)).all() and (pi[:, 10:] == 0).all()


def test_topk_int8_on_cpu_runs_the_plain_twin():
    case = _int8_case(4, 6)
    before = topk_int8.launches
    pv, pi = _port_scan(topk_int8, *case, 12)
    qv, qi = _port_scan(topk_int8_plain, *case, 12)
    np.testing.assert_array_equal(pi, qi)
    np.testing.assert_array_equal(pv, qv)
    assert topk_int8.launches == before  # no kernel launch on the CPU


def test_topk_int8_refuses_other_devices():
    case = [torch.from_numpy(x).to("meta") for x in _int8_case(5, 2)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        topk_int8(case[0], case[1], case[2], case[3], 12, case[4])


def test_plain_scan_steps_merge_in_row_order(monkeypatch):
    """Scoring in several row steps (merged with merge_topk) gives the
    one-step answer, ties included."""
    case = _int8_case(6, 9)
    whole = _port_scan(topk_int8_plain, *case, 64)
    monkeypatch.setattr(port_topk, "PLAIN_ROWS_PER_STEP", 300)
    stepped = _port_scan(topk_int8_plain, *case, 64)
    np.testing.assert_array_equal(stepped[1], whole[1])
    np.testing.assert_array_equal(stepped[0], whole[0])


def test_topk_plain_matches_topk_xla():
    rng = np.random.default_rng(7)
    c = rng.standard_normal((N, D)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c[100] = c[5]  # a tie
    q = rng.standard_normal((6, D)).astype(np.float32)
    q[0] = c[5]
    pen = np.where(rng.random(N) < 0.1, NEG, 0.0).astype(np.float32)
    pen[[5, 100]] = 0.0
    jv, ji = topk_xla(jnp.asarray(q), jnp.asarray(c), 12, jnp.asarray(pen))
    pv, pi = topk_plain(torch.from_numpy(q), torch.from_numpy(c), 12, torch.from_numpy(pen))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    assert list(pi[0, :2].numpy()) == [5, 100]


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(8)
    va = np.sort(rng.integers(0, 5, (4, 6)).astype(np.float32), axis=1)[:, ::-1].copy()
    vb = np.sort(rng.integers(0, 5, (4, 6)).astype(np.float32), axis=1)[:, ::-1].copy()
    ia = rng.integers(0, 100, (4, 6)).astype(np.int32)
    ib = rng.integers(100, 200, (4, 6)).astype(np.int32)
    jv, ji = jax_merge_topk(*(jnp.asarray(x) for x in (va, ia, vb, ib)), 7)
    pv, pi = merge_topk(*(torch.from_numpy(x) for x in (va, ia, vb, ib)), 7)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


def test_plain_scan_refuses_inexact_width():
    q = torch.zeros((1, 1056), dtype=torch.int8)
    c = torch.zeros((4, 1056), dtype=torch.int8)
    with pytest.raises(ValueError, match="not exact"):
        topk_int8_plain(q, torch.ones(1), c, torch.ones(4), 2)


def _int8_shape():
    """``Shape<INT8>`` and the block constants of csrc/topk_float_tile.cuh."""
    import re

    from outline_rag_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / "topk_float_tile.cuh").read_text()
    body = re.search(r"struct Shape<INT8> \{(.*?)\n\};", text, re.S).group(1)
    return text, {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", body)}


def test_int8_kernel_constants_match_the_source():
    """The wrapper plans the int8 scan's chunks with the kernel's own
    constants: its queries a block, the rows a chunk is a multiple of, and
    the blocks an SM holds; its tile divides a chunk."""
    text, shape = _int8_shape()
    assert f"constexpr int TB = {port_topk._INT8_KERNEL_TB};" in text
    assert f"constexpr int CHUNK_ROWS = {port_topk._INT8_KERNEL_CHUNK_ROWS};" in text
    assert shape["MIN_BLOCKS"] == port_topk._INT8_RESIDENT
    assert port_topk._INT8_KERNEL_CHUNK_ROWS % shape["TN"] == 0
    from outline_rag_tpu_torch.ops import _build

    assert "rows_per_chunk % CHUNK_ROWS" in (_build.CSRC_DIR / "topk_int8.cu").read_text()


@pytest.mark.parametrize("b,n", [(1, 1), (1, 255), (2, 257), (32, 1_048_576), (33, 70_001),
                                 (128, 5_003), (129, 131_072), (4096, 20_000)])
def test_int8_kernel_plan_covers_every_row_once(monkeypatch, b, n):
    """Whole chunks of 256-row steps, the last one holding a row, one wave of
    the blocks a 132-SM card holds at once."""

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props())
    chunks, rows = port_topk._int8_kernel_plan(b, n, torch.device("cpu"))
    assert rows % port_topk._INT8_KERNEL_CHUNK_ROWS == 0
    assert (chunks - 1) * rows < n <= chunks * rows
    q_tiles = -(-b // port_topk._INT8_KERNEL_TB)
    assert chunks * q_tiles <= max(q_tiles, port_topk._INT8_RESIDENT * 132)


def _int8_mutant_edits():
    from outline_rag_tpu_torch.tools import kernel_mutants

    for name, files in kernel_mutants.TOPK_INT8_MUTANTS.items():
        for source, edits in files.items():
            for i, edit in enumerate(edits):
                yield pytest.param(source, edit, id=f"{name}-{i}")


@pytest.mark.parametrize("source,edit", list(_int8_mutant_edits()))
def test_every_topk_int8_mutant_edit_applies_to_the_source(source, edit):
    """The card tool edits copies of ``csrc/topk_int8.cu`` and the headers it
    shares, and refuses an edit whose text occurs another number of times:
    each one still finds its line, and changes it."""
    from outline_rag_tpu_torch.ops import _build

    old, new, occurrences = edit
    assert old != new
    assert (_build.CSRC_DIR / source).read_text().count(old) == occurrences


def test_topk_int8_mutants_are_listed():
    from outline_rag_tpu_torch.tools import kernel_mutants

    assert "topk_int8" in kernel_mutants.KERNELS
    for name, files in kernel_mutants.TOPK_INT8_MUTANTS.items():
        assert (name == "as_is") == (not files)
        assert set(files) <= {"topk_int8.cu", "topk_float_tile.cuh", "topk_common.cuh"}


@pytest.mark.parametrize("b,k", [(5, 12), (37, 64)])
def test_int8_exact_reference_equals_the_twin(b, k):
    """The wide-width reference of the card tool (a float64 dot rounded once)
    is the twin's function wherever the twin is exact."""
    from outline_rag_tpu_torch.tools.kernel_mutants import int8_exact_topk

    case = [torch.from_numpy(x) for x in _int8_case(b + k, b)]
    ev, ei = int8_exact_topk(case[0], case[1], case[2], case[3], k, case[4])
    pv, pi = topk_int8_plain(case[0], case[1], case[2], case[3], k, case[4])
    assert torch.equal(ei, pi) and torch.equal(ev, pv)


def test_int8_threshold_case_wants_the_twins_rows():
    """The threshold case's expected rows and values are the twin's."""
    from outline_rag_tpu_torch.tools.kernel_mutants import int8_threshold_case

    g = torch.Generator().manual_seed(5)
    args, k, want = int8_threshold_case(torch.device("cpu"), g)
    vals, idx = topk_int8_plain(*args[:4], k, args[4])
    assert idx[0].tolist() == want
    assert vals[0].tolist() == [127.0 * 127, 127.0 * 120, 127.0 * 112, 127.0 * 108]
