"""Parity of the port's float scan top-K (fp32, bf16, f32x2) with the JAX
package's Pallas kernel in interpret mode, in both orientations, and of the
compensated split with the JAX one.

Inputs come from numpy with a seed and go to both packages. On CPU tensors
``topk_float`` runs its plain PyTorch twin; the CUDA kernel itself is held
to that twin on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``). Tolerance: values within 1e-5 (the f32 sums run in
another order than the TPU kernel's, so they are not bit-equal); rows equal
wherever the reference's neighbouring values are more than 1e-5 apart.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from outline_rag_tpu.ops.topk import join_bf16x2 as jax_join
from outline_rag_tpu.ops.topk import split_f32_bf16x2 as jax_split
from outline_rag_tpu.ops.topk import topk_pallas
from outline_rag_tpu_torch.ops.topk import (
    NEG,
    cosine_topk,
    float_mode,
    join_bf16x2,
    split_f32_bf16x2,
    topk_float,
    topk_float_plain,
)
from outline_rag_tpu_torch.testing import tie_aware_mismatches

torch.set_num_threads(1)

N, D = 2048, 64
BLOCK_N = 256  # divides N
TOL = 1e-5
DUPS = [5, 100, 900, 1999]  # row 5 and three copies of it


def _case(seed, b, n_live=None):
    """Seeded unit rows with 5% tombstones and three copies of row 5
    (query 0 is row 5, so the four rows tie at its top)."""
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((N, D)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    corpus[DUPS] = corpus[DUPS[0]]
    q = rng.standard_normal((b, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = corpus[DUPS[0]]
    penalty = np.where(rng.random(N) < 0.05, NEG, 0.0).astype(np.float32)
    penalty[DUPS] = 0.0
    if n_live is not None:
        penalty[:] = NEG
        penalty[rng.choice(N, n_live, replace=False)] = 0.0
    return q, corpus, penalty


def _stored(corpus, mode):
    """The corpus as each package stores it for ``mode``."""
    if mode == "fp32":
        return jnp.asarray(corpus), torch.from_numpy(corpus)
    if mode == "bf16":
        return jnp.asarray(corpus).astype(jnp.bfloat16), torch.from_numpy(corpus).to(torch.bfloat16)
    return jax_split(jnp.asarray(corpus)), split_f32_bf16x2(torch.from_numpy(corpus))


def _jax(q, jcorpus, penalty, k, orientation):
    v, i = topk_pallas(
        jnp.asarray(q), jcorpus, k, jnp.asarray(penalty), block_n=BLOCK_N,
        interpret=True, orientation=orientation,
    )
    return np.array(v), np.array(i)


def test_split_is_byte_equal_to_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, 96)).astype(np.float32)
    x[0, :4] = [0.0, -0.0, 1e-30, 3.0e38]
    want = np.asarray(jax_split(jnp.asarray(x))).view(np.uint16)
    got = split_f32_bf16x2(torch.from_numpy(x)).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)
    joined = join_bf16x2(split_f32_bf16x2(torch.from_numpy(x))).numpy()
    np.testing.assert_array_equal(joined, np.asarray(jax_join(jax_split(jnp.asarray(x)))))
    np.testing.assert_allclose(joined, x, rtol=2**-16, atol=0)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "f32x2"])
@pytest.mark.parametrize(
    # the cmajor reference runs K extraction passes per tile: kept small
    "orientation,b,k", [("qmajor", 8, 12), ("qmajor", 40, 64), ("cmajor", 8, 12), ("cmajor", 24, 20)]
)
def test_float_scan_matches_pallas_interpret(mode, orientation, b, k):
    q, corpus, penalty = _case(b * 100 + k, b)
    jcorpus, pcorpus = _stored(corpus, mode)
    jv, ji = _jax(q, jcorpus, penalty, k, orientation)
    pv, pi = cosine_topk(torch.from_numpy(q), pcorpus, k, torch.from_numpy(penalty),
                         orientation=orientation)
    assert tuple(pv.shape) == tuple(pi.shape) == (b, k)
    assert pi.dtype == torch.int32
    assert tie_aware_mismatches(pv, pi, jv, ji, TOL) == 0
    # the duplicated rows tie exactly at query 0's top, lowest row first
    assert pi[0, :4].tolist() == DUPS and len(set(pv[0, :4].tolist())) == 1


@pytest.mark.parametrize("mode", ["fp32", "bf16", "f32x2"])
@pytest.mark.parametrize("orientation,k", [("qmajor", 64), ("cmajor", 20)])
def test_float_scan_dead_slots_match_pallas_interpret(mode, orientation, k):
    """Fewer live rows than K: the unfilled slots are (NEG, 0) in both."""
    q, corpus, penalty = _case(3, 8, n_live=10)
    jcorpus, pcorpus = _stored(corpus, mode)
    jv, ji = _jax(q, jcorpus, penalty, k, orientation)
    pv, pi = cosine_topk(torch.from_numpy(q), pcorpus, k, torch.from_numpy(penalty),
                         orientation=orientation)
    assert tie_aware_mismatches(pv, pi, jv, ji, TOL) == 0
    assert (pv[:, 10:] == NEG).all() and (pi[:, 10:] == 0).all()
    assert (pv[:, :10] > NEG / 2).all()


def test_cosine_topk_dispatch():
    """The mode follows the JAX package's _is_compensated rule."""
    q = torch.zeros((2, 64))
    assert float_mode(q, torch.zeros((4, 64))) == "fp32"
    assert float_mode(q, torch.zeros((4, 64), dtype=torch.bfloat16)) == "bf16"
    assert float_mode(q, torch.zeros((4, 128), dtype=torch.bfloat16)) == "f32x2"
    assert float_mode(q.to(torch.bfloat16), torch.zeros((4, 128), dtype=torch.bfloat16)) == "bf16"
    with pytest.raises(ValueError, match="f32 or bf16"):
        float_mode(q, torch.zeros((4, 64), dtype=torch.int8))


def test_bf16_mode_casts_the_queries_first():
    """bf16 mode scores bf16(query) . row, as the Pallas wrapper casts the
    queries to the corpus dtype."""
    q, corpus, penalty = _case(11, 8)
    c16 = torch.from_numpy(corpus).to(torch.bfloat16)
    got = cosine_topk(torch.from_numpy(q), c16, 12, torch.from_numpy(penalty))
    want = topk_float_plain(torch.from_numpy(q).to(torch.bfloat16), c16, 12,
                            torch.from_numpy(penalty), "bf16")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_topk_float_on_cpu_runs_the_plain_twin():
    q, corpus, penalty = _case(4, 8)
    before = dict(topk_float.launches)
    for mode in ("fp32", "bf16", "f32x2"):
        _, pcorpus = _stored(corpus, mode)
        pq = split_f32_bf16x2(torch.from_numpy(q)) if mode == "f32x2" else torch.from_numpy(q).to(pcorpus.dtype)
        got = topk_float(pq, pcorpus, 12, torch.from_numpy(penalty), mode)
        want = topk_float_plain(pq, pcorpus, 12, torch.from_numpy(penalty), mode)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert topk_float.launches == before  # no kernel launch on the CPU


def test_topk_float_refuses_bad_arguments():
    q = torch.zeros((2, 64))
    c = torch.zeros((8, 64))
    with pytest.raises(ValueError, match="mode"):
        topk_float(q, c, 2, mode="f16")
    with pytest.raises(ValueError, match="orientation"):
        topk_float(q, c, 2, orientation="rows")
    with pytest.raises(ValueError, match="cpu or cuda"):
        topk_float(q.to("meta"), c.to("meta"), 2)


def test_tie_aware_mismatches_counts_only_real_disagreements():
    ref_v = torch.tensor([[0.9, 0.5, 0.5, 0.1, NEG]])
    ref_i = torch.tensor([[3, 4, 7, 2, 0]])
    assert tie_aware_mismatches(ref_v, ref_i, ref_v, ref_i, TOL) == 0
    swapped = torch.tensor([[3, 7, 4, 2, 0]])  # a tie swapped: allowed
    assert tie_aware_mismatches(ref_v, swapped, ref_v, ref_i, TOL) == 0
    wrong = torch.tensor([[5, 4, 7, 2, 0]])  # an isolated rank differs
    assert tie_aware_mismatches(ref_v, wrong, ref_v, ref_i, TOL) == 1
    dead = torch.tensor([[3, 4, 7, 2, 9]])  # a dead slot not (NEG, 0)
    assert tie_aware_mismatches(ref_v, dead, ref_v, ref_i, TOL) == 1
    off = ref_v + torch.tensor([[0.0, 0.0, 0.0, 1e-3, 0.0]])
    assert tie_aware_mismatches(off, ref_i, ref_v, ref_i, TOL) == 1


def _shape_constants():
    """The ``Shape`` constants of csrc/topk_float_tile.cuh, by mode."""
    import re

    from outline_rag_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / "topk_float_tile.cuh").read_text()
    shapes = {}
    for mode, body in re.findall(r"struct Shape<(\w+)> \{(.*?)\n\};", text, re.S):
        shapes[mode] = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", body)}
    return text, shapes


def test_float_kernel_constants_match_the_source():
    """The wrapper plans chunks with the kernel's own constants."""
    from outline_rag_tpu_torch.ops import topk

    text, shapes = _shape_constants()
    assert f"constexpr int TB = {topk._FLOAT_KERNEL_TB};" in text
    assert f"constexpr int CHUNK_ROWS = {topk._FLOAT_KERNEL_CHUNK_ROWS};" in text
    assert f"constexpr int DSTEP = {topk._FLOAT_KERNEL_DC};" in text
    by_mode = {"FP32": "fp32", "BF16": "bf16", "F32X2": "f32x2"}
    float_shapes = {by_mode[m]: s["MIN_BLOCKS"] for m, s in shapes.items() if m in by_mode}
    assert float_shapes == topk._FLOAT_RESIDENT
    for s in shapes.values():  # every tile divides a chunk
        assert topk._FLOAT_KERNEL_CHUNK_ROWS % s["TN"] == 0


@pytest.mark.parametrize("mode", ["fp32", "bf16", "f32x2"])
@pytest.mark.parametrize("b,n", [(1, 1), (1, 255), (32, 1_048_576), (33, 70_001), (128, 5_003),
                                 (4096, 20_000)])
def test_float_kernel_plan_covers_every_row_once(monkeypatch, mode, b, n):
    """Whole chunks of 256-row steps, the last one holding a row, one wave of
    the blocks the card holds at once (a 132-SM card)."""
    from outline_rag_tpu_torch.ops import topk

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props())
    chunks, rows = topk._float_kernel_plan(b, n, torch.device("cpu"), mode)
    assert rows % topk._FLOAT_KERNEL_CHUNK_ROWS == 0
    assert (chunks - 1) * rows < n <= chunks * rows
    q_tiles = -(-b // topk._FLOAT_KERNEL_TB)
    assert chunks * q_tiles <= max(q_tiles, topk._FLOAT_RESIDENT[mode] * 132)


def _topk_mutant_edits():
    from outline_rag_tpu_torch.tools import kernel_mutants

    for name, (files, _) in kernel_mutants.TOPK_MUTANTS.items():
        for source, edits in files.items():
            for i, edit in enumerate(edits):
                yield pytest.param(source, edit, id=f"{name}-{i}")


@pytest.mark.parametrize("source,edit", list(_topk_mutant_edits()))
def test_every_topk_float_mutant_edit_applies_to_the_source(source, edit):
    """The card tool edits copies of ``csrc/topk_float.cu`` and its headers
    and refuses an edit whose text occurs another number of times: each one
    still finds its line, and changes it."""
    from outline_rag_tpu_torch.ops import _build

    old, new, occurrences = edit
    assert old != new
    assert (_build.CSRC_DIR / source).read_text().count(old) == occurrences


def test_every_topk_float_mutant_reaches_a_mode():
    from outline_rag_tpu_torch.tools import kernel_mutants

    assert "topk_float" in kernel_mutants.KERNELS
    for name, (files, modes) in kernel_mutants.TOPK_MUTANTS.items():
        assert set(modes) <= {"fp32", "bf16", "f32x2"} and modes
        assert (name == "as_is") == (not files)
