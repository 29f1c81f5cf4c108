"""The port's paged attention and KV page write on the CPU (their plain
twins) against the JAX package: the Pallas page walks in interpret mode
(``head``, ``page``, ``dma``), the XLA gather reference and the scatter
oracle, on the same numpy inputs. The JAX pool is ``[P, KvH, Dh, page]``,
the port's ``[P, KvH, page, Dh]``; the tests transpose.

Tolerances: f32 1e-5 on outputs of order 1 (the sums run in another order);
bf16 the flash bound's form, each element within 2e-3 + 2 bf16 ulps of the
JAX kernel's and the error's norm within 1e-2 of the output's (the twin
rounds p against the row max, the kernel against a running max); int8 pools
3e-5 (f32 products). The write is byte-equal on every page but the scratch
page 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outline_rag_tpu.ops import paged_attention as jpa
from outline_rag_tpu_torch.ops import _build
from outline_rag_tpu_torch.ops.paged_attention import (
    MASKED,
    SPLIT,
    SPLIT_CLUSTER,
    paged_attention,
    paged_attention_plain,
    paged_kv_write,
    paged_kv_write_plain,
)
from outline_rag_tpu_torch.testing import flash_errors

VARIANTS = ["head", "page", "dma"]


def to_torch(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def pool_to_torch(pool, dtype=None):
    """[P, KvH, Dh, page] (JAX) -> [P, KvH, page, Dh] (port)."""
    return to_torch(np.asarray(pool).transpose(0, 1, 3, 2), dtype).contiguous()


def setup(b=2, t=3, h=8, kvh=4, dh=64, pages=16, page=128, maxp=4, seed=0, pos=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    pool_k = rng.standard_normal((pages, kvh, dh, page)).astype(np.float32)
    pool_v = rng.standard_normal((pages, kvh, dh, page)).astype(np.float32)
    # each row owns maxp distinct pages, scattered through the pool
    table = np.stack([rng.permutation(pages)[:maxp] for _ in range(b)]).astype(np.int32)
    if pos is None:
        pos = rng.integers(0, maxp * page - t, size=(b,))
    return q, pool_k, pool_v, table, np.asarray(pos, np.int32)


def quantize_pool(pool):
    """Symmetric per-token per-head int8 of an f32 JAX-layout pool:
    (int8 [P, KvH, Dh, page], f32 scales [P, KvH, page])."""
    a = np.max(np.abs(pool), axis=-2, keepdims=True)
    s = (a / 127.0 + 1e-12).astype(np.float32)
    return np.clip(np.round(pool / s), -127, 127).astype(np.int8), s[..., 0, :]


def port_attention(q, pool_k, pool_v, table, pos, k_s=None, v_s=None, dtype=torch.float32,
                   fn=paged_attention):
    kv_dtype = torch.int8 if k_s is not None else dtype
    scales = () if k_s is None else (to_torch(k_s), to_torch(v_s))
    out = fn(to_torch(q, dtype), pool_to_torch(pool_k, kv_dtype), pool_to_torch(pool_v, kv_dtype),
             to_torch(table), to_torch(pos), *scales)
    assert out.dtype == dtype and tuple(out.shape) == q.shape
    return out.float().numpy()


CASES = {
    "t1": dict(t=1, seed=1),
    "t5": dict(t=5, seed=5),
    "t64": dict(t=64, b=1, seed=64),
    "scattered_rows_diverge": dict(b=3, t=2, pages=32, maxp=6, seed=7),
    "rows_shorter_than_a_page": dict(b=3, t=2, pages=32, maxp=6, seed=9, pos=[0, 5, 117]),
    "pos_zero": dict(b=1, t=1, seed=3, pos=[0]),
    "capacity_edge": dict(b=2, t=4, seed=4, pos=[4 * 128 - 4, 4 * 128 - 5]),
}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret_f32(case, variant):
    args = setup(**CASES[case])
    want = np.asarray(jpa.paged_attention(*map(jnp.asarray, args), interpret=True, variant=variant))
    got = port_attention(*args)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_xla_reference_f32(case):
    args = setup(**CASES[case])
    want = np.asarray(jpa.paged_attention_xla(*map(jnp.asarray, args)))
    np.testing.assert_allclose(port_attention(*args), want, atol=1e-5, rtol=1e-5)


def test_pos_zero_attends_single_slot():
    q, pool_k, pool_v, table, pos = setup(**CASES["pos_zero"])
    got = port_attention(q, pool_k, pool_v, table, pos)
    v0 = pool_v[table[0, 0], :, :, 0]  # [KvH, Dh]: slot 0 of the row's first page
    np.testing.assert_allclose(got[0, 0], np.repeat(v0, 2, axis=0), atol=1e-6)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", ["t1", "t5", "t64", "rows_shorter_than_a_page"])
def test_plain_matches_pallas_interpret_bf16(case, variant):
    q, pool_k, pool_v, table, pos = setup(**CASES[case])
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16)  # noqa: E731
    want = jpa.paged_attention(bf(q), bf(pool_k), bf(pool_v), jnp.asarray(table),
                               jnp.asarray(pos), interpret=True, variant=variant)
    want = to_torch(want.astype(jnp.float32))
    got = port_attention(q, pool_k, pool_v, table, pos, dtype=torch.bfloat16)
    errs = flash_errors(torch.from_numpy(got), want, 2e-3, 2.0)
    assert errs["worst_vs_bound"] <= 1.0 and errs["rel_rms_err"] <= 1e-2, errs


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", ["t1", "t5", "capacity_edge"])
def test_plain_matches_pallas_interpret_int8_pool(case, variant):
    q, pool_k, pool_v, table, pos = setup(**CASES[case])
    (k_q, k_s), (v_q, v_s) = quantize_pool(pool_k), quantize_pool(pool_v)
    want = np.asarray(jpa.paged_attention(
        *map(jnp.asarray, (q, k_q, v_q, table, pos, k_s, v_s)), interpret=True, variant=variant))
    got = port_attention(q, k_q, v_q, table, pos, k_s, v_s)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)
    ref = np.asarray(jpa.paged_attention_xla(*map(jnp.asarray, (q, k_q, v_q, table, pos, k_s, v_s))))
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=3e-5)


def test_inactive_rows_read_scratch_and_stay_finite():
    q, pool_k, pool_v, table, pos = setup(b=3, t=1, seed=2)
    table[1] = 0  # an inactive row: every entry names the scratch page
    got = port_attention(q, pool_k, pool_v, table, pos)
    assert np.isfinite(got).all()
    want = np.asarray(jpa.paged_attention_xla(*map(jnp.asarray, (q, pool_k, pool_v, table, pos))))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_wrapper_on_cpu_is_the_twin_and_checks_its_inputs():
    args = setup(t=2, seed=8)
    np.testing.assert_array_equal(port_attention(*args), port_attention(*args, fn=paged_attention_plain))
    q, pool_k, pool_v, table, pos = args
    tq, tk, tv = to_torch(q), pool_to_torch(pool_k), pool_to_torch(pool_v)
    with pytest.raises(ValueError, match="table must be int32"):
        paged_attention(tq, tk, tv, to_torch(table).long(), to_torch(pos))
    with pytest.raises(ValueError, match="pos must be int32"):
        paged_attention(tq, tk, tv, to_torch(table), to_torch(pos)[:1])
    with pytest.raises(ValueError, match="int8 pools, and only they"):
        paged_attention(tq, tk.to(torch.int8), tv.to(torch.int8), to_torch(table), to_torch(pos))
    with pytest.raises(ValueError, match="must be q's"):
        paged_attention(tq, tk.bfloat16(), tv.bfloat16(), to_torch(table), to_torch(pos))
    with pytest.raises(ValueError, match="does not fit a pool"):
        paged_attention(tq[..., :32], tk, tv, to_torch(table), to_torch(pos))


# ----------------------------------------------------------------------
# the kernel's split and fold, in plain torch
# ----------------------------------------------------------------------

EMPTY = -1e30  # m of a row that has seen no key


def split_partials(q, pool_k, pool_v, table, pos):
    """Each ``SPLIT``-slot split's softmax state over an f32 pool, as the
    kernel keeps it: ``m`` [B, T, H, S] over the keys a row may see (EMPTY
    if none), ``l`` the sum of ``exp(s - m)`` over them, ``acc`` [B, T, H,
    S, Dh] the same weights times v."""
    b, t, h, dh = q.shape
    _, kvh, page, _ = pool_k.shape
    c = table.shape[1] * page
    n_splits = -(-c // SPLIT)
    tbl = table.long()
    kc, vc = (pool[tbl].permute(0, 2, 1, 3, 4).reshape(b, kvh, c, dh) for pool in (pool_k, pool_v))
    s = torch.einsum("btngd,bncd->btngc", q.reshape(b, t, kvh, h // kvh, dh), kc) / dh**0.5
    positions = pos.long()[:, None] + torch.arange(t)[None, :]
    live = (torch.arange(c)[None, None, :] <= positions[:, :, None])[:, :, None, None, :]
    live = live.expand_as(s)
    pad = n_splits * SPLIT - c
    s, live = (torch.nn.functional.pad(x, (0, pad)) for x in (s, live))
    vc = torch.nn.functional.pad(vc, (0, 0, 0, pad))
    s, live = s.reshape(*s.shape[:-1], n_splits, SPLIT), live.reshape(*live.shape[:-1], n_splits, SPLIT)
    m = torch.where(live, s, torch.full_like(s, EMPTY)).amax(dim=-1)
    p = torch.where(live, torch.exp(s - m[..., None]), torch.zeros_like(s))
    acc = torch.einsum("btngsj,bnsjd->btngsd", p, vc.reshape(b, kvh, n_splits, SPLIT, dh))
    return (m.reshape(b, t, h, n_splits), p.sum(dim=-1).reshape(b, t, h, n_splits),
            acc.reshape(b, t, h, n_splits, dh))


def fold(m, l, acc):
    """Partials [..., S] (acc [..., S, Dh]) folded in split order."""
    big_m = m.amax(dim=-1)
    tot_l, tot_acc = torch.zeros_like(l[..., 0]), torch.zeros_like(acc[..., 0, :])
    for i in range(m.shape[-1]):
        w = torch.exp(m[..., i] - big_m)
        tot_l = tot_l + l[..., i] * w
        tot_acc = tot_acc + acc[..., i, :] * w[..., None]
    return big_m, tot_l, tot_acc


def split_fold_reference(q, pool_k, pool_v, table, pos):
    """The kernel's function by its own arithmetic: block c of a cluster
    folds splits c, c + SPLIT_CLUSTER, ... in order into one state, and the
    blocks' states are folded in block order (split order up to
    SPLIT_CLUSTER splits)."""
    m, l, acc = split_partials(q, pool_k, pool_v, table, pos)
    blocks = [fold(m[..., c::SPLIT_CLUSTER], l[..., c::SPLIT_CLUSTER], acc[..., c::SPLIT_CLUSTER, :])
              for c in range(min(SPLIT_CLUSTER, m.shape[-1]))]
    bm, bl, ba = zip(*blocks)
    _, l, acc = fold(torch.stack(bm, dim=-1), torch.stack(bl, dim=-1), torch.stack(ba, dim=-2))
    return acc / torch.where(l <= 0, torch.ones_like(l), l)[..., None]


SPLIT_CASES = {
    # T = 1 at each side of the first and second split boundary
    "t1_boundaries": dict(b=5, t=1, maxp=8, seed=21, pos=[254, 255, 256, 511, 512]),
    # speculative windows: rows whose horizon lies before a split their window walks
    "t4_window": dict(b=4, t=4, maxp=8, seed=22, pos=[253, 254, 509, 766]),
    "t64_chunk": dict(b=2, t=64, maxp=8, seed=23, pos=[200, 990]),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_fold_reference_matches_pallas_interpret_f32(case):
    """The split-and-fold arithmetic computes the Pallas kernel's function:
    a row's splits at multiples of SPLIT slots, folded in order, at positions
    that straddle split boundaries."""
    args = setup(pages=16, **SPLIT_CASES[case])
    want = np.asarray(jpa.paged_attention(*map(jnp.asarray, args), interpret=True))
    q, pool_k, pool_v, table, pos = args
    got = split_fold_reference(to_torch(q), pool_to_torch(pool_k), pool_to_torch(pool_v),
                               to_torch(table), to_torch(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_split_fold_reference_past_a_cluster_matches_the_twin_f32():
    """More splits than a cluster has blocks (2,560 slots in pages of 16):
    block c folds splits c, c + 8, ... first; the result is still the
    function the twin computes."""
    q, pool_k, pool_v, table, pos = setup(b=3, t=2, page=16, pages=200, maxp=160, seed=24,
                                          pos=[2300, 1800, 300])
    args = (to_torch(q), pool_to_torch(pool_k), pool_to_torch(pool_v), to_torch(table), to_torch(pos))
    np.testing.assert_allclose(split_fold_reference(*args).numpy(),
                               paged_attention_plain(*args).numpy(), atol=1e-5, rtol=1e-5)


def test_an_empty_split_folds_to_a_bit_identical_result():
    """A split past every key a row may see leaves (-1e30, 0, 0), and
    folding it in, at the end or between live splits, changes no bit."""
    q, pool_k, pool_v, table, pos = setup(b=2, t=4, pages=16, maxp=8, seed=25, pos=[254, 700])
    m, l, acc = split_partials(to_torch(q), pool_to_torch(pool_k), pool_to_torch(pool_v),
                               to_torch(table), to_torch(pos))
    # row 0 at t = 0, 1 sees slots up to 254, 255: splits 1-3 are empty
    assert bool((m[0, :2, :, 1:] == EMPTY).all())
    assert bool((l[0, :2, :, 1:] == 0).all()) and bool((acc[0, :2, :, 1:] == 0).all())
    live = fold(m[..., :1], l[..., :1], acc[..., :1, :])
    with_empty = fold(m, l, acc)
    for a, b in zip(live[1:], with_empty[1:]):
        assert torch.equal(a[0, :2], b[0, :2])
    empty = (torch.full_like(m[..., :1], EMPTY), torch.zeros_like(l[..., :1]),
             torch.zeros_like(acc[..., :1, :]))
    between = fold(torch.cat([m[..., :1], empty[0], m[..., 1:]], dim=-1),
                   torch.cat([l[..., :1], empty[1], l[..., 1:]], dim=-1),
                   torch.cat([acc[..., :1, :], empty[2], acc[..., 1:, :]], dim=-2))
    for a, b in zip(with_empty, between):
        assert torch.equal(a, b)
    assert MASKED > EMPTY  # a masked logit never stands for a row that saw no key


def test_the_kernel_names_the_same_split_and_cluster():
    """``SPLIT`` and ``SPLIT_CLUSTER`` are the kernel's ``SPLIT`` and
    ``CLUSTER``: the split reference and the card tests read them here."""
    text = (_build.CSRC_DIR / "paged_attention.cu").read_text()
    assert f"constexpr int SPLIT = {SPLIT};" in text
    assert f"constexpr int CLUSTER = {SPLIT_CLUSTER};" in text
    assert f"__cluster_dims__(CLUSTER, 1, 1)" in text


def _paged_source_edits():
    from outline_rag_tpu_torch.tools import kernel_mutants

    for name, (old, new) in kernel_mutants.PAGED_MUTANTS.items():
        if old:
            yield pytest.param((old, new, 1), id=f"mutant-{name}")
    for name, edits in kernel_mutants.PAGED_VARIANTS.items():
        for i, edit in enumerate(edits):
            yield pytest.param(edit, id=f"variant-{name}-{i}")


@pytest.mark.parametrize("edit", list(_paged_source_edits()))
def test_every_paged_mutant_and_variant_edit_applies_to_the_source(edit):
    """``tools/kernel_mutants.py`` edits a copy of ``csrc/paged_attention.cu``
    and refuses an edit whose text occurs another number of times."""
    old, new, occurrences = edit
    assert old != new
    assert (_build.CSRC_DIR / "paged_attention.cu").read_text().count(old) == occurrences


def test_decoder_control_paged_mode_reads_its_line():
    """``tools/decoder_control.py --paged`` runs a snippet in each checkout
    that prints one line of device times and bounds; the summary keeps it."""
    import json

    from outline_rag_tpu_torch.tools import decoder_control

    timed = {"bf16_b64_t1": {"device_ms": 0.1, "bound_ms": 0.02, "bound_by": "bytes"}}
    line = json.dumps({"config": "paged_attention", "phase": "paged", **timed})
    assert decoder_control.summarize(["noise", line]) == {"paged_attention": timed}
    assert "import jax" not in decoder_control._PAGED
    assert "paged_bound" in decoder_control._PAGED and "cuda_ms_many" in decoder_control._PAGED


# ----------------------------------------------------------------------
# KV page write
# ----------------------------------------------------------------------


def write_setup(b=3, t=1, kvh=4, dh=64, pages=16, page=128, maxp=4, seed=0, quant=False,
                straddle=False):
    rng = np.random.default_rng(seed)
    if quant:
        draw = lambda *s: rng.integers(-127, 128, s).astype(np.int8)  # noqa: E731
        scales = tuple(rng.random(s).astype(np.float32) for s in
                       ((pages, kvh, page), (pages, kvh, page), (b, t, kvh), (b, t, kvh)))
    else:
        draw = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
        scales = ()
    pool_k, pool_v = draw(pages, kvh, dh, page), draw(pages, kvh, dh, page)
    k_new, v_new = draw(b, t, kvh, dh), draw(b, t, kvh, dh)
    # page 0 reserved for scratch; rows own disjoint live pages
    table = (rng.permutation(pages - 1) + 1)[: b * maxp].reshape(b, maxp).astype(np.int32)
    if straddle:
        # start mid-page so a T > 1 chunk spans a page boundary; row 0 runs
        # off the table's end (capacity guard -> scratch page 0)
        pos = np.array([maxp * page - max(1, t // 2)]
                       + [page - 1 - (i % page) for i in range(1, b)], np.int32)
        pos = np.minimum(pos, maxp * page - 1)
    else:
        pos = rng.integers(0, maxp * page - t, size=(b,)).astype(np.int32)
    return (pool_k, pool_v, table, pos, k_new, v_new) + scales


def port_write(args, fn=paged_kv_write):
    pool_k, pool_v, table, pos, k_new, v_new, *scales = args
    targs = [pool_to_torch(pool_k), pool_to_torch(pool_v), to_torch(table), to_torch(pos),
             to_torch(k_new), to_torch(v_new), *map(to_torch, scales)]
    out = fn(*targs)
    assert out[0] is targs[0] and out[1] is targs[1]  # in place, and returned
    if scales:
        assert out[2] is targs[6] and out[3] is targs[7]
    pools = [t.numpy().transpose(0, 1, 3, 2) for t in out[:2]]
    return pools + [t.numpy() for t in out[2:]]


WRITE_CASES = {
    "t1": dict(t=1, seed=1),
    "t8_straddle": dict(t=8, straddle=True, seed=8),
    "t64": dict(t=64, seed=64),
    "t160_straddle_out_of_range_tail": dict(t=160, straddle=True, seed=160),
    "dh128_offset_start": dict(t=96, dh=128, kvh=2, straddle=True, seed=3),
    "int8_t1": dict(t=1, quant=True, straddle=True, seed=8),
    "int8_t64": dict(t=64, quant=True, straddle=True, seed=71),
}


@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_kv_write_matches_pallas_interpret_and_scatter_oracle(case):
    args = write_setup(**WRITE_CASES[case])
    got = port_write(args)
    kernel = jpa.paged_kv_write(*map(jnp.asarray, args), interpret=True)
    oracle = jpa._paged_kv_write_xla(*map(jnp.asarray, args))
    assert len(got) == len(kernel) == len(oracle)
    for g, k, o in zip(got, kernel, oracle):
        # page 0 is the scratch target of out-of-range writes: garbage by contract
        np.testing.assert_array_equal(g[1:], np.asarray(k)[1:])
        np.testing.assert_array_equal(g[1:], np.asarray(o)[1:])


def test_out_of_range_tail_goes_to_scratch_not_the_last_page():
    args = write_setup(t=16, b=1, straddle=True, seed=5)  # starts 8 before capacity
    pool_k, _, table, pos, k_new, *_ = args
    got_k = port_write(args)[0]
    last = table[0, -1]
    np.testing.assert_array_equal(got_k[last][:, :, -8:], k_new[0, :8].transpose(1, 2, 0))
    np.testing.assert_array_equal(got_k[last][:, :, :-8], pool_k[last][:, :, :-8])


def test_write_wrapper_on_cpu_is_the_twin_and_checks_its_inputs():
    args = write_setup(t=8, straddle=True, seed=11)
    for g, w in zip(port_write(args), port_write(args, fn=paged_kv_write_plain)):
        np.testing.assert_array_equal(g[1:], w[1:])
    pool_k, pool_v, table, pos, k_new, v_new = (
        pool_to_torch(args[0]), pool_to_torch(args[1]), *map(to_torch, args[2:]))
    with pytest.raises(ValueError, match="do not fit a pool"):
        paged_kv_write(pool_k, pool_v, table, pos, k_new.bfloat16(), v_new.bfloat16())
    with pytest.raises(ValueError, match="int8 pools, and only they"):
        paged_kv_write(pool_k, pool_v, table, pos, k_new, v_new,
                       torch.zeros(16, 4, 128), torch.zeros(16, 4, 128))
    qargs = write_setup(t=1, quant=True, seed=2)
    tq = [pool_to_torch(qargs[0]), pool_to_torch(qargs[1]), *map(to_torch, qargs[2:])]
    with pytest.raises(ValueError, match="ks_new must be f32"):
        paged_kv_write(*tq[:8], None, tq[9])
