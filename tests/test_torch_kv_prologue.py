"""The paged layer's attention prologue, ``paged_kv_write_rope`` (rotate q
and k, quantize k and v for an int8 pool, write the pages), on the CPU,
where it runs its plain twin, against the JAX package on the same seeded
numpy inputs: ``_rope`` of q and k, ``_quantize_kv`` of the rotated k and
of v, and ``paged_kv_write`` in interpret mode. The JAX pool is ``[P, KvH,
Dh, page]``, the port's ``[P, KvH, page, Dh]``; the tests transpose.

Both sides get the same cos and sin tables (JAX's), so the check is on the
prologue's own arithmetic. Tolerances: the rotated q and a bf16 pool within
1 bf16 ulp; f32 within 1e-6 relative plus 1e-6 absolute (values of order 1:
a rotation can cancel to near 0); int8 codes within 1; scales within 1e-6
relative. They leave room for a compiler that contracts the rotation into
an FMA or computes ``amax / 127`` as a product by the reciprocal (ATen does
on CUDA tensors); on these inputs the two packages agree bit for bit. Page
0, the scratch page, is garbage by contract and is not compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outline_rag_tpu.models import decoder as jd
from outline_rag_tpu.ops import paged_attention as jpa
from outline_rag_tpu_torch.models import decoder as dec
from outline_rag_tpu_torch.ops import _build
from outline_rag_tpu_torch.ops import paged_attention as pa
from outline_rag_tpu_torch.testing import QUANTIZER_TIES, _bf16_ulp

H, KVH, PAGE, MAXP, THETA = 8, 2, 128, 4, 10000.0
# (B, T, start): a decode step, a speculative window (T = 1 + spec_k), a
# prefill chunk straddling pages, and a chunk whose last 100 tokens pass the
# row's capacity of MAXP * PAGE (they land in page 0)
SHAPES = {"decode": (16, 1, None), "window": (8, 4, None), "chunk": (1, 256, 100),
          "capacity": (2, 256, MAXP * PAGE - 156)}


def make_inputs(b, t, start, dh, pool, seed):
    """Seeded numpy inputs: one fused ``[B, T, (H + 2 KvH) Dh]`` f32 draw of
    q, k and v (token 0 of row 0 carries v heads with .5 ties at scale 1 and
    a maximum of 3.25), pools in the JAX layout (f32 garbage, or int8 codes
    and f32 scales), a scattered page table without page 0, positions."""
    rng = np.random.default_rng(seed)
    nq, nkv = H * dh, KVH * dh
    qkv = (rng.standard_normal((b, t, nq + 2 * nkv)) * 2).astype(np.float32)
    v = qkv[..., nq + nkv:].reshape(b, t, KVH, dh)  # a view: edits land in qkv
    v[0, 0, 0] = np.clip(v[0, 0, 0], -100, 100)
    v[0, 0, 0, : len(QUANTIZER_TIES)] = QUANTIZER_TIES
    v[0, 0, 1] = np.clip(v[0, 0, 1], -3, 3)
    v[0, 0, 1, 0] = 3.25
    pages = b * MAXP + 1
    shape = (pages, KVH, dh, PAGE)
    if pool == "int8":
        pools = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        scales = [rng.random((pages, KVH, PAGE)).astype(np.float32) for _ in range(2)]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
        scales = []
    table = (rng.permutation(pages - 1) + 1)[: b * MAXP].reshape(b, MAXP).astype(np.int32)
    pos = (rng.integers(0, MAXP * PAGE - t, size=(b,)) if start is None
           else np.full((b,), start)).astype(np.int32)
    return qkv, pools, scales, table, pos


def jax_prologue(qkv, pools, scales, table, pos, dh, dtype):
    """The JAX decoder's paged prologue: rotate, quantize, Pallas write."""
    b, t = qkv.shape[:2]
    nq, nkv = H * dh, KVH * dh
    x = jnp.asarray(qkv, dtype)
    q = x[..., :nq].reshape(b, t, H, dh)
    k = x[..., nq: nq + nkv].reshape(b, t, KVH, dh)
    v = x[..., nq + nkv:].reshape(b, t, KVH, dh)
    positions = jnp.asarray(pos)[:, None] + jnp.arange(t, dtype=jnp.int32)[None, :]
    q = jd._rope(q, positions, THETA)
    k = jd._rope(k, positions, THETA)
    table, pos = jnp.asarray(table), jnp.asarray(pos)
    if scales:
        (kq, ks), (vq, vs) = jd._quantize_kv(k), jd._quantize_kv(v)
        out = jpa.paged_kv_write(*map(jnp.asarray, pools), table, pos, kq, vq,
                                 *map(jnp.asarray, scales), ks, vs, interpret=True)
    else:
        out = jpa.paged_kv_write(*(jnp.asarray(p, dtype) for p in pools), table, pos, k, v,
                                 interpret=True)
    return q, out


def jax_tables(pos, t, dh):
    """cos and sin ``[B, T, 1, Dh/2]`` as the JAX package's ``_rope``
    computes them: the prologue is held to JAX on the same tables (the
    port's ``_rope_tables`` is the decoder tests' subject)."""
    half = dh // 2
    freqs = THETA ** (-jnp.arange(0, half, dtype=jnp.float32) / half)
    positions = jnp.asarray(pos)[:, None] + jnp.arange(t, dtype=jnp.int32)[None, :]
    ang = positions.astype(jnp.float32)[:, :, None] * freqs[None, None, :]
    return jnp.cos(ang)[:, :, None, :], jnp.sin(ang)[:, :, None, :]


def port_args(qkv, pools, scales, table, pos, dh, dtype, fused):
    """The port's arguments on the CPU: q, k and v as views of one fused
    product (``fused``) or as tensors of their own; port-layout pools."""
    b, t = qkv.shape[:2]
    nq, nkv = H * dh, KVH * dh
    x = torch.from_numpy(qkv).to(dtype)
    q, k, v = (y.reshape(b, t, -1, dh) for y in x.split([nq, nkv, nkv], dim=-1))
    if not fused:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    pool_dt = torch.int8 if scales else dtype
    ports = [torch.from_numpy(p.transpose(0, 1, 3, 2).copy()).to(pool_dt) for p in pools]
    cos, sin = (torch.from_numpy(np.array(x)) for x in jax_tables(pos, t, dh))
    return (*ports, torch.from_numpy(table), torch.from_numpy(pos), q, k, v, cos, sin,
            *map(torch.from_numpy, scales))


def assert_within(got, want, dtype):
    """``got`` against ``want`` (numpy, any float type) at the module's
    tolerance for ``dtype``."""
    g = torch.from_numpy(np.array(got, np.float32))
    w = torch.from_numpy(np.array(want, np.float32))
    if dtype == torch.bfloat16:
        ulp = torch.maximum(_bf16_ulp(w), _bf16_ulp(g))
        assert bool(((g - w).abs() <= ulp).all()), float((g - w).abs().max())
    else:
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def _cases():
    for dtype in (torch.bfloat16, torch.float32):
        for pool in ("model", "int8"):
            for dh in (64, 128):
                for i, shape in enumerate(SHAPES):
                    fused = bool(i % 2) ^ (dh == 128)  # each combination meets both layouts
                    yield pytest.param(dtype, pool, dh, shape, fused,
                                       id=f"{str(dtype)[6:]}-{pool}-dh{dh}-{shape}-"
                                          f"{'fused' if fused else 'unfused'}")


@pytest.mark.parametrize("dtype,pool,dh,shape,fused", list(_cases()))
def test_prologue_matches_jax_rope_quantize_and_pallas_write(dtype, pool, dh, shape, fused):
    b, t, start = SHAPES[shape]
    qkv, pools, scales, table, pos = make_inputs(b, t, start, dh, pool, seed=b * t + dh)
    want_q, want = jax_prologue(qkv, pools, scales, table, pos, dh, jnp.bfloat16
                                if dtype == torch.bfloat16 else jnp.float32)
    args = port_args(qkv, pools, scales, table, pos, dh, dtype, fused)
    q_rot = pa.paged_kv_write_rope(*args)
    assert q_rot.dtype == dtype and tuple(q_rot.shape) == (b, t, H, dh)
    assert_within(q_rot.float().numpy(), want_q, dtype)
    for got, ref in zip(args[:2], want[:2]):  # pages but page 0, port layout
        ref = np.asarray(ref).transpose(0, 1, 3, 2)[1:]
        got = got[1:].float().numpy()
        if scales:
            assert np.abs(got - ref.astype(np.float32)).max() <= 1, "codes within 1"
        else:
            assert_within(got, ref, dtype)
    for got, ref in zip(args[9:], want[2:]):
        np.testing.assert_allclose(got[1:].numpy(), np.asarray(ref)[1:], rtol=1e-6, atol=0)
    if scales and start is None:
        # the crafted heads: ties at scale 1 go to even, as in both packages
        page, off = int(table[0, pos[0] // PAGE]), int(pos[0] % PAGE)
        assert args[9 + 1][page, 0, off] == 1.0
        codes = args[1][page, 0, off, : len(QUANTIZER_TIES)].tolist()
        assert codes == [127, 2, 4, -2, 0, 0, 2, -126]


@pytest.mark.parametrize("pool", ["model", "int8"])
def test_sharded_prologue_is_the_unsharded_one_split_by_heads(pool):
    """TP = 2 on two CPU entries: each shard's rotated q is its head slice
    of the unsharded call's, and each shard's pools its KV-head slice."""
    from outline_rag_tpu_torch.parallel.tp import model_mesh

    b, t, start = SHAPES["window"]
    qkv, pools, scales, table, pos = make_inputs(b, t, start, 64, pool, seed=3)
    args = port_args(qkv, pools, scales, table, pos, 64, torch.bfloat16, fused=True)
    whole = [x.clone() for x in args[:2] + args[9:]]
    q_rot = pa.paged_kv_write_rope(*whole[:2], *args[2:9], *whole[2:])
    split = [list(x.clone().split(KVH // 2, dim=1)) for x in args[:2] + args[9:]]
    split = [[c.contiguous() for c in x] for x in split]
    parts = pa.paged_kv_write_rope_sharded(
        *split[:2], *args[2:9], *(split[2:] or [None, None]), mesh=model_mesh(2, ["cpu", "cpu"]))
    assert torch.equal(torch.cat(parts, dim=2), q_rot)
    for pieces, full in zip(split, whole):
        assert torch.equal(torch.cat(pieces, dim=1), full)


def test_paged_route_calls_the_prologue_once_a_layer_a_shard_and_never_rope(monkeypatch):
    """The paged route rotates inside the page write, once a layer a shard;
    the ring route still rotates with ``_rope``."""
    from outline_rag_tpu_torch.parallel.tp import model_mesh, shard_decoder_params

    calls = {"rope": 0, "prologue": 0}
    real_rope, real_prologue = dec._rope, pa.paged_kv_write_rope

    def rope(*a):
        calls["rope"] += 1
        return real_rope(*a)

    def prologue(*a, **kw):
        calls["prologue"] += 1
        return real_prologue(*a, **kw)

    monkeypatch.setattr(dec, "_rope", rope)
    monkeypatch.setattr(pa, "paged_kv_write_rope", prologue)
    cfg = dec.DecoderConfig.tiny()
    params = dec.init_decoder(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.tensor([[5, 6, 7], [8, 9, 10]])
    start = torch.zeros(2, dtype=torch.int32)
    with torch.inference_mode():
        for kv_dtype in (None, "int8"):
            cache = dec.init_paged_cache(cfg, 2, 9, 16, kv_dtype=kv_dtype, device="cpu")
            cache.table[:] = torch.arange(1, 9).reshape(2, 4)
            dec.decoder_forward(params, toks, cache, start, cfg)
        assert calls == {"rope": 0, "prologue": 2 * cfg.layers}
        mesh = model_mesh(2, ["cpu", "cpu"])
        cache = dec.init_paged_cache(cfg, 2, 9, 16, device="cpu", mesh=mesh)
        cache.table[:] = torch.arange(1, 9).reshape(2, 4)
        dec.decoder_forward(shard_decoder_params(params, mesh, cfg), toks, cache, start, cfg)
        assert calls == {"rope": 0, "prologue": 4 * cfg.layers}
        dec.decoder_forward(params, toks, dec.init_cache(cfg, 2, "cpu"), start, cfg)
    assert calls == {"rope": 2 * cfg.layers, "prologue": 4 * cfg.layers}


def test_prologue_wrapper_checks_its_inputs():
    qkv, pools, scales, table, pos = make_inputs(2, 1, None, 64, "model", seed=4)
    args = list(port_args(qkv, pools, scales, table, pos, 64, torch.bfloat16, fused=False))
    bad_cos = args[:7] + [args[7][:, :, :, :16], args[8]]
    with pytest.raises(ValueError, match="cos must be f32"):
        pa.paged_kv_write_rope(*bad_cos)
    with pytest.raises(ValueError, match="share a dtype"):
        pa.paged_kv_write_rope(*args[:5], args[5].float(), *args[6:])
    with pytest.raises(ValueError, match="do not fit a pool"):
        pa.paged_kv_write_rope(*args[:4], args[4][:, :, :, :32], *args[5:])
    with pytest.raises(ValueError, match="int8 pools, and only they"):
        pa.paged_kv_write_rope(*args, torch.zeros(9, KVH, PAGE), torch.zeros(9, KVH, PAGE))


def test_token_rows_reads_fused_views_in_place_and_copies_other_layouts():
    """The kernel reads q, k and v where they lie when each token row is
    contiguous and the rows are one stride apart: the views of a fused qkv
    product are; a head-strided or transposed view is copied first."""
    qkv = torch.randn(3, 5, (4 + 2 * 2) * 64)
    q = qkv[..., : 4 * 64].reshape(3, 5, 4, 64)
    v = qkv[..., 6 * 64:].reshape(3, 5, 2, 64)
    for x in (q, v):
        got, row = pa._token_rows(x)
        assert got.data_ptr() == x.data_ptr() and row == qkv.shape[-1]
    one = qkv[:, :1, : 4 * 64].reshape(3, 1, 4, 64)  # T = 1: rows are the batch's
    assert pa._token_rows(one)[1] == 5 * qkv.shape[-1]
    for odd in (q.transpose(0, 1), q[:, :, ::2]):
        got, row = pa._token_rows(odd)
        assert got.is_contiguous() and got.data_ptr() != odd.data_ptr()
        assert row == odd.shape[2] * 64 and torch.equal(got, odd)


def test_the_kernel_binding_matches_the_launch_signature():
    """``_launcher("write")`` binds ``paged_kv_write_launch`` with one
    ctypes type a parameter: the source's signature has as many."""
    import ctypes
    import re

    text = (_build.CSRC_DIR / "paged_kv_write.cu").read_text()
    sig = re.search(r'extern "C" int paged_kv_write_launch\((.*?)\)', text, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    kinds = ["p" if "*" in p else "ll" if "long long" in p else "i" for p in params]
    assert kinds == ["p"] * 14 + ["ll"] * 3 + ["i"] * 10 + ["p"]
    assert ctypes.sizeof(ctypes.c_longlong) == 8


def test_the_kernel_rounds_as_the_twin_does():
    """Bit-equality with the twin rests on these spellings: no FMA in the
    rotation, the scale by f32(1/127), IEEE division, ties to even, and no
    fast-math flag in the build."""
    text = (_build.CSRC_DIR / "paged_kv_write.cu").read_text()
    assert "__fsub_rn(__fmul_rn(x1, cv), __fmul_rn(x2, sv))" in text
    assert "__fadd_rn(__fmul_rn(x2, cv), __fmul_rn(x1, sv))" in text
    assert "__fmul_rn(m, 1.0f / 127.0f)" in text and "rintf(__fdiv_rn(" in text
    assert "__fdividef" not in text and "roundf" not in text
    assert not any("fast_math" in f or "fmad" in f for f in _build.NVCC_FLAGS)


def _kv_write_edits():
    from outline_rag_tpu_torch.tools import kernel_mutants

    for name, edits in kernel_mutants.KV_WRITE_MUTANTS.items():
        for i, edit in enumerate(edits):
            yield pytest.param(edit, id=f"{name}-{i}")


@pytest.mark.parametrize("edit", list(_kv_write_edits()))
def test_every_kv_write_mutant_edit_applies_to_the_source(edit):
    """``tools/kernel_mutants.py paged_kv_write`` edits a copy of
    ``csrc/paged_kv_write.cu`` and refuses an edit whose text occurs
    another number of times."""
    old, new, occurrences = edit
    assert old != new
    assert (_build.CSRC_DIR / "paged_kv_write.cu").read_text().count(old) == occurrences


def test_the_mutants_cover_the_faults_the_kernel_must_catch():
    from outline_rag_tpu_torch.tools import kernel_mutants

    assert {"as_is", "rotation_contracted_into_fma", "rotate_half_sign_swapped",
            "f32_k_quantized", "roundf_for_rintf", "reciprocal_replaced_by_division",
            "scale_not_written", "page0_redirect_dropped"} <= set(kernel_mutants.KV_WRITE_MUTANTS)
    assert kernel_mutants.KERNELS["paged_kv_write"] is kernel_mutants.kv_write_mutants
