"""The port's int4 linears (``outline_rag_tpu_torch.ops.int4_linear``) and
the floors of the scan and of the int4 stream, on the CPU, where each wrapper
runs its plain twin: the same numpy weights and activations go through the
JAX package (its Pallas kernels in interpret mode, its quantizer under
``jit``) and through the port.

Tolerances: the quantizer's codes and scales are byte-equal, and so are the
row quantizer's (the int8 activations of w4a8) against the JAX recipe. The products
differ from JAX's only in the order of f32 sums: ``1e-5`` of the output's
scale absolute plus ``1e-5`` relative, the bound of
``tests/test_int4_linear.py``. At bf16 the JAX v2 kernel rounds another
weight (``(v + 8) * s``), and is held as loosely as that file holds v1 to v2
(2% of the output's scale).

The JAX tools that hold the floor kernels (``tools/bench_topk_kernel.py``,
``tools/bench_int4_kernel.py``) read ``sys.argv`` and build a corpus when
they are imported, so they cannot be run from a test: the floors' twins are
held to numpy references written here instead."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outline_rag_tpu.models import decoder as jdec
from outline_rag_tpu.ops import int4_linear as jint4
from outline_rag_tpu_torch.models import decoder as tdec
from outline_rag_tpu_torch.ops import int4_linear as tint4
from outline_rag_tpu_torch.ops.topk import (
    split_f32_bf16x2,
    topk_float,
    topk_floor,
    topk_floor_plain,
)

SHAPES = [  # (M, K, N, gsz): tests/test_int4_linear.py's, and its group-straddling case
    (1, 512, 256, 128),
    (4, 1024, 512, 128),
    (9, 512, 384, 256),
    (16, 2048, 512, 512),
    (32, 2048, 1280, 128),
    (2, 768, 256, 384),
]


def weight(k, n, seed=0, std=0.05):
    return (np.random.default_rng(seed).standard_normal((k, n)) * std).astype(np.float32)


def acts(m, k, seed=1):
    return np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)


def jax_quant(w, gsz):
    """The JAX package's codes, through its jitted quantizer."""
    qp = jdec.quantize_decoder_params_int4(
        {"layers": {"wq": jnp.asarray(w)}, "embed": jnp.asarray(w[:1]),
         "final_norm": jnp.asarray(w[0])}, group_size=gsz)
    return np.array(qp["layers"]["wq"]["q4"]), np.array(qp["layers"]["wq"]["s4"])  # writable


def close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=1e-5 * np.abs(want).max(), rtol=1e-5)


@pytest.mark.parametrize("k,n,gsz", [
    (512, 256, 128), (768, 256, 384), (2048, 2560, 128),
    (384, 64, 128),  # K % 256 != 0: one pair block K/2 wide
    (640, 128, 256),  # K % group_size != 0: one group of K (and K % 256 != 0)
    (64, 192, 128),  # the tiny decoder's K
])
def test_quantizer_is_byte_equal_to_jax(k, n, gsz):
    w = weight(k, n, seed=k + n, std=0.02)
    want_q, want_s = jax_quant(w, gsz)
    q4, s4 = tint4.quantize_int4_weight(torch.from_numpy(w), gsz)
    assert q4.dtype == torch.uint8 and s4.dtype == torch.float32
    np.testing.assert_array_equal(q4.numpy(), want_q)
    np.testing.assert_array_equal(s4.numpy(), want_s)


def test_quantizer_handles_bf16_weights_zero_groups_and_odd_k():
    w = torch.from_numpy(weight(256, 128)).to(torch.bfloat16)
    w[:128, 3] = 0  # a whole group of zeros: scale floored at 1e-12, codes 0
    want_q, want_s = jax_quant(np.asarray(w.float()), 128)
    q4, s4 = tint4.quantize_int4_weight(w)
    np.testing.assert_array_equal(q4.numpy(), want_q)
    np.testing.assert_array_equal(s4.numpy(), want_s)
    assert float(s4[3, 0]) == np.float32(1e-12)
    with pytest.raises(ValueError, match="even K"):
        tint4.quantize_int4_weight(torch.zeros(7, 8))


@pytest.mark.parametrize("shape", [(5, 128), (2, 3, 256), (4, 32), (3, 96)])
def test_unpack_equals_jax(shape):
    p = np.random.default_rng(3).integers(0, 256, shape).astype(np.uint8)
    want = np.asarray(jdec._unpack_int4(jnp.asarray(p)))
    got = tint4.unpack_int4(torch.from_numpy(p))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_unpack_inverts_the_quantizer():
    w = torch.from_numpy(weight(512, 64))
    q4, s4 = tint4.quantize_int4_weight(w)
    v = tint4.unpack_int4(q4).reshape(64, 4, 128).float()
    assert int(v.min()) >= -8 and int(v.max()) <= 7
    back = (v * s4[:, :, None]).reshape(64, 512).T
    assert float((back - w).abs().max()) <= float(s4.max()) * 0.5 + 1e-7


@pytest.mark.parametrize("m,k,n,gsz", SHAPES)
def test_w4a8_twin_matches_jax_kernel(m, k, n, gsz):
    q4, s4 = jax_quant(weight(k, n, 20), gsz)
    x = acts(m, k, 21)
    want = jint4.w4a8_matmul(jnp.asarray(x), jnp.asarray(q4), jnp.asarray(s4), interpret=True)
    args = (torch.from_numpy(x), torch.from_numpy(q4), torch.from_numpy(s4))
    got = tint4.w4a8_matmul_plain(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    close(got.numpy(), want)
    assert torch.equal(tint4.w4a8_matmul(*args), got)  # a CPU tensor takes the twin


def quantizer_rows(m, k, seed, dtype):
    """Rows with the cases that break a careless quantizer: a row of zeros, a
    row whose maximum is negative, and a row with a maximum of exactly 127
    (scale 1) holding values at exact .5 ties."""
    x = acts(m, k, seed) * 3
    x[0] = 0
    if m > 2:
        x[1] = -np.abs(x[1])
        x[2] = np.clip(x[2], -100, 100)
        x[2, :8] = [127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, -126.5]
    t = torch.from_numpy(x).to(dtype)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                     else jnp.float32)


def package_row_quantizer(monkeypatch, x):
    """The int8 rows and row scales that the JAX package's own ``w4a8_matmul``
    hands to its kernel: the function runs with ``pl.pallas_call`` replaced by
    a stand-in that keeps its first operand (``xq``, padded to 32 rows) and
    returns ones, so that the result ``out[:m] * sx[:m]`` is ``sx`` to the
    bit. No line of the recipe is copied here."""
    m, k = x.shape
    seen = {}

    def pallas_call(kernel, *, out_shape, **kwargs):
        def run(xq, xs2, q4, s4):
            seen["xq"] = np.asarray(xq)
            return jnp.ones(out_shape.shape, out_shape.dtype)

        return run

    monkeypatch.setattr(jint4.pl, "pallas_call", pallas_call)
    out = jint4.w4a8_matmul(x, jnp.zeros((128, k // 2), jnp.uint8),
                            jnp.ones((128, k // 128), jnp.float32))
    monkeypatch.undo()
    assert seen["xq"].dtype == np.int8 and not seen["xq"][m:].any()  # the padding rows
    return seen["xq"][:m], np.asarray(out)[:, :1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k", [(1, 512), (8, 2048), (32, 2048), (5, 5632), (3, 11008)])
def test_row_quantizer_twin_is_byte_equal_to_the_jax_recipe(m, k, dtype, monkeypatch):
    xt, xj = quantizer_rows(m, k, 50 + m, dtype)
    want_q, want_s = package_row_quantizer(monkeypatch, xj)
    xq, xs = tint4._quantize_activations(xt)
    assert xq.dtype == torch.int8 and xs.dtype == torch.float32 and tuple(xs.shape) == (m, 1)
    np.testing.assert_array_equal(xq.numpy(), want_q)
    np.testing.assert_array_equal(xs.numpy().view(np.int32), want_s.view(np.int32))  # the bits
    assert float(xs[0, 0]) == np.float32(1e-12) and not xq[0].any()  # the scale's floor
    if m > 2:
        assert xq[2, :8].tolist() == [127, 2, 4, -2, 0, 0, 2, -126]  # ties go to even
        assert int(xq[1].min()) == -127 and int(xq[1].max()) <= 0
    got_q, got_s = tint4.quantize_rows(xt)  # a CPU tensor takes the twin
    assert torch.equal(got_q, xq) and torch.equal(got_s, xs)
    assert tint4.quantize_rows.launches == 0


def selecting_weight(k, n=128):
    """int4 weights whose column ``j`` holds code 7 at ``k = j`` and zeros
    elsewhere, every group scale 1: ``w4a8_matmul`` then returns ``7 * xq[m, j]
    * xs[m]``, one rounding, so one flipped activation code or scale bit shows
    in the result."""
    w = np.zeros((k, n), np.float32)
    w[np.arange(n), np.arange(n)] = 7.0
    q4, s4 = jax_quant(w, 128)
    return q4, np.ones_like(s4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k", [(4, 512), (32, 2048), (5, 5632)])
def test_w4a8_through_the_jax_kernel_sees_every_activation_code_and_scale_bit(m, k, dtype):
    """The package's own function, its Pallas kernel in interpret mode, on
    rows with ties, a zero row and a negative maximum: with weights that pick
    single activations the two results are equal to the bit, and a quantizer
    that rounded half up or multiplied by a reciprocal would not be."""
    xt, xj = quantizer_rows(m, k, 60 + m, dtype)
    q4, s4 = selecting_weight(k)
    want = np.asarray(jint4.w4a8_matmul(xj, jnp.asarray(q4), jnp.asarray(s4), interpret=True))
    got = tint4.w4a8_matmul(xt, torch.from_numpy(q4), torch.from_numpy(s4))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    xq, xs = tint4._quantize_activations(xt)
    np.testing.assert_array_equal(got.numpy(), (7.0 * xq[:, :128].float() * xs).numpy())
    assert got[2, :8].tolist() == [7.0 * c for c in (127, 2, 4, -2, 0, 0, 2, -126)]


@pytest.mark.parametrize("fault", ["half_up", "reciprocal_scale"])
def test_the_selecting_weights_expose_a_careless_row_quantizer(fault, monkeypatch):
    """The check above can fail: with a twin that rounds ties upward, or one
    that takes the scale as a product with 1/127, the port's result leaves
    the package's."""
    xt, xj = quantizer_rows(256, 2048, 92, torch.float32)  # 1 scale in 22 differs
    q4, s4 = selecting_weight(2048)
    want = np.asarray(jint4.w4a8_matmul(xj, jnp.asarray(q4), jnp.asarray(s4), interpret=True))

    def careless(x):
        x32 = x.to(torch.float32)
        amax = x32.abs().amax(dim=1, keepdim=True)
        if fault == "half_up":
            xs = (amax / x32.new_full((), 127.0)).clamp_min(1e-12)
            return torch.floor(x32 / xs + 0.5).clamp(-127, 127).to(torch.int8), xs
        xs = (amax * x32.new_full((), 1 / 127.0)).clamp_min(1e-12)
        return torch.round(x32 / xs).clamp(-127, 127).to(torch.int8), xs

    monkeypatch.setattr(tint4, "_quantize_activations", careless)
    got = tint4.w4a8_matmul(xt, torch.from_numpy(q4), torch.from_numpy(s4))
    assert not np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_quantize_rows_validates_its_input():
    with pytest.raises(ValueError, match="bf16 or f32"):
        tint4.quantize_rows(torch.zeros((2, 64), dtype=torch.float16))
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        tint4.quantize_rows(torch.zeros((2, 3, 64)))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,gsz", SHAPES)
def test_w4a8_result_in_the_working_type_is_the_f32_result_rounded_once(m, k, n, gsz, dt):
    """What the decoder calls: the product's epilogue writes the model's type."""
    q4, s4 = (torch.from_numpy(a) for a in jax_quant(weight(k, n, 22), gsz))
    x = torch.from_numpy(acts(m, k, 23)).to(torch.bfloat16)
    got = tint4._w4a8_matmul_as(x, q4, s4, dt)
    assert got.dtype == dt
    assert torch.equal(got, tint4.w4a8_matmul(x, q4, s4).to(dt))
    assert torch.equal(got, tint4._w4a8_matmul_as_plain(x, q4, s4, dt))


def test_w4a8_writes_only_the_types_its_epilogue_has():
    q4, s4 = (torch.from_numpy(a) for a in jax_quant(weight(512, 256, 22), 128))
    x = torch.zeros((2, 512), dtype=torch.bfloat16)
    for dt in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(ValueError, match="writes bf16 or f32"):
            tint4._w4a8_matmul_as(x, q4, s4, dt)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,gsz", SHAPES)
def test_w4a16_result_in_the_working_type_is_the_f32_result_rounded_once(m, k, n, gsz, dt):
    """What the decoder calls: the weight decoded to the model's type, and
    the product's epilogue writing that type."""
    q4, s4 = (torch.from_numpy(a) for a in jax_quant(weight(k, n, 24), gsz))
    x = torch.from_numpy(acts(m, k, 25)).to(dt)
    got = tint4._w4a16_matmul_as(x, q4, s4, dt)
    assert got.dtype == dt and tuple(got.shape) == (m, n)
    assert torch.equal(got, tint4.w4a16_matmul(x, q4, s4, dt).to(dt))
    assert torch.equal(got, tint4._w4a16_matmul_as_plain(x, q4, s4, dt))


def test_w4a16_writes_only_the_types_its_epilogue_has():
    q4, s4 = (torch.from_numpy(a) for a in jax_quant(weight(512, 256, 22), 128))
    x = torch.zeros((2, 512), dtype=torch.bfloat16)
    before = tint4.w4a16_matmul.launches
    for dt in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(ValueError, match="writes bf16 or f32"):
            tint4._w4a16_matmul_as(x, q4, s4, dt)
    assert tint4.w4a16_matmul.launches == before


def test_cold_ring_spans_the_cache_with_distinct_copies():
    from outline_rag_tpu_torch.tools import timing

    a, b = torch.arange(12, dtype=torch.uint8).reshape(3, 4), torch.ones(3)
    ring = timing.cold_ring(a, b)
    steps = [next(ring) for _ in range(65)]
    assert len({t[0].data_ptr() for t in steps}) == 64  # capped: 150 MB of 24-byte pairs
    assert steps[64][0].data_ptr() == steps[0][0].data_ptr()  # and it cycles
    assert all(torch.equal(t[0], a) and torch.equal(t[1], b) for t in steps)
    big = torch.zeros(timing.COLD_RING_BYTES // 3, dtype=torch.uint8)
    assert len({next(r)[0].data_ptr() for r in [timing.cold_ring(big)] for _ in range(9)}) == 4


def test_decoder_control_reads_a_decoder_phase_and_refuses_without_a_card(capsys):
    from outline_rag_tpu_torch.tools import decoder_control

    lines = ["built in 12 s", '{"phase": "env", "torch": "x"}', "[1, 2]",
             '{"phase": "decoder", "config": "int4_weights", "tokens_per_s": 200.5, '
             '"decode_step_ms": 21.0, "ttft_p50_ms": 5000.0, "wall_s": 9.0, "chats": 32}',
             '{"phase": "decode_profile", "config": "int4_weights", "decode_step_ms": 18.0, '
             '"device_ms_per_step": 6.5, "launches_per_step": 1273.0, "slots": 32}',
             '{"phase": "spec_ceiling", "config": "spec", "decode_step_ms": 23.0}']
    assert decoder_control.summarize(lines) == {"int4_weights": {
        "burst_tokens_per_s": 200.5, "burst_decode_step_ms": 21.0, "burst_ttft_p50_ms": 5000.0,
        "burst_wall_s": 9.0, "profile_decode_step_ms": 18.0, "profile_device_ms_per_step": 6.5,
        "profile_launches_per_step": 1273.0}}
    assert "import jax" not in decoder_control._RUN and "decoder_phase" in decoder_control._RUN
    assert decoder_control.main(["."]) == 2  # no card here: nothing runs, nothing is printed
    assert capsys.readouterr().out == ""


def test_w4a8_rows_do_not_depend_on_their_neighbours():
    q4, s4 = (torch.from_numpy(a) for a in jax_quant(weight(512, 256, 4), 128))
    x = torch.from_numpy(acts(32, 512, 5))
    whole = tint4.w4a8_matmul(x, q4, s4)
    for row in (0, 7, 31):
        assert torch.equal(tint4.w4a8_matmul(x[row : row + 1], q4, s4)[0], whole[row])


def test_w4a8_integer_oracle():
    """Every integer sum is exact: against float64 arithmetic on the codes the
    twin is within f32 rounding of the sum over groups."""
    m, k, n, gsz = 9, 1024, 384, 256
    q4, s4 = jax_quant(weight(k, n, 6), gsz)
    x = acts(m, k, 7)
    sx = np.maximum(np.abs(x).max(1, keepdims=True) / np.float32(127.0), np.float32(1e-12))
    xq = np.clip(np.round(x / sx), -127, 127).astype(np.float64)
    v = tint4.unpack_int4(torch.from_numpy(q4)).numpy().astype(np.float64)
    wd = (v.reshape(n, k // gsz, gsz) * s4.astype(np.float64)[:, :, None]).reshape(n, k)
    want = (xq @ wd.T) * sx
    got = tint4.w4a8_matmul(torch.from_numpy(x), torch.from_numpy(q4), torch.from_numpy(s4))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6 * np.abs(want).max(), rtol=1e-5)


@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("m,k,n,gsz", SHAPES)
def test_w4a16_twin_matches_jax_kernel_f32(m, k, n, gsz, variant):
    q4, s4 = jax_quant(weight(k, n, 30), gsz)
    x = acts(m, k, 31)
    want = jint4.w4a16_matmul(jnp.asarray(x), jnp.asarray(q4), jnp.asarray(s4), jnp.float32,
                              interpret=True, variant=variant)
    args = (torch.from_numpy(x), torch.from_numpy(q4), torch.from_numpy(s4))
    got = tint4.w4a16_matmul_plain(*args, torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    close(got.numpy(), want)
    assert torch.equal(tint4.w4a16_matmul(*args, variant=variant), got)


def test_w4a16_twin_at_bf16_against_jax_v1_and_v2():
    """bf16: against v1 (the same decoded weight) only the order of f32 sums
    differs; v2 rounds ``(v + 8) * s`` to bf16, another weight, held to the
    2% of the output's scale that the JAX package's tests hold v1 to v2."""
    k, n, m = 1024, 512, 4
    q4, s4 = jax_quant(weight(k, n, 11), 128)
    x = acts(m, k, 12)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    args = (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(q4), torch.from_numpy(s4))
    got = tint4.w4a16_matmul(*args).numpy()
    v1 = np.asarray(jint4.w4a16_matmul(xb, jnp.asarray(q4), jnp.asarray(s4), jnp.bfloat16,
                                       interpret=True, variant="v1"), np.float32)
    v2 = np.asarray(jint4.w4a16_matmul(xb, jnp.asarray(q4), jnp.asarray(s4), jnp.bfloat16,
                                       interpret=True, variant="v2"), np.float32)
    close(got, v1)
    np.testing.assert_allclose(got, v2, atol=0.02 * np.abs(v1).max())


def test_w4a16_validates_variant_and_operands():
    q4, s4 = (torch.from_numpy(a) for a in jax_quant(weight(512, 256), 128))
    x = torch.zeros((1, 512))
    for bad in ("V2", "v3"):
        with pytest.raises(ValueError, match="variant"):
            tint4.w4a16_matmul(x, q4, s4, variant=bad)
    with pytest.raises(ValueError, match="packed K mismatch"):
        tint4.w4a16_matmul(torch.zeros((1, 256)), q4, s4)
    with pytest.raises(ValueError, match="packed K mismatch"):
        tint4.w4a8_matmul(torch.zeros((1, 256)), q4, s4)
    with pytest.raises(ValueError, match="uint8"):
        tint4.w4a8_matmul(x, q4.to(torch.int8), s4)
    with pytest.raises(ValueError, match="bf16 or f32"):
        tint4.w4a8_matmul(x.to(torch.float16), q4, s4)
    with pytest.raises(ValueError, match="decodes to"):
        tint4.w4a16_matmul(x, q4, s4, torch.float16)


def test_w4a8_close_to_w4a16():
    """w4a8 adds only the activation quantization to the w4a16 numerics."""
    q4, s4 = (torch.from_numpy(a) for a in jax_quant(weight(1024, 512, 30), 128))
    x = torch.from_numpy(acts(8, 1024, 31))
    a16, a8 = tint4.w4a16_matmul(x, q4, s4), tint4.w4a8_matmul(x, q4, s4)
    cos = torch.nn.functional.cosine_similarity(a16, a8, dim=-1)
    assert float(cos.min()) > 0.999


@pytest.mark.parametrize("m", [4, 64, 300])
@pytest.mark.parametrize("k,n,gsz", [(512, 256, 128), (768, 256, 384), (384, 64, 128)])
def test_mm_int4_branches_match_jax(m, k, n, gsz):
    """On the CPU both packages take the grouped product (M <= 256) or the
    full dequantization (M = 300), whatever the mode says."""
    q4, s4 = jax_quant(weight(k, n, 40), gsz)
    x = acts(m, k, 41).reshape(2, m // 2, k)
    want = jdec._mm_int4(jnp.asarray(x), jnp.asarray(q4), jnp.asarray(s4), jnp.float32)
    got = tdec._mm_int4(torch.from_numpy(x), torch.from_numpy(q4), torch.from_numpy(s4),
                        torch.float32)
    assert tuple(got.shape) == (2, m // 2, n)
    close(got.numpy(), want)


def test_mm_int4_bf16_matches_jax():
    q4, s4 = jax_quant(weight(512, 256, 42), 128)
    x = acts(8, 512, 43)
    want = np.asarray(jdec._mm_int4(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(q4),
                                    jnp.asarray(s4), jnp.bfloat16).astype(jnp.float32))
    got = tdec._mm_int4(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(q4),
                        torch.from_numpy(s4), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # the same f32 sums in another order, then one rounding to bf16: an ulp
    np.testing.assert_allclose(got.float().numpy(), want, atol=2.0 ** -7 * np.abs(want).max())


def jax_rule(m, k, n, gsz):
    """``_mm_int4``'s shape condition in the JAX package (decoder.py:421-428)."""
    return k % 256 == 0 and gsz % 128 == 0 and n % 128 == 0 and (k // 2) % 128 == 0


@pytest.mark.parametrize("k,n,gsz", [
    (2048, 2560, 128), (2048, 2048, 128), (2048, 11264, 128), (5632, 2048, 128),
    (2048, 32000, 128), (4096, 22016, 128), (11008, 4096, 128), (768, 256, 384),
    (512, 384, 256), (2048, 512, 512), (64, 192, 64), (384, 64, 128), (640, 128, 640),
    (512, 200, 128), (512, 256, 64), (1280, 128, 1280),
])
def test_kernel_eligibility_is_the_jax_rule(k, n, gsz):
    for m in (1, 8, 32, 256):
        assert tint4.int4_kernel_eligible(m, k, n, gsz) == jax_rule(m, k, n, gsz)
    assert not tint4.int4_kernel_eligible(0, k, n, gsz)
    assert not tint4.int4_kernel_eligible(257, k, n, gsz)


def test_all_tinyllama_projections_are_eligible_and_the_rule_has_one_constant():
    cfg = tdec.DecoderConfig.tinyllama_1b()
    nq, nkv = cfg.heads * cfg.hd, cfg.kv_heads * cfg.hd
    for k, n in ((cfg.hidden, nq + 2 * nkv), (nq, cfg.hidden), (cfg.hidden, 2 * cfg.intermediate),
                 (cfg.intermediate, cfg.hidden), (cfg.hidden, cfg.vocab_size)):
        assert tint4.int4_kernel_eligible(32, k, n, 128), (k, n)
    assert tdec.INT4_KERNEL_MAX_M == 32 and tdec._INT4_MODE in ("w4a8", "kernel", "xla")


# ----------------------------------------------------------------------
# the floors
# ----------------------------------------------------------------------


def test_int4_stream_floor_twin_against_numpy():
    rng = np.random.default_rng(8)
    for n, kp in ((16, 128), (8, 352), (24, 1024)):  # 352 / 4 words: no power of two
        q4 = rng.integers(0, 256, (n, kp)).astype(np.uint8)
        x = rng.standard_normal((3, 2 * kp)).astype(np.float32)
        value, fold = tint4.int4_stream_floor(torch.from_numpy(x), torch.from_numpy(q4))
        assert tuple(value.shape) == (n, 1) and fold.dtype == torch.int32
        np.testing.assert_array_equal(value.numpy(), q4[:, :1].astype(np.float32) * x[0, 0])
        np.testing.assert_array_equal(
            fold.numpy(), np.bitwise_xor.reduce(q4.view("<i4"), axis=1))
    with pytest.raises(ValueError, match="32-bit words"):
        tint4.int4_stream_floor(torch.zeros((1, 12)), torch.zeros((8, 6), dtype=torch.uint8))


def floor_inputs(mode, b=5, n=1000, d=64):
    rng = np.random.default_rng(9)
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    q, c = (torch.from_numpy(a / np.linalg.norm(a, axis=1, keepdims=True)) for a in (q, c))
    if mode == "bf16":
        return q.to(torch.bfloat16), c.to(torch.bfloat16)
    if mode == "f32x2":
        return split_f32_bf16x2(q), split_f32_bf16x2(c)
    return q, c


def numpy_scores(q, c, mode):
    q, c = q.float().numpy().astype(np.float64), c.float().numpy().astype(np.float64)
    if mode != "f32x2":
        return q @ c.T
    d = q.shape[1] // 2
    return q[:, :d] @ c[:, :d].T + q[:, :d] @ c[:, d:].T + q[:, d:] @ c[:, :d].T


@pytest.mark.parametrize("mode,variant", [("fp32", "nomerge"), ("fp32", "matmul"),
                                          ("bf16", "nomerge"), ("bf16", "matmul"),
                                          ("f32x2", "nomerge")])
def test_topk_floor_twin_against_numpy(mode, variant):
    q, c = floor_inputs(mode)
    scores = numpy_scores(q, c, mode)
    for tile_rows in (128, 7):
        want = (scores if variant == "nomerge" else scores[:, ::tile_rows]).max(axis=1)
        got = topk_floor(q, c, mode, variant, tile_rows)
        assert got.dtype == torch.float32 and tuple(got.shape) == (5,)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        assert torch.equal(got, topk_floor_plain(q, c, mode, variant, tile_rows))
    if variant == "nomerge":  # the scan's best score
        vals, _ = topk_float(q, c, 1, None, mode)
        np.testing.assert_allclose(topk_floor(q, c, mode).numpy(), vals[:, 0].numpy(), atol=1e-6)


def test_topk_floor_steps_and_validation(monkeypatch):
    import outline_rag_tpu_torch.ops.topk as topk_module

    q, c = floor_inputs("fp32", n=1000)
    want = topk_floor_plain(q, c, "fp32", "matmul", 16)
    monkeypatch.setattr(topk_module, "PLAIN_ROWS_PER_STEP", 100)  # steps of 96 rows
    assert torch.equal(topk_floor_plain(q, c, "fp32", "matmul", 16), want)
    with pytest.raises(ValueError, match="nomerge variant only"):
        topk_floor(*floor_inputs("f32x2"), "f32x2", "matmul")
    with pytest.raises(ValueError, match="floor variant"):
        topk_floor(q, c, "fp32", "full")
    with pytest.raises(ValueError, match="tile_rows"):
        topk_floor(q, c, "fp32", "matmul", 0)
    with pytest.raises(ValueError, match="float scan mode"):
        topk_floor(q, c, "int8")
    empty = topk_floor(q, c[:0], "fp32")
    assert empty.tolist() == [pytest.approx(-1e30)] * 5  # the running maximum's first value


def test_int4_ops_are_exported_without_shadowing_the_module():
    import inspect

    import outline_rag_tpu_torch.ops as ops
    import outline_rag_tpu_torch.ops.int4_linear as module

    assert inspect.ismodule(module)
    for name in ("quantize_rows", "w4a8_matmul", "w4a8_matmul_plain", "w4a16_matmul",
                 "w4a16_matmul_plain",
                 "int4_stream_floor", "int4_stream_floor_plain", "quantize_int4_weight",
                 "unpack_int4", "int4_kernel_eligible", "topk_floor", "topk_floor_plain"):
        assert callable(getattr(ops, name)) and name in ops.__all__
    for fn in (ops.quantize_rows, ops.w4a8_matmul, ops.w4a16_matmul, ops.int4_stream_floor,
               ops.topk_floor):
        assert fn.launches == 0  # no kernel is launched off the card


def _int4_source_edits():
    from outline_rag_tpu_torch.tools import ablate_w4a16, kernel_mutants

    for name, faults in kernel_mutants.INT4_MUTANTS.items():
        for runs, edit in faults.items():
            yield pytest.param(edit, id=f"mutant-{name}-{'-'.join(runs)}".replace(" ", "_"))
    for name, edits in ablate_w4a16.VARIANTS.items():
        for i, edit in enumerate(edits):
            yield pytest.param(edit, id=f"ablation-{name}-{i}")


@pytest.mark.parametrize("edit", list(_int4_source_edits()))
def test_every_int4_mutant_and_ablation_edit_applies_to_the_source(edit):
    """The card tools edit a copy of ``csrc/int4_linear.cu`` and refuse an
    edit whose text occurs another number of times: each one still finds
    its line, and changes it."""
    from outline_rag_tpu_torch.ops import _build

    old, new, occurrences = edit
    assert old != new
    assert (_build.CSRC_DIR / "int4_linear.cu").read_text().count(old) == occurrences
