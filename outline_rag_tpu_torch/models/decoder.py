"""Llama/Qwen-family decoder LM in plain PyTorch functions — the local chat
provider's model.

Port of ``outline_rag_tpu/models/decoder.py``: RMSNorm (pre-norm), rotary
position embeddings (half-split rotate, f32), grouped-query attention,
SwiGLU MLP, optional attention biases (Qwen2), optional tied embeddings.

Parameters are a dictionary like the JAX package's, with ``"layers"`` a list
of per-layer dictionaries (a Python loop over layers takes the place of
``lax.scan``). Dense weights keep the JAX layout ``[K, N]`` (``x @ w``);
int8 weights are ``{"q": [N, K] int8, "s": [N] f32}``, int4 weights
``{"q4": [N, K/2] uint8, "s4": [N, G] f32}`` (``ops/int4_linear.py`` documents
the packing).

Two caches:

- the KV ring, a tuple ``(k, v)`` of ``[L, B, KvH, C, Dh]``;
- :class:`PagedKV`, a shared pool of pages ``[L, P, KvH, page, Dh]`` with a
  page table (``ops/paged_attention.py`` documents the layout, which
  differs from the JAX package's position-minor one), or for latent
  attention a pool of latent entries ``[L, P, page, kv_lora_rank + rope]``.

A config with :class:`MLAConfig` and :class:`MoEConfig` (DeepSeek-V2) runs
multi-head latent attention over the latent pool (``models/mla.py``) and,
past its leading dense layers, routed experts with shared experts
(``models/moe.py``); it serves on the paged pool only, on one device, in
the model dtype (:func:`check_latent_options` names what it refuses).

:func:`decoder_forward` **updates the cache it is given in place** and
returns it; there is no donation to arrange and no copy to avoid.

Sampling uses a counter-based generator written in tensor ops
(:func:`key_at`, :func:`sample_token`): the token drawn for absolute
position ``q`` of a request depends only on the request's seed, ``q`` and
that position's logits, never on the batch it shares, the chunk boundary or
the slot. The numbers differ from ``jax.random``'s; greedy decoding
(``temperature <= 0``) is ``argmax`` in both.

Prompt-lookup speculative decoding (:func:`propose_ngram`,
:func:`generate_chunk_spec`) rests on that contract: it emits the tokens the
plain loop would.

Tensor parallelism (``parallel/tp.py``): parameters laid out by
``shard_decoder_params`` carry their mesh, and :func:`decoder_forward` then
runs the column-parallel projections and the attention of each device's
heads on that device, and sums each row-parallel ``wo`` and ``wd`` product
over the shards on the first device, in shard order. The KV ring or the
pool must be sharded on the same mesh.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import torch

from outline_rag_tpu_torch.ops.int4_linear import (
    _w4a8_matmul_as,
    _w4a16_matmul_as,
    int4_kernel_eligible,
    quantize_int4_weight,
    unpack_int4,
    w4a16_matmul,
)
from outline_rag_tpu_torch.ops.int8_linear import (
    _int_matmul,
    int8_linear,
    quantize_linear_weight,
    w8a8_matmul,
)
from outline_rag_tpu_torch.ops.paged_attention import (
    _rope,
    paged_attention_sharded,
    paged_kv_write_rope_sharded,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class YarnRope:
    """YaRN's rotary scaling as DeepSeek-V2 publishes it (``rope_scaling``
    of ``type`` "yarn"): frequencies kept below the correction range,
    divided by ``factor`` above it, a linear ramp between;
    ``models/mla.py::rope_frequencies`` computes them."""

    factor: float
    original_max: int  # original_max_position_embeddings
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention without a q LoRA (DeepSeek-V2), its rope
    dims rotated with YaRN: each token caches one entry of ``kv_lora_rank``
    normed latent values and ``qk_rope_dim`` rotated key values shared by
    every head."""

    yarn: YarnRope
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int

    @property
    def entry(self) -> int:
        """Width of a token's entry in the latent pool."""
        return self.kv_lora_rank + self.qk_rope_dim


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Routed experts with shared experts (DeepSeek-V2's ``DeepseekV2MoE``
    with greedy top-k over a softmax router, the top-k weights neither
    renormalised nor scaled): layers ``first_dense`` and above replace the
    dense MLP by ``experts`` SwiGLU experts of width ``intermediate``,
    ``top_k`` a token, plus the shared experts as one SwiGLU (its width is
    its weights')."""

    experts: int
    top_k: int
    intermediate: int
    first_dense: int


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32000
    hidden: int = 2048
    layers: int = 16
    heads: int = 16
    kv_heads: int = 8
    intermediate: int = 5632
    head_dim: int | None = None  # default hidden // heads
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    attn_bias: bool = False  # Qwen2 uses q/k/v biases
    tie_embeddings: bool = False
    max_cache: int = 2048  # KV capacity per sequence
    dtype: torch.dtype = torch.bfloat16
    mla: MLAConfig | None = None  # DeepSeek-V2: latent attention in every layer,
    moe: MoEConfig | None = None  # and routed experts past the leading dense layers

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden // self.heads

    @property
    def moe_layers(self) -> int:
        """Layers with routed experts."""
        return self.layers - self.moe.first_dense

    @classmethod
    def tiny(cls, dtype: torch.dtype = torch.float32) -> "DecoderConfig":
        return cls(
            vocab_size=256, hidden=64, layers=2, heads=4, kv_heads=2,
            intermediate=128, max_cache=64, dtype=dtype,
        )

    @classmethod
    def tinyllama_1b(cls, dtype: torch.dtype = torch.bfloat16) -> "DecoderConfig":
        """TinyLlama-1.1B-Chat-v1.0's published ``config.json``."""
        return cls(
            vocab_size=32000, hidden=2048, layers=22, heads=32, kv_heads=4,
            intermediate=5632, rope_theta=10000.0, norm_eps=1e-5,
            max_cache=2048, dtype=dtype,
        )


# ---------------------------------------------------------------------------
# init / conversion helpers
# ---------------------------------------------------------------------------

# kept in f32 by cast_decoder_params: norm scales, the router and the
# latent model's rotary frequencies
_F32_NAMES = ("ln1", "ln2", "final_norm", "kv_norm", "router", "rope_freq")
_INT8_WEIGHT_NAMES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "wqkv", "wgu")


def init_decoder(
    cfg: DecoderConfig, generator: torch.Generator, device: str | torch.device
) -> Params:
    """Seeded random parameters built on ``device`` (the generator must live
    there): weights ~ N(0, 0.02) drawn in f32 and cast to ``cfg.dtype``,
    norm scales 1 and biases 0 in f32 — the JAX package's
    ``init_decoder_params`` distribution followed by ``cast_decoder_params``.
    Unfused names; draws follow a fixed order, so one seed gives one model."""
    hd = cfg.hd

    def w(*shape):
        draw = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (draw * 0.02).to(cfg.dtype)

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=device)

    p: Params = {
        "embed": w(cfg.vocab_size, cfg.hidden),
        "final_norm": ones(cfg.hidden),
        "layers": [],
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = w(cfg.hidden, cfg.vocab_size)
    for _ in range(cfg.layers):
        layer = {
            "ln1": ones(cfg.hidden),
            "ln2": ones(cfg.hidden),
            "wq": w(cfg.hidden, cfg.heads * hd),
            "wk": w(cfg.hidden, cfg.kv_heads * hd),
            "wv": w(cfg.hidden, cfg.kv_heads * hd),
            "wo": w(cfg.heads * hd, cfg.hidden),
            "wg": w(cfg.hidden, cfg.intermediate),
            "wu": w(cfg.hidden, cfg.intermediate),
            "wd": w(cfg.intermediate, cfg.hidden),
        }
        if cfg.attn_bias:
            for name, n in (("bq", cfg.heads), ("bk", cfg.kv_heads), ("bv", cfg.kv_heads)):
                layer[name] = torch.zeros((n * hd,), dtype=torch.float32, device=device)
        p["layers"].append(layer)
    return p


def cast_decoder_params(params: Params, dtype: torch.dtype) -> Params:
    """Weights and the embedding table in ``dtype``; norm scales, biases and
    already quantized ``{"q", "s"}`` / ``{"q4", "s4"}`` leaves as they are."""

    def cast(name, x):
        if isinstance(x, dict) or name in _F32_NAMES or name.startswith("b"):
            return x
        return x.to(dtype)

    out = {k: cast(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: cast(k, v) for k, v in layer.items()} for layer in params["layers"]]
    return out


def fuse_decoder_params(params: Params) -> Params:
    """Concatenate each layer's QKV (and gate/up) along the output axis, so
    a layer runs 4 matmuls instead of 7. Columns of a matrix product are
    independent, so the fused results are the unfused ones; fuse before
    quantizing (per-output-channel scales survive the same way). A latent
    attention layer has no QKV and an expert layer no dense gate/up: they
    stay as they are."""
    out = dict(params)
    layers = []
    for layer in params["layers"]:
        layer = dict(layer)
        if "wk" in layer:
            layer["wqkv"] = torch.cat([layer.pop("wq"), layer.pop("wk"), layer.pop("wv")],
                                      dim=-1)
        if "wg" in layer:
            layer["wgu"] = torch.cat([layer.pop("wg"), layer.pop("wu")], dim=-1)
        if "bq" in layer:
            layer["bqkv"] = torch.cat([layer.pop("bq"), layer.pop("bk"), layer.pop("bv")], dim=-1)
        layers.append(layer)
    out["layers"] = layers
    return out


def quantize_decoder_params(params: Params) -> Params:
    """int8-quantize every projection matrix (attention, MLP, ``lm_head``)
    to ``{"q": [N, K] int8, "s": [N] f32}`` with per-output-channel scales.
    Norm scales, biases and the embedding table (a gather) stay as they
    are. Apply after casting and fusing; never cast the result again."""

    def quant(w):
        q, s = quantize_linear_weight(w)
        return {"q": q, "s": s}

    out = dict(params)
    if "lm_head" in params:
        out["lm_head"] = quant(params["lm_head"])
    out["layers"] = [
        {k: quant(v) if k in _INT8_WEIGHT_NAMES else v for k, v in layer.items()}
        for layer in params["layers"]
    ]
    return out


def quantize_decoder_params_int4(params: Params, group_size: int = 128) -> Params:
    """int4-quantize every projection matrix (attention, MLP, ``lm_head``)
    to ``{"q4": [N, K/2] uint8, "s4": [N, G] f32}``: symmetric scales over
    groups of ``group_size`` along the contraction dimension, codes in
    ``[-8, 7]``, packed as ``ops/int4_linear.py`` documents. Norm scales,
    biases and the embedding table stay as they are. Apply after casting
    and fusing; never cast the result again."""

    def quant(w):
        q4, s4 = quantize_int4_weight(w, group_size)
        return {"q4": q4, "s4": s4}

    out = dict(params)
    if "lm_head" in params:
        out["lm_head"] = quant(params["lm_head"])
    out["layers"] = [
        {k: quant(v) if k in _INT8_WEIGHT_NAMES else v for k, v in layer.items()}
        for layer in params["layers"]
    ]
    return out


def init_quantized_decoder_params(
    cfg: DecoderConfig,
    generator: torch.Generator,
    device: str | torch.device,
    *,
    mode: str = "int4",
    group_size: int = 128,
) -> Params:
    """Seeded random parameters, quantized a layer at a time, for models
    whose float tree would not fit beside the quantized one: each layer is
    drawn in f32, cast, fused and quantized (``mode`` ``"int4"`` or
    ``"int8"``) before the next is drawn, so one layer's float weights are
    alive at a time. The layout is that of :func:`init_decoder` followed by
    :func:`fuse_decoder_params` and :func:`quantize_decoder_params_int4` (or
    :func:`quantize_decoder_params`); the draws are not those of
    :func:`init_decoder` for the same seed."""
    if mode not in ("int4", "int8"):
        raise ValueError(f"mode must be int4|int8, got {mode!r}")
    hd = cfg.hd

    def w(*shape):
        draw = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (draw * 0.02).to(cfg.dtype)

    def quant(x):
        if mode == "int4":
            q4, s4 = quantize_int4_weight(x, group_size)
            return {"q4": q4, "s4": s4}
        q, s = quantize_linear_weight(x)
        return {"q": q, "s": s}

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=device)

    p: Params = {"embed": w(cfg.vocab_size, cfg.hidden), "final_norm": ones(cfg.hidden),
                 "layers": []}
    if not cfg.tie_embeddings:
        p["lm_head"] = quant(w(cfg.hidden, cfg.vocab_size))
    for _ in range(cfg.layers):
        layer = {
            "ln1": ones(cfg.hidden),
            "ln2": ones(cfg.hidden),
            "wqkv": quant(torch.cat([w(cfg.hidden, cfg.heads * hd), w(cfg.hidden, cfg.kv_heads * hd),
                                     w(cfg.hidden, cfg.kv_heads * hd)], dim=-1)),
            "wo": quant(w(cfg.heads * hd, cfg.hidden)),
            "wgu": quant(torch.cat([w(cfg.hidden, cfg.intermediate),
                                    w(cfg.hidden, cfg.intermediate)], dim=-1)),
            "wd": quant(w(cfg.intermediate, cfg.hidden)),
        }
        if cfg.attn_bias:
            layer["bqkv"] = torch.zeros(((cfg.heads + 2 * cfg.kv_heads) * hd,),
                                        dtype=torch.float32, device=device)
        p["layers"].append(layer)
    return p


# int8 matmul strategy, read once like the JAX package reads it:
#   "w8a8"   — per-row int8 activations, an exact integer product, f32
#              rescale (ops/int8_linear.py::w8a8_matmul), for every M.
#   "kernel" — bf16 activations against weights dequantized tile by tile on
#              the chip (ops/int8_linear.py::int8_linear) at M <= 256, and a
#              dequantize-then-matmul above that.
_INT8_MODE = os.environ.get("DECODER_INT8_MODE", "w8a8")


# int4 matmul strategy at decode-size M, read once the same way:
#   "w4a8"   — per-row int8 activations, exact integer dots a scale group
#              (ops/int4_linear.py::w4a8_matmul). The default.
#   "kernel" — exact activations against weights decoded in registers on
#              the chip (ops/int4_linear.py::w4a16_matmul, one launch writing
#              the model's type).
#   "xla"    — never a kernel: the grouped product below for every small M
#              (the JAX package's name for its plain path, kept).
_INT4_MODE = os.environ.get("DECODER_INT4_MODE", "w4a8")

# The most rows that go to an int4 kernel. This is the JAX package's rule,
# carried over so that a given M gets the numerics it gets there (w4a8
# quantizes the activations, the grouped product does not); it is not a
# crossover measured on this card. The kernels themselves take up to 256 rows.
INT4_KERNEL_MAX_M = 32


def _mm_int4(
    x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor, dt: torch.dtype,
    out: torch.dtype | None = None,
) -> torch.Tensor:
    """``x @ dequant(q4, s4)`` for int4 weights, by the JAX package's rule:
    a kernel for up to ``INT4_KERNEL_MAX_M`` rows on the card when the mode
    and the shape allow it; else up to 256 rows one f32 product a scale
    group on the unpacked codes, the scales applied to the ``[G, M, N]``
    partial sums; above that one full dequantization to ``dt`` and a plain
    product. A CPU tensor takes the grouped product, as the JAX package
    does off the TPU. The result is ``out`` (``dt`` by default); an f32
    ``out`` keeps the f32 sum unrounded, the operands rounded as for
    ``dt``."""
    out = dt if out is None else out
    n, kp = q4.shape
    k = kp * 2
    g = s4.shape[-1]
    gsz = k // g
    lead = x.shape[:-1]
    m = math.prod(lead)
    x2 = x.reshape(m, k)
    if (
        m <= INT4_KERNEL_MAX_M
        and _INT4_MODE in ("kernel", "w4a8")
        and x.device.type == "cuda"
        and int4_kernel_eligible(m, k, n, gsz)
    ):
        # the shape rule is no fallback: a launch that fails raises
        if _INT4_MODE == "w4a8":
            # two launches: the row quantizer, and the product writing out
            return _w4a8_matmul_as(x2, q4, s4, out).reshape(*lead, n)
        # one launch, its epilogue writing out
        y = _w4a16_matmul_as(x2, q4, s4, dt) if out == dt else w4a16_matmul(x2, q4, s4, dt)
        return y.reshape(*lead, n)
    if m <= 256:
        # operands rounded to the model dtype, products and sums in f32
        # (int4 codes are exact in either)
        lhs = x2.to(dt).to(torch.float32).reshape(m, g, gsz).permute(1, 0, 2)  # [G, M, gsz]
        rhs = unpack_int4(q4).to(torch.float32).reshape(n, g, gsz).permute(1, 2, 0)  # [G, gsz, N]
        raw = torch.bmm(lhs, rhs)  # [G, M, N] partial sums, one a scale group
        y = (raw * s4.T[:, None, :]).sum(dim=0)
        return y.reshape(*lead, n).to(out)
    wd = (unpack_int4(q4).reshape(n, g, gsz).to(dt) * s4.to(dt)[:, :, None]).reshape(n, k)
    return x @ wd.T if out == dt else x.to(out) @ wd.to(out).T


def _mm(x: torch.Tensor, w, dt: torch.dtype) -> torch.Tensor:
    """``x @ w`` for dense weights (``[K, N]``), int8 ``{"q": [N, K],
    "s": [N]}`` or int4 ``{"q4": [N, K/2], "s4": [N, G]}``."""
    if not isinstance(w, dict):
        return x @ w.to(dt)
    if "q4" in w:
        return _mm_int4(x, w["q4"], w["s4"], dt)
    q, s = w["q"], w["s"]
    lead, k = x.shape[:-1], x.shape[-1]
    m = math.prod(lead)
    n = q.shape[0]
    if _INT8_MODE == "w8a8":
        # per-row activation scales: a token's result never depends on its
        # neighbours, so prefill stays independent of chunk boundaries
        return w8a8_matmul(x.reshape(m, k), q, s).reshape(*lead, n).to(dt)
    if m <= 256:
        # a width the kernel cannot take raises there: never the plain product
        x2 = x.reshape(m, k)
        pad = (-m) % 8
        if pad:
            x2 = torch.cat([x2, x2.new_zeros((pad, k))], dim=0)
        return int8_linear(x2, q, s)[:m].reshape(*lead, n).to(dt)
    wd = (q.to(dt) * s.to(dt)[:, None]).T  # [K, N]
    return x @ wd


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _rope_tables(positions: torch.Tensor, half: int, theta: float):
    """cos and sin of the rotary angles, f32 ``[B, T, 1, half]``, for
    integer ``positions`` [B, T]: computed once a forward, shared by every
    layer's q and k."""
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[:, :, None] * freqs[None, None, :]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def _qkv(h, layer, rope, cfg: DecoderConfig):
    """Q/K/V projections for T new tokens from the ln1-normed input:
    (q [B,T,H,Dh], k [B,T,KvH,Dh], v [B,T,KvH,Dh]). A fused ``wqkv`` runs
    the three as one matmul, and q, k and v are then views of its product.
    ``rope`` is the forward's (cos, sin) pair, which rotates q and k (the
    ring route); ``None`` leaves them unrotated for the paged route, whose
    page write rotates them (``ops/paged_attention.py::
    paged_kv_write_rope``)."""
    dt = h.dtype
    b, t, _ = h.shape
    nq, nkv = cfg.heads * cfg.hd, cfg.kv_heads * cfg.hd
    if "wqkv" in layer:
        qkv = _mm(h, layer["wqkv"], dt)
        if cfg.attn_bias:
            qkv = qkv + layer["bqkv"].to(dt)
        q, k, v = qkv[..., :nq], qkv[..., nq : nq + nkv], qkv[..., nq + nkv :]
    else:
        q = _mm(h, layer["wq"], dt)
        k = _mm(h, layer["wk"], dt)
        v = _mm(h, layer["wv"], dt)
        if cfg.attn_bias:
            q = q + layer["bq"].to(dt)
            k = k + layer["bk"].to(dt)
            v = v + layer["bv"].to(dt)
    q = q.reshape(b, t, cfg.heads, cfg.hd)
    k = k.reshape(b, t, cfg.kv_heads, cfg.hd)
    if rope is not None:
        q, k = _rope(q, *rope), _rope(k, *rope)
    return q, k, v.reshape(b, t, cfg.kv_heads, cfg.hd)


def _attn_ctx(q, cache_kv, mask_bias, cfg: DecoderConfig):
    """GQA attention of q [B,T,H,Dh] against one layer of the KV ring
    ([B, KvH, C, Dh] each): the context [B, T, H*Dh] before the output
    projection. Logits and softmax are f32; the probabilities are cast to
    the model dtype before ``p.v``."""
    dt = q.dtype
    hd, nh, nkv = cfg.hd, cfg.heads, cfg.kv_heads
    b, t = q.shape[0], q.shape[1]
    k_cache, v_cache = cache_kv
    qg = q.reshape(b, t, nkv, nh // nkv, hd)
    logits = torch.einsum("btngd,bncd->btngc", qg.float(), k_cache.float())
    logits = logits / math.sqrt(hd) + mask_bias[:, :, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(dt)
    ctx = torch.einsum("btngc,bncd->btngd", probs, v_cache)
    return ctx.reshape(b, t, nh * hd)


def _gate_up(h, layer, cfg: DecoderConfig):
    """``silu(gate) * up`` of the SwiGLU MLP; a fused ``wgu`` runs gate and
    up as one matmul."""
    dt = h.dtype
    if "wgu" in layer:
        gu = _mm(h, layer["wgu"], dt)
        gate, up = gu[..., : cfg.intermediate], gu[..., cfg.intermediate :]
    else:
        gate = _mm(h, layer["wg"], dt)
        up = _mm(h, layer["wu"], dt)
    return torch.nn.functional.silu(gate) * up


def _row_parallel(xs: list, ws: list, dt: torch.dtype) -> torch.Tensor:
    """``cat(xs, -1) @ cat(ws, K)`` for a row-parallel projection, shard r's
    slice of the contraction ``xs[r] @ ws[r]`` computed on its device, and
    the partial products summed on the first device in shard order (JAX's
    ``psum``). One shard is :func:`_mm`. Dense and int4 partials are
    computed with an f32 result (the operands rounded to ``dt`` as
    :func:`_mm` rounds them), summed in f32 and rounded once to ``dt``.
    w8a8 quantizes every row with its global absolute maximum (the largest
    of the shards') and sums the exact int32 partials, which gives the
    unsharded product bit for bit. A weight kept whole on the first shard
    (``ws[1:]`` None, ``parallel/tp.py``) takes the activations gathered
    there."""
    if len(ws) == 1:
        return _mm(xs[0], ws[0], dt)
    first = xs[0].device
    if ws[-1] is None:
        return _mm(torch.cat([x.to(first) for x in xs], dim=-1), ws[0], dt)
    if isinstance(ws[0], dict) and "q" in ws[0]:
        if _INT8_MODE != "w8a8":
            raise ValueError(
                "int8 weights under tensor parallelism are served by DECODER_INT8_MODE=w8a8 only"
            )
        lead = xs[0].shape[:-1]
        m = math.prod(lead)
        x2s = [x.reshape(m, x.shape[-1]).float() for x in xs]
        amax = torch.stack([x.abs().amax(dim=1).to(first) for x in x2s]).amax(dim=0)
        xs_scale = (amax[:, None] / 127.0).clamp_min(1e-12)
        raw = None
        for x2, w in zip(x2s, ws):
            xq = torch.round(x2 / xs_scale.to(x2.device)).clamp(-127, 127).to(torch.int8)
            part = _int_matmul(xq, w["q"]).to(first)
            raw = part if raw is None else raw + part
        s = ws[0]["s"].to(first)
        out = raw.to(torch.float32) * xs_scale * s[None, :].to(torch.float32)
        return out.reshape(*lead, s.shape[0]).to(dt)
    acc = None
    for x, w in zip(xs, ws):
        if isinstance(w, dict):
            part = _mm_int4(x, w["q4"], w["s4"], dt, out=torch.float32)
        else:
            part = x.float() @ w.to(dt).float()
        acc = part.to(first) if acc is None else acc + part.to(first)
    return acc.to(dt)


def init_cache(
    cfg: DecoderConfig, batch: int, device: str | torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """KV ring: (k, v), each [L, B, KvH, C, Dh] in cfg.dtype."""
    shape = (cfg.layers, batch, cfg.kv_heads, cfg.max_cache, cfg.hd)
    return (
        torch.zeros(shape, dtype=cfg.dtype, device=device),
        torch.zeros(shape, dtype=cfg.dtype, device=device),
    )


@dataclasses.dataclass
class PagedKV:
    """Paged KV cache: a shared pool of fixed-size pages plus per-row page
    tables. Device memory follows actual sequence lengths; the batcher's
    allocator (``serve/decode_batcher.py``) grants pages per request and
    reclaims them at finish. Page 0 is the scratch target of inactive rows
    (their forwards still write; the scratch page absorbs it).

    ``k`` / ``v``: ``[L, P, KvH, page, Dh]`` (a token's ``Dh`` values
    contiguous; layer ``li``'s pool is the view ``k[li]``). ``table``:
    ``[B, MAXP]`` int32 — row b's absolute positions
    ``[i*page, (i+1)*page)`` live in pool page ``table[b, i]``. Per-row
    capacity is ``MAXP * page``, which callers keep <= ``cfg.max_cache``.

    ``kv_dtype="int8"`` stores the pool quantized (symmetric per-token
    per-head int8; ``k_scale`` / ``v_scale``: ``[L, P, KvH, page]`` f32),
    dequantized inside the attention kernel.

    ``mesh`` marks a tensor-parallel pool (``parallel/tp.py``): ``k``, ``v``
    and the scales are then lists, one ``[L, P, KvH/n, ...]`` tensor a
    device of the mesh; the table is replicated host-written state, kept
    once on the mesh's first device.

    A latent attention model (``cfg.mla``) has ``latent`` ``[L, P, page,
    kv_lora_rank + qk_rope_dim]`` in the model dtype instead of ``k`` and
    ``v`` (None). Its forward gathers the first ``span`` table columns of
    every row (all of them when None): the caller that knows its rows'
    lengths sets it to cover every position the forward reads or writes.
    """

    k: torch.Tensor | list | None
    v: torch.Tensor | list | None
    table: torch.Tensor
    k_scale: torch.Tensor | list | None = None
    v_scale: torch.Tensor | list | None = None
    mesh: Any = None  # a TP mesh: k, v and the scales are per-device lists split on KvH
    latent: torch.Tensor | None = None  # [L, P, page, entry]: latent attention's pool
    span: int | None = None  # table columns a latent forward reads

    @property
    def page(self) -> int:
        if self.latent is not None:
            return self.latent.shape[2]
        k = self.k[0] if self.mesh is not None else self.k
        return k.shape[3]

    @property
    def bytes_per_token(self) -> int:
        """Device bytes the pool holds for one token of one row (every
        layer, shard and scale)."""
        pools = [self.latent, self.k, self.v, self.k_scale, self.v_scale]
        tensors = [t for p in pools if p is not None for t in (p if isinstance(p, list) else [p])]
        slots = tensors[0].shape[1] * self.page  # P pages of `page` tokens
        return sum(t.numel() * t.element_size() for t in tensors) // slots


def init_paged_cache(
    cfg: DecoderConfig,
    batch: int,
    pages: int,
    page_size: int = 128,
    kv_dtype: str | None = None,  # "int8" -> quantized pool
    device: str | torch.device = "cuda",
    mesh=None,  # TP mesh: pools split on KvH over its devices
) -> PagedKV:
    if cfg.max_cache % page_size:
        # a remainder would shrink per-row capacity below max_cache while
        # every position guard still assumes max_cache
        raise ValueError(f"max_cache={cfg.max_cache} not divisible by page_size={page_size}")
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (use 'int8' or None)")
    maxp = cfg.max_cache // page_size
    if cfg.mla is not None:
        check_latent_options(cfg, kv_int8=kv_dtype is not None, mesh=mesh)
        return PagedKV(
            k=None, v=None,
            table=torch.zeros((batch, maxp), dtype=torch.int32, device=device),
            latent=torch.zeros((cfg.layers, pages, page_size, cfg.mla.entry), dtype=cfg.dtype,
                               device=device),
        )
    if mesh is not None and cfg.kv_heads % mesh.size:
        raise ValueError(f"kv_heads={cfg.kv_heads} not divisible by TP mesh size {mesh.size}")
    n = 1 if mesh is None else mesh.size
    shape = (cfg.layers, pages, cfg.kv_heads // n, page_size, cfg.hd)
    devices = [device] if mesh is None else list(mesh.devices)
    table = torch.zeros((batch, maxp), dtype=torch.int32, device=devices[0])
    quant = kv_dtype == "int8"

    def pool(shp, dt):
        made = [torch.zeros(shp, dtype=dt, device=d) for d in devices]
        return made if mesh is not None else made[0]

    kv_dt = torch.int8 if quant else cfg.dtype
    return PagedKV(
        k=pool(shape, kv_dt),
        v=pool(shape, kv_dt),
        table=table,
        k_scale=pool(shape[:-1], torch.float32) if quant else None,
        v_scale=pool(shape[:-1], torch.float32) if quant else None,
        mesh=mesh,
    )


def check_latent_options(cfg: DecoderConfig, *, paged: bool = True, **options) -> None:
    """Refuse what a DeepSeek-V2 model (``cfg.mla`` and ``cfg.moe``) cannot
    serve: each option given a true value (``kv_int8``, ``int8_weights``,
    ``int4_weights``, ``spec_k``, ``mesh``, ``tp_devices``, ...) raises a
    ``ValueError`` that names it, and so does a forward without the paged
    pool (``paged`` false). A Llama/Qwen config passes."""
    if cfg.mla is None and cfg.moe is None:
        return
    if cfg.mla is None or cfg.moe is None:
        raise ValueError("latent attention and routed experts are served together (DeepSeek-V2)")
    for name, value in options.items():
        if value:
            raise ValueError(
                f"{name}={value!r} is not supported for a latent attention / expert decoder "
                "(DeepSeek-V2): it serves bf16 or f32 weights over the paged latent pool, "
                "on one device, without speculation"
            )
    if not paged:
        raise ValueError(
            "a latent attention / expert decoder (DeepSeek-V2) runs on the paged latent pool "
            "only: give the batcher kv_pages > 0 (and the provider batch_slots > 1)"
        )


def decoder_forward(
    params: Params,
    tokens: torch.Tensor,  # [B, T] integers — new tokens
    cache,  # KV ring tuple [L, B, KvH, C, Dh] or PagedKV
    start_pos: torch.Tensor,  # [B] int32 — absolute position of tokens[:, 0]
    cfg: DecoderConfig,
    route: torch.Tensor | None = None,  # expert models: int64 [cfg.moe_layers, experts] zeros
):
    """Run T tokens (prefill T > 1, decode T = 1) against the cache.

    Returns (logits [B, T, V] f32, the cache). **The cache is updated in
    place**: the ring's and the pool's tensors are written where they lie,
    and the object returned is the one passed in. Token i attends to all
    cache slots <= start + i; later slots are masked by position. With a
    :class:`PagedKV` the slots live in pooled pages addressed through the
    page table, written by ``paged_kv_write_rope`` (which also rotates q and
    k) and read by ``paged_attention``. Serving callers wrap this in
    ``torch.inference_mode()``. While autograd records, the ring's layers are
    attended as copies (the cache is still written), so the ring route can
    be differentiated (``models/train.py::lm_loss``); the paged route
    cannot.

    Parameters laid out over a TP mesh by ``parallel/tp.py::
    shard_decoder_params`` run the same layers shard by shard: each device
    its q/k/v, its heads' attention over its KV shard and its slice of the
    gate/up product, and the ``wo`` / ``wd`` partial products summed on the
    first device (:func:`_row_parallel`). The embedding, the norms and the
    head run once, on the first device. The cache is then the ring sharded
    by ``shard_decoder_cache`` or a :class:`PagedKV` of the same mesh.
    Unsharded parameters are the one-shard case.

    A latent attention config (``cfg.mla``, DeepSeek-V2) takes
    :func:`_latent_forward` over the pool's ``latent`` entries: each layer's
    attention from ``models/mla.py``, its MLP dense below
    ``cfg.moe.first_dense`` and from ``models/moe.py`` above, which leaves
    each expert layer's per-expert pair counts in its row of ``route`` (a
    buffer of the forward's own when None).
    """
    if cfg.mla is not None:
        return _latent_forward(params, tokens, cache, start_pos, cfg, route)
    from outline_rag_tpu_torch.parallel.mesh import Mesh  # noqa: PLC0415
    from outline_rag_tpu_torch.parallel.tp import MODEL_AXIS, local_config  # noqa: PLC0415

    mesh = params.get("mesh")
    dt = cfg.dtype
    b, t = tokens.shape
    first = params["embed"].device
    if mesh is None:
        lcfg, shards_of = cfg, lambda layer: [layer]
    else:
        lcfg, shards_of = local_config(cfg, mesh.size), lambda layer: layer["shards"]
    # the mesh the paged walk runs over: one device for unsharded parameters
    walk = mesh if mesh is not None else Mesh([first], (MODEL_AXIS,))
    per_device = (lambda x: x) if mesh is not None else (lambda x: [x])
    x = params["embed"][tokens.long().to(first)].to(dt)
    start_pos = start_pos.to(first, torch.int32)
    positions = start_pos[:, None] + torch.arange(t, dtype=torch.int32, device=first)[None, :]
    rope = _rope_tables(positions, cfg.hd // 2, cfg.rope_theta)
    ropes = [tuple(r.to(d) for r in rope) for d in walk.devices]

    paged = isinstance(cache, PagedKV)
    if paged:
        if cache.mesh != mesh:
            raise ValueError(f"the pool is laid out over {cache.mesh}, the parameters over {mesh}")
        pools = [None if p is None else per_device(p)
                 for p in (cache.k, cache.v, cache.k_scale, cache.v_scale)]
    else:
        k_ring, v_ring = (per_device(r) for r in cache)
        if mesh is not None and not (isinstance(cache[0], list) and len(k_ring) == mesh.size):
            raise ValueError(
                "a tensor-parallel forward needs the KV ring sharded on its mesh "
                "(parallel/tp.py::shard_decoder_cache)"
            )
        c = cfg.max_cache
        # attention bias [B, T, C]: slot j visible to token i iff j <= pos_i
        slot = torch.arange(c, dtype=torch.int32, device=first)
        mask = slot[None, None, :] <= positions[:, :, None]
        mask_bias = torch.where(mask, 0.0, -1e9).to(torch.float32)
        # the T new entries land at start_pos per row (a write that would
        # pass the end is shifted back to fit, as dynamic_update_slice does)
        rows = torch.arange(b, device=first)[:, None]
        cols = (positions - (positions[:, -1:] - (c - 1)).clamp_min(0)).long()  # [B, T]
        at = [(mask_bias.to(d), rows.to(d), cols.to(d)) for d in walk.devices]
        grad = torch.is_grad_enabled()
    for li, layer in enumerate(params["layers"]):
        shards = shards_of(layer)
        h = _rms_norm(x, layer["ln1"], cfg.norm_eps)
        qkv = [_qkv(h.to(d), lr, None if paged else ropes[r], lcfg)
               for r, (d, lr) in enumerate(zip(walk.devices, shards))]
        if paged:
            k_pool, v_pool, ks_pool, vs_pool = (
                None if p is None else [one[li] for one in p] for p in pools)
            # one launch a shard: q and k rotated, k and v quantized for an
            # int8 pool and written to their pages; the rotated q comes back
            q_new, k_new, v_new = (list(x) for x in zip(*qkv))
            qs = paged_kv_write_rope_sharded(
                k_pool, v_pool, cache.table, start_pos, q_new, k_new, v_new,
                [c for c, _ in ropes], [s for _, s in ropes], ks_pool, vs_pool, mesh=walk,
            )
            ctxs = paged_attention_sharded(
                qs, k_pool, v_pool, cache.table, start_pos, ks_pool, vs_pool, mesh=walk,
            )
            ctxs = [ctx.reshape(b, t, -1) for ctx in ctxs]
        else:
            ctxs = []
            for r, (q, k_new, v_new) in enumerate(qkv):
                bias, rr, cc = at[r]
                k_layer, v_layer = k_ring[r][li], v_ring[r][li]
                if grad:
                    # autograd keeps this layer's ring for the backward pass, and
                    # the next layer's write into the shared [L, ...] tensor would
                    # bump its version: attend over a copy, and give the cache the
                    # new entries without their graph
                    k_layer[rr, :, cc] = k_new.detach().to(dt)
                    v_layer[rr, :, cc] = v_new.detach().to(dt)
                    k_layer, v_layer = k_layer.clone(), v_layer.clone()
                k_layer[rr, :, cc] = k_new.to(dt)
                v_layer[rr, :, cc] = v_new.to(dt)
                ctxs.append(_attn_ctx(q, (k_layer, v_layer), bias, lcfg))
        x = x + _row_parallel(ctxs, [lr["wo"] for lr in shards], dt)
        h2 = _rms_norm(x, layer["ln2"], cfg.norm_eps)
        acts = [_gate_up(h2.to(d), lr, lcfg) for d, lr in zip(walk.devices, shards)]
        x = x + _row_parallel(acts, [lr["wd"] for lr in shards], dt)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return _mm(x, head, dt).float(), cache


def _latent_forward(params: Params, tokens, cache, start_pos, cfg: DecoderConfig, route):
    """:func:`decoder_forward` of a latent attention model (DeepSeek-V2)
    over a :class:`PagedKV` with ``latent`` entries, on one device."""
    from outline_rag_tpu_torch.models import mla, moe  # noqa: PLC0415

    check_latent_options(cfg, paged=isinstance(cache, PagedKV) and cache.latent is not None,
                         mesh=params.get("mesh"))
    dt = cfg.dtype
    t = tokens.shape[1]
    x = params["embed"][tokens.long()].to(dt)
    start_pos = start_pos.to(x.device, torch.int32)
    at = mla.walk(params["rope_freq"], cache.table, start_pos, t, cache.page, cache.span, cfg)
    if route is None:
        route = torch.zeros((cfg.moe_layers, cfg.moe.experts), dtype=torch.int64,
                            device=x.device)
    for li, layer in enumerate(params["layers"]):
        h = _rms_norm(x, layer["ln1"], cfg.norm_eps)
        x = x + _mm(mla.attend(h, layer, cache.latent[li], at, cfg), layer["wo"], dt)
        h = _rms_norm(x, layer["ln2"], cfg.norm_eps)
        if "router" in layer:
            x = x + moe.forward(h, layer, cfg, route[li - cfg.moe.first_dense])
        else:
            x = x + _mm(_gate_up(h, layer, cfg), layer["wd"], dt)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _mm(x, params["lm_head"], dt).float(), cache


# ---------------------------------------------------------------------------
# sampling + chunked generation
# ---------------------------------------------------------------------------

_GOLDEN = -7046029254386353131  # 0x9E3779B97F4A7C15 as a signed 64-bit integer
_MIX1 = -4658895280553007687  # 0xBF58476D1CE4E5B9
_MIX2 = -7723592293110705685  # 0x94D049BB133111EB


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 (``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer on int64 tensors (products wrap)."""
    x = (x ^ _lsr(x, 30)) * _MIX1
    x = (x ^ _lsr(x, 27)) * _MIX2
    return x ^ _lsr(x, 31)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """A new key from ``key`` and integers ``data`` (broadcast together):
    a counter-based hash, so it has no state to advance and every
    (key, data) pair names one stream on every device."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    return _mix64(_mix64(key) + data * _GOLDEN)


def make_key(seed, device: str | torch.device) -> torch.Tensor:
    """The base key of an integer seed (a tensor of seeds gives a tensor of
    keys): int64."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    return fold_in(torch.zeros_like(seed), seed)


def key_at(base: torch.Tensor, pos) -> torch.Tensor:
    """Sampler key for absolute position ``pos`` of the stream ``base``."""
    return fold_in(base, pos)


def _gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] f32 standard Gumbel noise, entry (b, i) a function of
    (keys[b], i) alone."""
    bits = fold_in(keys[:, None], torch.arange(n, device=keys.device)[None, :])
    u = (_lsr(bits, 41).to(torch.float32) + 0.5) / float(1 << 23)  # in (0, 1), exact
    return -torch.log(-torch.log(u))


def sample_token(
    logits: torch.Tensor,  # [B, V] f32
    key: torch.Tensor,  # int64: [B] per-row keys, or one key folded with the row index
    temperature,  # float, or [B] tensor for mixed-request batches
    top_p,
    top_k_cap: int = 64,
) -> torch.Tensor:
    """Temperature + nucleus sampling: [B] int32. ``temperature <= 0`` means
    greedy (``argmax``, lowest index on ties). The nucleus is taken within
    the top ``top_k_cap`` logits, selected by a stable sort (ties to the
    lowest index); the draw is Gumbel-max over the kept logits with noise
    from ``key``, so row b's token depends only on (its key, its logits)."""
    b, v = logits.shape
    dev = logits.device
    greedy = torch.argmax(logits, dim=-1)
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=dev).expand(b)
    tp = torch.as_tensor(top_p, dtype=torch.float32, device=dev).expand(b)
    keys = key if key.dim() == 1 else fold_in(key, torch.arange(b, device=dev))
    scaled = logits / temp.clamp_min(1e-4)[:, None]
    cap = min(top_k_cap, v)
    order = torch.sort(scaled, dim=-1, descending=True, stable=True)
    top_vals, top_idx = order.values[:, :cap], order.indices[:, :cap]
    csum = torch.cumsum(torch.softmax(top_vals, dim=-1), dim=-1)
    # smallest prefix with cumulative mass >= top_p; keep at least 1
    keep = torch.cat(
        [torch.ones((b, 1), dtype=torch.bool, device=dev), csum[:, :-1] < tp[:, None]], dim=1
    )
    masked = torch.where(keep, top_vals, torch.full_like(top_vals, float("-inf")))
    choice = torch.argmax(masked + _gumbel(keys, cap), dim=-1)
    sampled = torch.gather(top_idx, 1, choice[:, None])[:, 0]
    return torch.where(temp <= 0.0, greedy, sampled).to(torch.int32)


def _sample_one(logits, key, temperature, top_p, top_k_cap: int = 64) -> torch.Tensor:
    """Single-row sampler ([V] logits, one key): the same math as
    :func:`sample_token` with that key as the row's own."""
    return sample_token(logits[None], key.reshape(1), temperature, top_p, top_k_cap)[0]


def propose_ngram(
    buf: torch.Tensor,  # [B, C] int32 — tokens 0..pos are trustworthy
    pos: torch.Tensor,  # [B] int32 — position of the current (fed) token
    *,
    gram: int,
    k: int,
) -> torch.Tensor:
    """Prompt-lookup draft proposal: finds the most recent earlier
    occurrence of the ``gram`` tokens ending at ``pos`` and proposes the
    ``k`` tokens that followed it, ``[B, k]`` (hypotheses for positions
    ``pos + 1 .. pos + k``). Answers over retrieved context quote it, so the
    continuation of a repeated n-gram is a strong draft; a wrong draft costs
    nothing, since acceptance compares the model's own samples with it.
    Without a match the drafts are arbitrary tokens that fail acceptance.
    Tensor code on ``buf``'s device: shifted compares over ``[B, C]``."""
    b, c = buf.shape
    dev = buf.device
    pos = pos.long()
    start = (pos - (gram - 1)).clamp(0, c - gram)
    suffix = torch.gather(buf, 1, start[:, None] + torch.arange(gram, device=dev)[None, :])
    nj = c - gram - k + 1  # candidate gram starts with a full draft slice
    eq = torch.ones((b, nj), dtype=torch.bool, device=dev)
    for i in range(gram):
        eq = eq & (buf[:, i : i + nj] == suffix[:, i : i + 1])
    j_idx = torch.arange(nj, device=dev)
    # the gram (and at least its first draft token) must lie in the known
    # region, and must not be the current suffix itself
    valid = eq & (j_idx[None, :] <= (pos - gram)[:, None])
    best = torch.where(valid, j_idx[None, :], -1).amax(dim=1)
    first = torch.where(best >= 0, best + gram, 0)
    return torch.gather(buf, 1, first[:, None] + torch.arange(k, device=dev)[None, :])


def generate_chunk_spec(
    params: Params,
    cache,
    tok_buf: torch.Tensor,  # [B, C] int32 — all tokens so far (prompt + emitted)
    token: torch.Tensor,  # [B] int32 — next token to feed (already emitted)
    pos: torch.Tensor,  # [B] int32 — its absolute position
    key: torch.Tensor,  # int64 scalar base key; per-position keys are folded in
    cfg: DecoderConfig,
    *,
    n_steps: int,
    draft_k: int,
    gram: int = 3,
    temperature,  # float, or [B] tensor for mixed-request batches
    top_p,
    eos_id: int,
    done0: torch.Tensor | None = None,  # [B] bool — rows to skip (the batcher's idle slots)
    force_accept: bool = False,
    seeds: torch.Tensor | None = None,  # [B] integers — per-row sampler streams
):
    """Speculative generation: ``n_steps`` verify steps with no host
    synchronisation.

    Each step proposes ``draft_k`` prompt-lookup drafts, runs one
    ``[B, 1 + draft_k]`` forward, samples every position q with
    ``key_at(base, q)``, and accepts the longest prefix where the sample
    equals the draft: between 1 and ``draft_k + 1`` tokens a forward. The
    emitted tokens are always the model's own samples, drawn with the keys
    the plain positional loop draws with, so the output is that loop's.
    ``base`` is ``key`` itself, or ``fold_in(key, seeds[b])`` a row.

    Cache discipline: a verify writes slots ``pos .. pos + draft_k``;
    rejected slots are stale, but every later window starts at the first
    stale slot and rewrites forward, and the position mask hides slots
    beyond the current token. The token buffer follows the same rule. A row
    whose window would pass the capacity is frozen (its count stays 0).

    ``force_accept`` accepts every draft whatever the samples say, to time
    the all-accepted ceiling; it changes the text and must never serve.

    **``cache`` and ``tok_buf`` are updated in place.** Returns ``(emitted
    [B, n_steps * (draft_k + 1)], count [B], cache, tok_buf, next_token,
    next_pos)``; the caller consumes ``emitted[b, :count[b]]`` and stops at
    the first eos."""
    b = token.shape[0]
    dev = token.device
    c = cfg.max_cache
    kk = draft_k + 1
    offs = torch.arange(kk, device=dev)
    rows = torch.arange(b, device=dev)
    out = torch.zeros((b, n_steps * kk), dtype=torch.int32, device=dev)
    temp_b = torch.as_tensor(temperature, dtype=torch.float32, device=dev).expand(b)
    tp_b = torch.as_tensor(top_p, dtype=torch.float32, device=dev).expand(b)
    # per-row base keys: mixed-request batches must not share randomness
    base_rows = key.expand(b) if seeds is None else fold_in(key, seeds.to(dev))
    tok = token.to(torch.int32)
    pos = pos.to(torch.int32)
    done = torch.zeros((b,), dtype=torch.bool, device=dev) if done0 is None else done0.clone()
    cursor = torch.zeros((b,), dtype=torch.long, device=dev)
    for _ in range(n_steps):
        # capacity guard: a window needs slots pos .. pos + draft_k
        done = done | (pos + kk > c)
        posf = pos.clamp(max=c - kk)
        tok_buf[rows, posf.long()] = tok
        drafts = propose_ngram(tok_buf, posf, gram=gram, k=draft_k)
        window = torch.cat([tok[:, None], drafts], dim=1)
        logits, cache = decoder_forward(params, window, cache, posf, cfg)
        sample_pos = posf.long()[:, None] + 1 + offs[None, :]
        keys = key_at(base_rows[:, None], sample_pos)
        # e[:, i] is the sample for position posf + 1 + i
        e = sample_token(
            logits.reshape(b * kk, -1), keys.reshape(-1),
            temp_b.repeat_interleave(kk), tp_b.repeat_interleave(kk),
        ).reshape(b, kk)
        if force_accept:
            match = torch.ones((b, draft_k), dtype=torch.bool, device=dev)
        else:
            match = e[:, :draft_k] == drafts
        cnt = torch.cumprod(match.long(), dim=1).sum(dim=1) + 1  # accepted drafts + bonus sample
        # truncate at the first emitted eos (inclusive), freeze after
        is_eos = (e == eos_id) & (offs[None, :] < cnt[:, None])
        has_eos = is_eos.any(dim=1)
        cnt = torch.where(has_eos, is_eos.long().argmax(dim=1) + 1, cnt)
        cnt = torch.where(done, torch.zeros_like(cnt), cnt)
        newdone = done | has_eos
        last = torch.gather(e, 1, (cnt - 1).clamp_min(0)[:, None])[:, 0]
        tok = torch.where(cnt > 0, torch.where(newdone, torch.full_like(last, eos_id), last), tok)
        # unmasked window writes: slots beyond cnt are stale but every later
        # window starts at the first stale slot and rewrites. Only the first
        # draft_k samples are written (the accepted prefix is at most draft_k
        # past posf; the bonus sample becomes the next fed token and is
        # written at the new posf next step), so the last write lands at
        # posf + draft_k <= c - 1
        tok_buf[rows[:, None], posf.long()[:, None] + 1 + offs[None, :draft_k]] = e[:, :draft_k]
        out[rows[:, None], cursor[:, None] + offs[None, :]] = e
        cursor = cursor + cnt
        pos = pos + cnt.to(torch.int32)
        done = newdone
    return out, cursor.to(torch.int32), cache, tok_buf, tok, pos


def generate_chunk(
    params: Params,
    cache,
    token: torch.Tensor,  # [B] int32 — next token to feed (not yet written)
    pos: torch.Tensor,  # [B] int32 — its absolute position
    key: torch.Tensor,  # int64 scalar
    cfg: DecoderConfig,
    *,
    n_steps: int,
    temperature,
    top_p,
    eos_id: int,
):
    """Generate ``n_steps`` tokens with no host synchronisation: a loop of
    eager steps whose sampling and eos freeze stay on the device.

    Caller protocol: prefill with :func:`decoder_forward` over the prompt,
    sample the first token from the final logits (the caller emits it), then
    call this with (token=first_sampled, pos=prompt_len). Each step writes
    ``token`` into the cache and emits the next sample; after eos the stream
    freezes on eos. Step i of a chunk draws with ``fold_in(key, i)``.
    Returns (tokens [B, n_steps], cache, next_token, next_pos)."""
    tok = token.to(torch.int32)
    pos = pos.to(torch.int32)
    done = torch.zeros_like(tok, dtype=torch.bool)
    out = []
    for i in range(n_steps):
        logits, cache = decoder_forward(params, tok[:, None], cache, pos, cfg)
        nxt = sample_token(logits[:, -1, :], fold_in(key, i), temperature, top_p)
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        done = done | (nxt == eos_id)
        tok, pos = nxt, pos + 1
        out.append(nxt)
    return torch.stack(out, dim=1), cache, tok, pos
