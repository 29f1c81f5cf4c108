"""Model weights: the JAX parameter pytree -> the port's modules, and the
seeded random init used where no checkpoint is available.

The JAX package's encoder and reranker parameters (``init_encoder_params``
/ ``init_reranker_params`` layout, per-layer list form) arrive as numpy
arrays and come back as :class:`Encoder` / :class:`Reranker` modules that
compute the same function. JAX stores dense weights as ``[in, out]`` for
``x @ w``; ``nn.Linear`` holds ``[out, in]``, so every dense weight is
transposed. Values are cast to the config's dtype the way the JAX
package's ``cast_params`` casts them (round to nearest even). A JAX
``EncoderConfig`` is translated field by field, ``attn_impl`` included
(:func:`config_from_jax`).

The decoder's parameters stay a dictionary (``models/decoder.py``), so
:func:`decoder_from_jax` only turns leaves into tensors: dense weights keep
the JAX layout ``[K, N]``, int8 ``{"q", "s"}`` leaves are taken as they
are, stacked ``[L, ...]`` layers are split into the per-layer list, and a
JAX ``PagedKV`` is re-laid from position-minor pages to the port's
``[L, P, KvH, page, Dh]`` (:func:`paged_kv_from_jax`).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from outline_rag_tpu_torch.models.decoder import (
    DecoderConfig,
    PagedKV,
    cast_decoder_params,
)
from outline_rag_tpu_torch.models.encoder import Encoder, EncoderConfig, zero_linear
from outline_rag_tpu_torch.models.reranker import Reranker


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def config_from_jax(jcfg) -> EncoderConfig:
    """The port's :class:`EncoderConfig` for a JAX package ``EncoderConfig``
    (read by attribute, so jax is not imported here): the same widths,
    depth, positions, eps, compute dtype and attention route."""
    return EncoderConfig(
        vocab_size=jcfg.vocab_size,
        hidden=jcfg.hidden,
        layers=jcfg.layers,
        heads=jcfg.heads,
        intermediate=jcfg.intermediate,
        max_positions=jcfg.max_positions,
        pad_id=jcfg.pad_id,
        layer_norm_eps=jcfg.layer_norm_eps,
        dtype=_DTYPES[np.dtype(jcfg.dtype).name],
        attn_impl=jcfg.attn_impl,
    )


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _set_linear(lin: nn.Linear, w, b) -> None:
    lin.weight.copy_(_t(w).T)
    lin.bias.copy_(_t(b))


def _load_encoder(enc: Encoder, params: Mapping[str, Any]) -> None:
    e = params["embed"]
    with torch.no_grad():
        enc.word.copy_(_t(e["word"]))
        enc.position.copy_(_t(e["position"]))
        enc.token_type.copy_(_t(e["token_type"]))
        enc.embed_ln.weight.copy_(_t(e["ln_scale"]))
        enc.embed_ln.bias.copy_(_t(e["ln_bias"]))
        if len(params["layers"]) != len(enc.layers):
            raise ValueError(f"{len(params['layers'])} layers for a {len(enc.layers)}-layer config")
        for layer, lp in zip(enc.layers, params["layers"]):
            a, m = lp["attn"], lp["mlp"]
            _set_linear(layer.q, a["wq"], a["bq"])
            _set_linear(layer.k, a["wk"], a["bk"])
            _set_linear(layer.v, a["wv"], a["bv"])
            _set_linear(layer.o, a["wo"], a["bo"])
            layer.attn_ln.weight.copy_(_t(a["ln_scale"]))
            layer.attn_ln.bias.copy_(_t(a["ln_bias"]))
            _set_linear(layer.mlp_in, m["wi"], m["bi"])
            _set_linear(layer.mlp_out, m["wo"], m["bo"])
            layer.mlp_ln.weight.copy_(_t(m["ln_scale"]))
            layer.mlp_ln.bias.copy_(_t(m["ln_bias"]))


def encoder_from_jax(
    params_np: Mapping[str, Any], cfg: EncoderConfig, device: str | torch.device
) -> Encoder:
    """The encoder, with BGE-m3's sparse and ColBERT heads where
    ``params_np`` has them (``"sparse"``, ``"colbert"``)."""
    heads = {k: params_np[k] for k in ("sparse", "colbert") if k in params_np}
    enc = Encoder(
        cfg, device, sparse="sparse" in heads,
        colbert_dim=np.shape(heads["colbert"]["w"])[1] if "colbert" in heads else 0,
    )
    _load_encoder(enc, params_np)
    with torch.no_grad():
        for name, head in heads.items():
            _set_linear(getattr(enc, name), head["w"], head["b"])
    return enc.eval()


def reranker_from_jax(
    params_np: Mapping[str, Any], cfg: EncoderConfig, device: str | torch.device
) -> Reranker:
    rr = Reranker(cfg, device)
    _load_encoder(rr.encoder, params_np)
    c = params_np["classifier"]
    with torch.no_grad():
        _set_linear(rr.dense, c["dense_w"], c["dense_b"])
        _set_linear(rr.out, c["out_w"], c["out_b"])
    return rr.eval()


def fill_normal_(module: nn.Module, generator: torch.Generator, std: float = 0.02) -> None:
    """Seeded init in place: every weight matrix and embedding table
    ~ N(0, std) (drawn in f32, then cast), biases 0, layernorms (1, 0) —
    the JAX package's ``init_encoder_params`` distribution. Draws follow
    parameter registration order, so one seed gives one model."""
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() < 2:
                continue  # biases stay 0, layernorms stay (1, 0)
            draw = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=p.device)
            p.copy_(draw * std)


def init_encoder(
    cfg: EncoderConfig, generator: torch.Generator, device: str | torch.device
) -> Encoder:
    """A seeded random encoder built directly on ``device`` (the
    generator must live on that device)."""
    enc = Encoder(cfg, device)
    fill_normal_(enc, generator)
    return enc.eval()


def init_sparse_head(encoder: Encoder, generator: torch.Generator) -> Encoder:
    """Give ``encoder`` a seeded BGE-m3 sparse head, Linear(H, 1) with
    N(0, 0.02) weights and a zero bias (the JAX package's
    ``init_sparse_head``); returns the encoder."""
    encoder.sparse = zero_linear(encoder.cfg.hidden, 1, encoder.cfg, encoder.word.device)
    fill_normal_(encoder.sparse, generator)
    return encoder


def init_colbert_head(encoder: Encoder, generator: torch.Generator) -> Encoder:
    """Give ``encoder`` a seeded BGE-m3 ColBERT head, Linear(H, H) (bge-m3's
    ``colbert_linear`` is 1024 -> 1024), N(0, 0.02) weights and a zero bias
    (``init_colbert_head``)."""
    cfg = encoder.cfg
    encoder.colbert = zero_linear(cfg.hidden, cfg.hidden, cfg, encoder.word.device)
    fill_normal_(encoder.colbert, generator)
    return encoder


def init_reranker(
    cfg: EncoderConfig, generator: torch.Generator, device: str | torch.device
) -> Reranker:
    """A seeded random reranker built directly on ``device``."""
    rr = Reranker(cfg, device)
    fill_normal_(rr, generator)
    return rr.eval()


# ---------------------------------------------------------------------------
# Decoder LM (Llama / Qwen2 family) -> models/decoder.py params
# ---------------------------------------------------------------------------


def decoder_config_from_jax(jcfg) -> DecoderConfig:
    """The port's :class:`DecoderConfig` for a JAX package ``DecoderConfig``
    (read by attribute, so jax is not imported here)."""
    return DecoderConfig(
        vocab_size=jcfg.vocab_size,
        hidden=jcfg.hidden,
        layers=jcfg.layers,
        heads=jcfg.heads,
        kv_heads=jcfg.kv_heads,
        intermediate=jcfg.intermediate,
        head_dim=jcfg.head_dim,
        rope_theta=jcfg.rope_theta,
        norm_eps=jcfg.norm_eps,
        attn_bias=jcfg.attn_bias,
        tie_embeddings=jcfg.tie_embeddings,
        max_cache=jcfg.max_cache,
        dtype=_DTYPES[np.dtype(jcfg.dtype).name],
    )


def _leaf(x, device) -> torch.Tensor:
    """A numpy leaf as a tensor of the same values: integers keep their
    dtype, floats (bfloat16 arrays included) arrive as f32."""
    arr = np.asarray(x)
    if arr.dtype.kind not in "iu":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, order="C")).to(device)  # a writable copy


def decoder_from_jax(
    params_np: Mapping[str, Any], cfg: DecoderConfig, device: str | torch.device
) -> dict:
    """The JAX package's decoder parameters (numpy leaves) as the port's.

    ``params_np["layers"]`` may be the per-layer list or the stacked
    dictionary of ``[L, ...]`` leaves; names may be fused (``wqkv``,
    ``wgu``, ``bqkv``) or not; a weight may be dense ``[K, N]``, an int8
    ``{"q": [N, K], "s": [N]}`` leaf or an int4 ``{"q4": [N, K/2], "s4":
    [N, G]}`` leaf (the port keeps the JAX package's packing, so the bytes
    are copied). Dense weights and the embedding table are cast to
    ``cfg.dtype`` as ``cast_decoder_params`` casts them (round to nearest
    even); norm scales, biases and quantized leaves are kept."""

    def convert(x):
        if isinstance(x, Mapping):
            return {k: _leaf(v, device) for k, v in x.items()}
        return _leaf(x, device)

    layers = params_np["layers"]
    if isinstance(layers, Mapping):  # stacked: split the leading layer axis
        def pick(x, i):
            return {k: pick(v, i) for k, v in x.items()} if isinstance(x, Mapping) else x[i]

        layers = [{k: pick(v, i) for k, v in layers.items()} for i in range(cfg.layers)]
    if len(layers) != cfg.layers:
        raise ValueError(f"{len(layers)} layers for a {cfg.layers}-layer config")
    out = {k: convert(v) for k, v in params_np.items() if k != "layers"}
    out["layers"] = [{k: convert(v) for k, v in layer.items()} for layer in layers]
    return cast_decoder_params(out, cfg.dtype)


def paged_kv_from_jax(cache_np, device: str | torch.device) -> PagedKV:
    """A JAX ``PagedKV`` whose leaves are numpy arrays (read by attribute)
    as the port's: pools ``[L, P, KvH, Dh, page]`` (position minor) become
    ``[L, P, KvH, page, Dh]``; the table and the int8 pool's scales
    ``[L, P, KvH, page]`` keep their layout. A tensor-parallel pool is not
    ported yet."""
    if getattr(cache_np, "mesh", None) is not None:
        raise NotImplementedError("tensor-parallel KV pools are not ported yet: a later slice")

    def pool(x):
        return _leaf(x, device).permute(0, 1, 2, 4, 3).contiguous()

    quant = cache_np.k_scale is not None
    return PagedKV(
        k=pool(cache_np.k),
        v=pool(cache_np.v),
        table=_leaf(cache_np.table, device).to(torch.int32),
        k_scale=_leaf(cache_np.k_scale, device) if quant else None,
        v_scale=_leaf(cache_np.v_scale, device) if quant else None,
    )


def decoder_params_from_state_dict(
    sd: Mapping[str, Any], cfg: DecoderConfig, device: str | torch.device
) -> dict:
    """An HF ``LlamaForCausalLM`` / ``Qwen2ForCausalLM`` state dict (tensors
    or arrays) as the port's unfused decoder parameters, in f32 (cast with
    ``cast_decoder_params``). ``nn.Linear`` holds ``[out, in]``; the
    decoder multiplies ``x @ w``, so every projection is transposed."""

    def get(name):
        x = sd[name]
        x = x.detach().to(torch.float32) if isinstance(x, torch.Tensor) else _t(x)
        return x.to(device)

    p = {
        "embed": get("model.embed_tokens.weight"),
        "final_norm": get("model.norm.weight"),
        "layers": [],
    }
    if not cfg.tie_embeddings and "lm_head.weight" in sd:
        p["lm_head"] = get("lm_head.weight").T.contiguous()
    names = (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"), ("wv", "self_attn.v_proj"),
             ("wo", "self_attn.o_proj"), ("wg", "mlp.gate_proj"), ("wu", "mlp.up_proj"),
             ("wd", "mlp.down_proj"))
    for i in range(cfg.layers):
        pre = f"model.layers.{i}."
        layer = {
            "ln1": get(pre + "input_layernorm.weight"),
            "ln2": get(pre + "post_attention_layernorm.weight"),
        }
        for ours, theirs in names:
            layer[ours] = get(f"{pre}{theirs}.weight").T.contiguous()
        if cfg.attn_bias:
            for ours, theirs in names[:3]:
                layer["b" + ours[1]] = get(f"{pre}{theirs}.bias")
        p["layers"].append(layer)
    return p
