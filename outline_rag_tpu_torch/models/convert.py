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
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from outline_rag_tpu_torch.models.encoder import Encoder, EncoderConfig
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
    params_np: Mapping[str, Any], cfg: EncoderConfig, device: str | torch.device = "cpu"
) -> Encoder:
    enc = Encoder(cfg, device)
    _load_encoder(enc, params_np)
    return enc.eval()


def reranker_from_jax(
    params_np: Mapping[str, Any], cfg: EncoderConfig, device: str | torch.device = "cpu"
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


def init_reranker(
    cfg: EncoderConfig, generator: torch.Generator, device: str | torch.device
) -> Reranker:
    """A seeded random reranker built directly on ``device``."""
    rr = Reranker(cfg, device)
    fill_normal_(rr, generator)
    return rr.eval()
