"""Model weights: HF checkpoints on disk and the JAX parameter pytree ->
the port's modules, and the seeded random init used where no checkpoint is
available.

:func:`load_pretrained` reads a local XLM-RoBERTa-family checkpoint
(``BAAI/bge-m3``, ``BAAI/bge-reranker-v2-m3``) and
:func:`load_pretrained_decoder` a Llama / Qwen2 one, as the JAX package's
``models/convert.py`` does: ``pytorch_model.bin``, ``model.safetensors`` or
the sharded ``model.safetensors.index.json``; the ``roberta.`` / ``model.``
/ ``bert.`` task prefix stripped; BGE-m3's ``sparse_linear.pt`` and
``colbert_linear.pt`` heads beside the trunk; a ``classifier.*`` head makes
a :class:`Reranker`. Tensors go from the files straight into the module's
parameters (``nn.Linear`` holds ``[out, in]`` as the files do), cast to the
model dtype by ``copy_`` (round to nearest even, as the JAX package's
``cast_params``) on the module's device.

The JAX package's encoder and reranker parameters (``init_encoder_params``
/ ``init_reranker_params`` layout, per-layer list form) arrive as numpy
arrays and come back as :class:`Encoder` / :class:`Reranker` modules that
compute the same function. JAX stores dense weights as ``[in, out]`` for
``x @ w``; ``nn.Linear`` holds ``[out, in]``, so every dense weight is
transposed. Values are cast to the config's dtype the way the JAX
package's ``cast_params`` casts them (round to nearest even). A JAX
``EncoderConfig`` is translated field by field, ``attn_impl`` included
(:func:`config_from_jax`). :func:`encoder_to_jax` / :func:`reranker_to_jax`
read a float trunk back into that layout, to hold trained weights to the
JAX package's.

The decoder's parameters stay a dictionary (``models/decoder.py``), so
:func:`decoder_from_jax` only turns leaves into tensors: dense weights keep
the JAX layout ``[K, N]``, int8 ``{"q", "s"}`` leaves are taken as they
are, stacked ``[L, ...]`` layers are split into the per-layer list, and a
JAX ``PagedKV`` is re-laid from position-minor pages to the port's
``[L, P, KvH, page, Dh]`` (:func:`paged_kv_from_jax`).
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from outline_rag_tpu_torch.models.decoder import (
    DecoderConfig,
    MLAConfig,
    MoEConfig,
    PagedKV,
    YarnRope,
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


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy: an f32 CPU tensor's ``numpy()`` would share its memory."""
    return np.array(t.detach().float().cpu())


def _linear_np(lin: nn.Linear, w: str, b: str) -> dict:
    return {w: np.ascontiguousarray(_np(lin.weight).T), b: _np(lin.bias)}


def encoder_to_jax(enc: Encoder) -> dict:
    """The encoder's trunk as the JAX package's parameters (numpy, f32,
    per-layer list form, dense weights ``[in, out]``): the inverse of
    :func:`encoder_from_jax` for an unfused float trunk, used to hold
    trained weights to the JAX package's."""
    layers = []
    for layer in enc.layers:
        attn = {**_linear_np(layer.q, "wq", "bq"), **_linear_np(layer.k, "wk", "bk"),
                **_linear_np(layer.v, "wv", "bv"), **_linear_np(layer.o, "wo", "bo"),
                "ln_scale": _np(layer.attn_ln.weight), "ln_bias": _np(layer.attn_ln.bias)}
        mlp = {**_linear_np(layer.mlp_in, "wi", "bi"), **_linear_np(layer.mlp_out, "wo", "bo"),
               "ln_scale": _np(layer.mlp_ln.weight), "ln_bias": _np(layer.mlp_ln.bias)}
        layers.append({"attn": attn, "mlp": mlp})
    embed = {"word": _np(enc.word), "position": _np(enc.position),
             "token_type": _np(enc.token_type), "ln_scale": _np(enc.embed_ln.weight),
             "ln_bias": _np(enc.embed_ln.bias)}
    return {"embed": embed, "layers": layers}


def reranker_to_jax(rr: Reranker) -> dict:
    """:func:`encoder_to_jax` of the trunk with the ``classifier`` head."""
    return {**encoder_to_jax(rr.encoder), "classifier": {
        **_linear_np(rr.dense, "dense_w", "dense_b"), **_linear_np(rr.out, "out_w", "out_b")}}


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


def paged_kv_from_jax(cache_np, device: str | torch.device | None = None, mesh=None) -> PagedKV:
    """A JAX ``PagedKV`` whose leaves are numpy arrays (read by attribute)
    as the port's: pools ``[L, P, KvH, Dh, page]`` (position minor) become
    ``[L, P, KvH, page, Dh]``; the table and the int8 pool's scales
    ``[L, P, KvH, page]`` keep their layout. A tensor-parallel pool (its
    ``mesh`` set) needs the port's TP ``mesh`` of the same size: its pools
    are split on KvH over that mesh's devices, the table kept on the
    first."""
    jax_mesh = getattr(cache_np, "mesh", None)
    if (jax_mesh is None) != (mesh is None):
        raise ValueError(
            "a tensor-parallel pool converts onto a TP mesh, and only such a pool does: "
            f"the pool's mesh is {jax_mesh}, the one given {mesh}"
        )
    if mesh is not None:
        if jax_mesh.size != mesh.size:
            raise ValueError(f"a pool over {jax_mesh.size} devices onto a {mesh.size}-device mesh")
        device = mesh.devices[0]
    elif device is None:
        raise ValueError("paged_kv_from_jax needs a device or a TP mesh")

    def shards(x):
        if mesh is None:
            return x
        return [c.to(d).contiguous() for c, d in
                zip(torch.split(x, x.shape[2] // mesh.size, dim=2), mesh.devices)]

    def pool(x):
        return shards(_leaf(x, device).permute(0, 1, 2, 4, 3).contiguous())

    quant = cache_np.k_scale is not None
    return PagedKV(
        k=pool(cache_np.k),
        v=pool(cache_np.v),
        table=_leaf(cache_np.table, device).to(torch.int32),
        k_scale=shards(_leaf(cache_np.k_scale, device)) if quant else None,
        v_scale=shards(_leaf(cache_np.v_scale, device)) if quant else None,
        mesh=mesh,
    )


def decoder_params_from_state_dict(
    sd: Mapping[str, Any],
    cfg: DecoderConfig,
    device: str | torch.device,
    dtype: torch.dtype = torch.float32,
) -> dict:
    """An HF ``LlamaForCausalLM`` / ``Qwen2ForCausalLM`` state dict (tensors
    or arrays) as the port's unfused decoder parameters: projections, the
    embedding table and the ``lm_head`` in ``dtype``, norm scales and biases
    in f32 (``cast_decoder_params``'s rule, so casting again changes
    nothing). ``nn.Linear`` holds ``[out, in]``; the decoder multiplies
    ``x @ w``, so every projection is transposed."""

    def get(name, to=torch.float32):
        x = sd[name]
        x = x.detach() if isinstance(x, torch.Tensor) else _t(x)
        return x.to(device=device, dtype=to)

    p = {
        "embed": get("model.embed_tokens.weight", dtype),
        "final_norm": get("model.norm.weight"),
        "layers": [],
    }
    if not cfg.tie_embeddings and "lm_head.weight" in sd:
        p["lm_head"] = get("lm_head.weight", dtype).T.contiguous()
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
            layer[ours] = get(f"{pre}{theirs}.weight", dtype).T.contiguous()
        if cfg.attn_bias:
            for ours, theirs in names[:3]:
                layer["b" + ours[1]] = get(f"{pre}{theirs}.bias")
        p["layers"].append(layer)
    return p


# ---------------------------------------------------------------------------
# HF checkpoints on disk
# ---------------------------------------------------------------------------


def _load_state_dict(path: str) -> dict:
    """Weight-file discovery shared by every loader: ``pytorch_model.bin``
    or ``model.safetensors``, else the sharded layout
    (``model.safetensors.index.json`` -> its shards). Tensors stay on the
    CPU in their file dtype (a ``.bin`` is memory-mapped)."""
    from safetensors.torch import load_file  # noqa: PLC0415

    for fname in ("pytorch_model.bin", "model.safetensors"):
        full = os.path.join(path, fname)
        if os.path.exists(full):
            if fname.endswith(".safetensors"):
                return load_file(full)
            return torch.load(full, map_location="cpu", weights_only=True, mmap=True)
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        sd = {}
        for shard in sorted(set(weight_map.values())):
            sd.update(load_file(os.path.join(path, shard)))
        return sd
    raise FileNotFoundError(f"no weight file found under {path}")


def config_from_hf(hf_config, dtype: torch.dtype = torch.bfloat16) -> EncoderConfig:
    return EncoderConfig(
        vocab_size=hf_config.vocab_size,
        hidden=hf_config.hidden_size,
        layers=hf_config.num_hidden_layers,
        heads=hf_config.num_attention_heads,
        intermediate=hf_config.intermediate_size,
        max_positions=hf_config.max_position_embeddings,
        pad_id=hf_config.pad_token_id,
        layer_norm_eps=hf_config.layer_norm_eps,
        dtype=dtype,
    )


def _strip_task_prefix(sd: dict) -> dict:
    """Drop the task model's prefix (``roberta.``, ``model.``, ``bert.``)
    where the trunk's embeddings carry it."""
    for prefix in ("roberta.", "model.", "bert."):
        if any(k.startswith(prefix + "embeddings") for k in sd):
            return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}
    return sd


def _copy_linear(lin: nn.Linear, weight, bias) -> None:
    lin.weight.copy_(weight)
    lin.bias.copy_(bias)


def _copy_encoder_state(enc: Encoder, sd: Mapping[str, torch.Tensor]) -> None:
    """An HF XLM-R trunk state dict (prefix stripped) into ``enc``."""
    with torch.no_grad():
        enc.word.copy_(sd["embeddings.word_embeddings.weight"])
        enc.position.copy_(sd["embeddings.position_embeddings.weight"])
        enc.token_type.copy_(sd["embeddings.token_type_embeddings.weight"][:1])
        enc.embed_ln.weight.copy_(sd["embeddings.LayerNorm.weight"])
        enc.embed_ln.bias.copy_(sd["embeddings.LayerNorm.bias"])
        for i, layer in enumerate(enc.layers):
            b = f"encoder.layer.{i}."
            for lin, name in ((layer.q, "attention.self.query"), (layer.k, "attention.self.key"),
                              (layer.v, "attention.self.value"),
                              (layer.o, "attention.output.dense"),
                              (layer.mlp_in, "intermediate.dense"),
                              (layer.mlp_out, "output.dense")):
                _copy_linear(lin, sd[b + name + ".weight"], sd[b + name + ".bias"])
            for ln, name in ((layer.attn_ln, "attention.output.LayerNorm"),
                             (layer.mlp_ln, "output.LayerNorm")):
                ln.weight.copy_(sd[b + name + ".weight"])
                ln.bias.copy_(sd[b + name + ".bias"])


def load_pretrained(
    path: str, device: str | torch.device, dtype: torch.dtype = torch.bfloat16
) -> Encoder | Reranker:
    """A local XLM-RoBERTa-family checkpoint as the port's module on
    ``device``, in ``dtype``: a :class:`Reranker` when the weights hold a
    ``classifier.*`` head, else an :class:`Encoder` with BGE-m3's sparse
    (``sparse_linear.pt``, H -> 1) and ColBERT (``colbert_linear.pt``,
    H -> Hc) heads where those files are present."""
    from transformers import AutoConfig  # noqa: PLC0415

    cfg = config_from_hf(AutoConfig.from_pretrained(path), dtype)
    sd = _strip_task_prefix(_load_state_dict(path))
    if "classifier.dense.weight" in sd:
        model = Reranker(cfg, device)
        _copy_encoder_state(model.encoder, sd)
        with torch.no_grad():
            _copy_linear(model.dense, sd["classifier.dense.weight"], sd["classifier.dense.bias"])
            _copy_linear(model.out, sd["classifier.out_proj.weight"], sd["classifier.out_proj.bias"])
        return model.eval()
    heads = {}
    for name in ("sparse", "colbert"):
        head_path = os.path.join(path, f"{name}_linear.pt")
        if os.path.exists(head_path):
            heads[name] = torch.load(head_path, map_location="cpu", weights_only=True)
    model = Encoder(
        cfg, device, sparse="sparse" in heads,
        colbert_dim=heads["colbert"]["weight"].shape[0] if "colbert" in heads else 0,
    )
    _copy_encoder_state(model, sd)
    with torch.no_grad():
        for name, head in heads.items():
            _copy_linear(getattr(model, name), head["weight"], head["bias"])
    return model.eval()


def _rope_theta(hf_config) -> float:
    """``rope_theta``, read where ``transformers`` 5 keeps it too
    (``rope_parameters``); 10,000 when neither says."""
    theta = getattr(hf_config, "rope_theta", None)
    if theta is None:
        theta = (getattr(hf_config, "rope_parameters", None) or {}).get("rope_theta", 10000.0)
    return float(theta)


def decoder_config_from_hf(hf_config, dtype: torch.dtype = torch.bfloat16) -> DecoderConfig:
    """The port's config of a Llama / Qwen2-family or DeepSeek-V2
    (``model_type`` "deepseek_v2") HF config, read by attribute."""
    if getattr(hf_config, "model_type", "") == "deepseek_v2":
        return _deepseek_v2_config(hf_config, dtype)
    return DecoderConfig(
        vocab_size=hf_config.vocab_size,
        hidden=hf_config.hidden_size,
        layers=hf_config.num_hidden_layers,
        heads=hf_config.num_attention_heads,
        kv_heads=getattr(hf_config, "num_key_value_heads", hf_config.num_attention_heads),
        intermediate=hf_config.intermediate_size,
        head_dim=getattr(hf_config, "head_dim", None),
        rope_theta=_rope_theta(hf_config),
        norm_eps=hf_config.rms_norm_eps,
        attn_bias=bool(
            getattr(hf_config, "attention_bias", False)
            or getattr(hf_config, "model_type", "") == "qwen2"
        ),
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", False)),
        dtype=dtype,
    )


def _deepseek_v2_config(c, dtype: torch.dtype) -> DecoderConfig:
    """DeepSeek-V2 as DeepSeek-V2-Lite publishes it: latent attention
    without a q LoRA, YaRN rope, a softmax router with greedy top-k whose
    weights are neither renormalised nor scaled, and experts in every layer
    from ``first_k_dense_replace``. Any other variant raises a
    ``ValueError`` naming the option."""
    scaling = getattr(c, "rope_scaling", None) or {}
    refused = {
        "q_lora_rank": getattr(c, "q_lora_rank", None) is not None,
        "attention_bias": bool(getattr(c, "attention_bias", False)),
        "tie_word_embeddings": bool(getattr(c, "tie_word_embeddings", False)),
        "hidden_act": getattr(c, "hidden_act", "silu") != "silu",
        "rope_scaling": scaling.get("type", scaling.get("rope_type")) != "yarn",
        "n_routed_experts": not getattr(c, "n_routed_experts", None),
        "n_shared_experts": not getattr(c, "n_shared_experts", None),
        "topk_method": getattr(c, "topk_method", "greedy") != "greedy",
        "scoring_func": getattr(c, "scoring_func", "softmax") != "softmax",
        "norm_topk_prob": bool(getattr(c, "norm_topk_prob", False)),
        "routed_scaling_factor": float(getattr(c, "routed_scaling_factor", 1.0)) != 1.0,
        "moe_layer_freq": getattr(c, "moe_layer_freq", 1) != 1,
    }
    for name, bad in refused.items():
        if bad:
            raise ValueError(
                f"DeepSeek-V2 with {name}={getattr(c, name, None)!r} is not supported")
    yarn = YarnRope(
        factor=float(scaling["factor"]),
        original_max=int(scaling["original_max_position_embeddings"]),
        beta_fast=float(scaling.get("beta_fast", 32)),
        beta_slow=float(scaling.get("beta_slow", 1)),
        mscale=float(scaling.get("mscale", 1)),
        mscale_all_dim=float(scaling.get("mscale_all_dim", 0)),
    )
    return DecoderConfig(
        vocab_size=c.vocab_size, hidden=c.hidden_size, layers=c.num_hidden_layers,
        heads=c.num_attention_heads,
        kv_heads=getattr(c, "num_key_value_heads", c.num_attention_heads),
        intermediate=c.intermediate_size, rope_theta=_rope_theta(c), norm_eps=c.rms_norm_eps,
        dtype=dtype,
        mla=MLAConfig(yarn=yarn, kv_lora_rank=int(c.kv_lora_rank),
                      qk_nope_dim=int(c.qk_nope_head_dim), qk_rope_dim=int(c.qk_rope_head_dim),
                      v_head_dim=int(c.v_head_dim)),
        moe=MoEConfig(experts=int(c.n_routed_experts), top_k=int(c.num_experts_per_tok),
                      intermediate=int(c.moe_intermediate_size),
                      first_dense=int(c.first_k_dense_replace)),
    )


def stacked(tensors: list[torch.Tensor]) -> torch.Tensor:
    """``torch.stack(tensors)``, as a view when they lie one after another
    in one storage (a draw cut in that order, a safetensors shard), else as
    a copy."""
    first = tensors[0]
    n = first.numel()
    step = n * first.element_size()
    if all(t.is_contiguous() and t.shape == first.shape and t.dtype == first.dtype
           and t.device == first.device
           and t.untyped_storage().data_ptr() == first.untyped_storage().data_ptr()
           and t.data_ptr() == first.data_ptr() + i * step for i, t in enumerate(tensors)):
        return first.as_strided((len(tensors), *first.shape), (n, *first.stride()))
    return torch.stack(tensors)


def deepseek_v2_params_from_state_dict(
    sd: dict, cfg: DecoderConfig, device: str | torch.device, dtype: torch.dtype = torch.float32,
) -> dict:
    """A published ``DeepseekV2ForCausalLM`` state dict as the port's
    parameters, consuming ``sd`` (each entry is popped as it is taken).
    Weights already on ``device`` in ``dtype`` are taken as views, not
    copied: dense projections as the transposes ``[in, out]`` the decoder
    multiplies by, each layer's experts stacked (:func:`stacked`) in the
    published ``[out, in]`` layout, gate and up of an expert one after the
    other (``experts_gu`` ``[E, 2F, hidden]``, ``experts_down`` ``[E, hidden,
    F]``), ``kv_b_proj`` split by head into ``w_uk`` and ``w_uv`` ``[heads,
    128, kv_lora_rank]``. The shared experts' gate and up are concatenated
    (``shared_gu``); norm scales, the router and the rope frequencies are
    f32."""
    from outline_rag_tpu_torch.models.mla import rope_frequencies  # noqa: PLC0415

    mla, moe = cfg.mla, cfg.moe

    def get(name, to=dtype):
        x = sd.pop(name)
        x = x.detach() if isinstance(x, torch.Tensor) else _t(x)
        return x.to(device=device, dtype=to)

    p = {"embed": get("model.embed_tokens.weight"), "final_norm": get("model.norm.weight",
                                                                    torch.float32),
         "lm_head": get("lm_head.weight").T, "rope_freq": rope_frequencies(cfg, device),
         "layers": []}
    for i in range(cfg.layers):
        pre = f"model.layers.{i}."
        kv_b = get(pre + "self_attn.kv_b_proj.weight").view(
            cfg.heads, mla.qk_nope_dim + mla.v_head_dim, mla.kv_lora_rank)
        layer = {
            "ln1": get(pre + "input_layernorm.weight", torch.float32),
            "ln2": get(pre + "post_attention_layernorm.weight", torch.float32),
            "wq": get(pre + "self_attn.q_proj.weight").T,
            "wkv_a": get(pre + "self_attn.kv_a_proj_with_mqa.weight").T,
            "kv_norm": get(pre + "self_attn.kv_a_layernorm.weight", torch.float32),
            "w_uk": kv_b[:, : mla.qk_nope_dim], "w_uv": kv_b[:, mla.qk_nope_dim :],
            "wo": get(pre + "self_attn.o_proj.weight").T,
        }
        if i < moe.first_dense:
            for ours, theirs in (("wg", "gate_proj"), ("wu", "up_proj"), ("wd", "down_proj")):
                layer[ours] = get(f"{pre}mlp.{theirs}.weight").T
        else:
            ex = pre + "mlp.experts."
            gate_up = stacked([get(f"{ex}{e}.{w}.weight") for e in range(moe.experts)
                               for w in ("gate_proj", "up_proj")])
            layer["router"] = get(pre + "mlp.gate.weight", torch.float32)
            layer["experts_gu"] = gate_up.view(moe.experts, 2 * moe.intermediate, cfg.hidden)
            layer["experts_down"] = stacked([get(f"{ex}{e}.down_proj.weight")
                                             for e in range(moe.experts)])
            sh = pre + "mlp.shared_experts."
            layer["shared_gu"] = torch.cat([get(sh + "gate_proj.weight").T,
                                            get(sh + "up_proj.weight").T], dim=-1)
            layer["shared_down"] = get(sh + "down_proj.weight").T
        p["layers"].append(layer)
    return p


def load_pretrained_decoder(
    path: str, device: str | torch.device, dtype: torch.dtype = torch.bfloat16
) -> tuple[DecoderConfig, dict]:
    """``(cfg, params)`` of a local Llama / Qwen2-family checkpoint on
    ``device``: GQA head counts, Qwen2's q/k/v biases, a tied or untied
    ``lm_head``, ``head_dim`` and ``rope_theta`` where the config has them;
    or of a DeepSeek-V2 checkpoint (:func:`deepseek_v2_params_from_state_dict`)."""
    from transformers import AutoConfig  # noqa: PLC0415

    cfg = decoder_config_from_hf(AutoConfig.from_pretrained(path), dtype)
    load = deepseek_v2_params_from_state_dict if cfg.mla is not None else (
        decoder_params_from_state_dict)
    return cfg, load(_load_state_dict(path), cfg, device, dtype)
