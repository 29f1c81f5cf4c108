"""Qwen2 (``Qwen2ForCausalLM``, ``model_type`` "qwen2"): the parts of a
decoder architecture that the harness finds by the configuration's
``model_type`` (``harness.py`` says what each does)."""

from __future__ import annotations

import torch

from portbench.reference.qwen2 import logits  # noqa: F401  the reference: logits(sd, cfg, ids)


def layout(cfg: dict) -> list[tuple[str, tuple, bool]]:
    """``(name, shape, is_norm_scale)`` of a Qwen2ForCausalLM with a tied head."""
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    hd = h // cfg["num_attention_heads"]
    nq, nkv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    out = [("model.embed_tokens.weight", (cfg["vocab_size"], h), False),
           ("model.norm.weight", (h,), True)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", (h,), True),
                (p + "post_attention_layernorm.weight", (h,), True)]
        for name, shape in (("self_attn.q_proj", (nq, h)), ("self_attn.k_proj", (nkv, h)),
                            ("self_attn.v_proj", (nkv, h))):
            out += [(p + name + ".weight", shape, False), (p + name + ".bias", shape[:1], False)]
        out += [(p + "self_attn.o_proj.weight", (h, nq), False),
                (p + "mlp.gate_proj.weight", (f, h), False),
                (p + "mlp.up_proj.weight", (f, h), False),
                (p + "mlp.down_proj.weight", (h, f), False)]
    if not cfg["tie_word_embeddings"]:
        out.append(("lm_head.weight", (cfg["vocab_size"], h), False))
    return out


def build(cfg: dict, sd: dict, device, dtype: torch.dtype):
    """The port's decoder parameters and ``DecoderConfig`` from the drawn
    state dict. The tied embedding is copied out of the draw's buffer, so
    that the buffer is freed once the loader's copies are made."""
    from outline_rag_tpu_torch.models.convert import decoder_params_from_state_dict
    from outline_rag_tpu_torch.models.decoder import DecoderConfig

    model_cfg = DecoderConfig(
        vocab_size=cfg["vocab_size"], hidden=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"], intermediate=cfg["intermediate_size"],
        head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"], attn_bias=True,
        tie_embeddings=cfg["tie_word_embeddings"],
        max_cache=cfg["max_position_embeddings"], dtype=dtype,
    )
    sd["model.embed_tokens.weight"] = sd["model.embed_tokens.weight"].clone()
    return decoder_params_from_state_dict(sd, model_cfg, device, dtype), model_cfg


def quantize(params: dict) -> dict:
    """The control's weights: the port's int8 copy (``DECODER_INT8``) of
    the served parameters."""
    from outline_rag_tpu_torch.models.decoder import quantize_decoder_params

    return quantize_decoder_params(params)


def lower(qparams: dict, model_cfg, ids: torch.Tensor) -> torch.Tensor:
    """The control's logits ``[T, V]``: one forward of ``quantize``'s
    weights over ``ids`` [T] from position 0."""
    from outline_rag_tpu_torch.models.decoder import decoder_forward, init_cache

    dev = ids.device
    out, _ = decoder_forward(qparams, ids.to(torch.int32)[None], init_cache(model_cfg, 1, dev),
                             torch.zeros((1,), dtype=torch.int32, device=dev), model_cfg)
    return out[0]


def token_flops(cfg: dict, context: int) -> float:
    """Model FLOPs of one token through a Qwen2 decoder at position
    ``context``: 2 x the non-embedding weights and the head, and attention
    over ``context + 1`` cached positions (q.k and p.v, 2 x 2 x Dh a head a
    position a layer)."""
    h, f, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = h // heads
    proj = h * (heads + 2 * kv) * hd + heads * hd * h + 3 * h * f
    return 2.0 * (n * proj + cfg["vocab_size"] * h) + 4.0 * n * heads * hd * (context + 1)
