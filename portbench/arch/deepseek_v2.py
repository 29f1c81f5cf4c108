"""DeepSeek-V2 (``DeepseekV2ForCausalLM``, ``model_type`` "deepseek_v2"):
the parts of a decoder architecture that the harness finds by the
configuration's ``model_type`` (``harness.py`` says what each does), and
``expert_cost``, the bytes and operations of the routed experts that
``metrics/moe_expert_roofline.py`` reads."""

from __future__ import annotations

import dataclasses
import types

import torch

# the port's loader, imported here so that a port without it fails before any weight is drawn
from outline_rag_tpu_torch.models.convert import (
    decoder_config_from_hf,
    deepseek_v2_params_from_state_dict,
)
from outline_rag_tpu_torch.models.decoder import decoder_forward, init_paged_cache
from portbench.reference.deepseek_v2 import logits  # noqa: F401  the reference: logits(sd, cfg, ids)


def layout(cfg: dict) -> list[tuple[str, tuple, bool]]:
    """``(name, shape, is_norm_scale)`` of a DeepseekV2ForCausalLM without a
    q LoRA. Each expert layer lists its experts in order, each expert's gate
    then up, then every expert's down, so that the port's loader takes them
    as views of the draw."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank = cfg["kv_lora_rank"]
    out = [("model.embed_tokens.weight", (cfg["vocab_size"], h), False),
           ("model.norm.weight", (h,), True),
           ("lm_head.weight", (cfg["vocab_size"], h), False)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        out += [(p + "input_layernorm.weight", (h,), True),
                (p + "post_attention_layernorm.weight", (h,), True),
                (a + "q_proj.weight", (nh * (nope + rope), h), False),
                (a + "kv_a_proj_with_mqa.weight", (rank + rope, h), False),
                (a + "kv_a_layernorm.weight", (rank,), True),
                (a + "kv_b_proj.weight", (nh * (nope + vd), rank), False),
                (a + "o_proj.weight", (h, nh * vd), False)]
        m = p + "mlp."
        if i < cfg["first_k_dense_replace"]:
            f = cfg["intermediate_size"]
            out += [(m + "gate_proj.weight", (f, h), False), (m + "up_proj.weight", (f, h), False),
                    (m + "down_proj.weight", (h, f), False)]
            continue
        f, n = cfg["moe_intermediate_size"], cfg["n_routed_experts"]
        out.append((m + "gate.weight", (n, h), False))
        for e in range(n):
            out += [(f"{m}experts.{e}.gate_proj.weight", (f, h), False),
                    (f"{m}experts.{e}.up_proj.weight", (f, h), False)]
        out += [(f"{m}experts.{e}.down_proj.weight", (h, f), False) for e in range(n)]
        fs = f * cfg["n_shared_experts"]
        out += [(m + "shared_experts.gate_proj.weight", (fs, h), False),
                (m + "shared_experts.up_proj.weight", (fs, h), False),
                (m + "shared_experts.down_proj.weight", (h, fs), False)]
    return out


def build(cfg: dict, sd: dict, device, dtype: torch.dtype):
    """The port's decoder parameters and ``DecoderConfig`` from the drawn
    state dict, which the loader consumes: the served weights are views of
    the draw's one buffer (nothing is copied but the norm scales, the
    routers and the shared experts' fused gate and up)."""
    model_cfg = dataclasses.replace(decoder_config_from_hf(types.SimpleNamespace(**cfg), dtype),
                                    max_cache=cfg["max_position_embeddings"])
    return deepseek_v2_params_from_state_dict(sd, model_cfg, device, dtype), model_cfg


# the projections the control rounds, with the dimension their output
# channels' scales reduce over (the port keeps dense weights as [in, out],
# kv_b_proj and the experts in the published [out, in])
_ROUNDED = {"wq": 0, "wkv_a": 0, "wo": 0, "wgu": 0, "wd": 0, "shared_gu": 0, "shared_down": 0,
            "w_uk": -1, "w_uv": -1, "experts_gu": -1, "experts_down": -1}


def _round_int8_(w: torch.Tensor, dim: int) -> None:
    """``w`` rounded to int8 per output channel and back, in place."""
    for part in (w.unbind(0) if w.dim() == 3 else (w,)):  # one expert or head at a time
        x = part.float()
        s = (x.abs().amax(dim=dim, keepdim=True) / 127.0).clamp_min(1e-12)
        part.copy_(torch.round(x / s).clamp(-127, 127) * s)


def quantize(params: dict) -> dict:
    """The control's weights: every projection and expert of the served
    parameters rounded to int8 per output channel and back (the head too;
    not the embedding, a gather, nor the f32 router, which the published
    model keeps in f32 to route). In place, so it runs once the window has
    closed: a second copy of the weights would not fit beside them."""
    with torch.no_grad():
        _round_int8_(params["lm_head"], 0)
        for layer in params["layers"]:
            for name, dim in _ROUNDED.items():
                if name in layer:
                    _round_int8_(layer[name], dim)
    return params


def lower(qparams: dict, model_cfg, ids: torch.Tensor) -> torch.Tensor:
    """The control's logits ``[T, V]``: one forward of ``quantize``'s
    weights over ``ids`` [T] from position 0, through a one-row latent pool."""
    dev = ids.device
    n = -(-ids.shape[0] // 128)
    cache = init_paged_cache(model_cfg, 1, n + 1, 128, device=dev)
    cache.table[0, :n] = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    out, _ = decoder_forward(qparams, ids.to(torch.int32)[None], cache,
                             torch.zeros((1,), dtype=torch.int32, device=dev), model_cfg)
    return out[0]


def token_flops(cfg: dict, context: int) -> float:
    """Model FLOPs of one token through DeepSeek-V2 at position ``context``,
    whatever the implementation: 2 x the weights a token meets (latent
    attention's four projections in the published un-absorbed form, the
    dense MLP or the router, the ``num_experts_per_tok`` routed experts and
    the shared ones, the head) and attention over ``context + 1`` positions
    (q.k over ``qk_nope + qk_rope`` dims and p.v over ``v_head_dim``, 2
    FLOPs each a head a position a layer)."""
    h, nh, n = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_hidden_layers"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank = cfg["kv_lora_rank"]
    attn = h * nh * (nope + rope) + h * (rank + rope) + rank * nh * (nope + vd) + nh * vd * h
    dense = cfg["first_k_dense_replace"]
    f = cfg["moe_intermediate_size"]
    moe = (3 * h * f * (cfg["num_experts_per_tok"] + cfg["n_shared_experts"])
           + h * cfg["n_routed_experts"])
    weights = n * attn + dense * 3 * h * cfg["intermediate_size"] + (n - dense) * moe
    return (2.0 * (weights + cfg["vocab_size"] * h)
            + 2.0 * n * nh * (nope + rope + vd) * (context + 1))


def expert_cost(cfg: dict, experts_hit: int, pairs: int) -> tuple[float, float]:
    """``(bytes, flops)`` of the routed experts' products for ``pairs``
    token-expert pairs over ``experts_hit`` distinct expert-layer-steps:
    each distinct expert's gate, up and down weights read once, each pair's
    activation read and its output written, in bf16; 2 x 3 x hidden x
    ``moe_intermediate_size`` FLOPs a pair."""
    h, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    return 2.0 * (3 * h * f * experts_hit + 2 * h * pairs), 6.0 * h * f * pairs
