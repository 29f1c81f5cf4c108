"""DeepSeek-V2 (``DeepseekV2ForCausalLM``, ``model_type`` "deepseek_v2") in
plain PyTorch, float32 with TF32 off.

Written from the published ``modeling_deepseek.py`` over a state dict in its
layout. Each layer: RMSNorm; latent attention without a q LoRA (``q_proj`` to
heads of ``qk_nope + qk_rope`` dims; ``kv_a_proj_with_mqa`` to the latent and
one rope key shared by the heads; ``kv_a_layernorm``; ``kv_b_proj`` to each
head's ``k_nope`` and value, the un-absorbed form); YaRN rotary embedding
with q_pe and k_pe de-interleaved before ``rotate_half``, and the softmax
scale times YaRN's ``mscale_all_dim`` term squared; causal softmax in f32.
Then RMSNorm and the MLP: a dense SwiGLU below ``first_k_dense_replace``,
else the MoE: a float32 softmax router, greedy top-k, the weights
renormalised only with ``norm_topk_prob`` (else times
``routed_scaling_factor``), each expert a SwiGLU over its own tokens (a loop
over the experts, as ``moe_infer``), the weighted sum, plus the shared
experts' SwiGLU. An untied head.

Departures: no cache and no batching (one sequence, every position at
once); the cos and sin tables stay in f32 (the published model caches them in
the model's dtype); the head's logits are computed in blocks of positions to
bound memory.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.xlmr import _no_tf32


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def _mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling") or {}
    if rs.get("mscale_all_dim"):
        scale *= _mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def rope_tables(cfg: dict, t: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin ``[T, qk_rope_head_dim]`` f32 of positions ``0..T-1``:
    the published ``DeepseekV2YarnRotaryEmbedding`` (plain rotary without
    ``rope_scaling``)."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    rs = cfg.get("rope_scaling") or {}
    extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=dev) / dim))
    inv, mscale = extra, 1.0
    if rs:
        factor, orig = rs["factor"], rs["original_max_position_embeddings"]
        inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                                      device=dev) / dim))

        def corr(rot):
            return (dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(base))

        low = max(math.floor(corr(rs.get("beta_fast", 32))), 0)
        high = min(math.ceil(corr(rs.get("beta_slow", 1))), dim - 1)
        if low == high:
            high += 0.001
        ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=dev) - low)
                / (high - low)).clamp(0, 1)
        mask = 1.0 - ramp
        inv = inter * (1 - mask) + extra * mask
        mscale = _mscale(factor, rs.get("mscale", 1)) / _mscale(factor,
                                                                rs.get("mscale_all_dim", 0))
    freqs = torch.outer(torch.arange(t, dtype=torch.float32, device=dev), inv)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * mscale, emb.sin() * mscale


def _rotate(x, cos, sin):
    """The published ``apply_rotary_pos_emb`` on ``[..., T, d]``."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    half = d // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def gate(x: torch.Tensor, weight: torch.Tensor, cfg: dict):
    """The published ``MoEGate`` (greedy top-k over softmax scores) on
    ``x`` [N, hidden]: ``(idx [N, k], weights [N, k] f32)``."""
    scores = F.linear(x.float(), weight.float()).softmax(dim=-1, dtype=torch.float32)
    w, idx = torch.topk(scores, cfg["num_experts_per_tok"], dim=-1, sorted=False)
    if cfg["num_experts_per_tok"] > 1 and cfg["norm_topk_prob"]:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        w = w * cfg["routed_scaling_factor"]
    return idx, w


def _mlp(x, p, sd):
    gate_ = F.linear(x, sd[p + "gate_proj.weight"].float())
    up = F.linear(x, sd[p + "up_proj.weight"].float())
    return F.linear(F.silu(gate_) * up, sd[p + "down_proj.weight"].float())


def _moe(x, p, sd, cfg):
    idx, w = gate(x, sd[p + "gate.weight"], cfg)
    out = torch.zeros((x.shape[0], idx.shape[1], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            out[tok, slot] = _mlp(x[tok], f"{p}experts.{e}.", sd)
    y = (out * w[..., None]).sum(dim=1)
    if cfg.get("n_shared_experts"):
        y = y + _mlp(x, p + "shared_experts.", sd)
    return y


def logits(sd: dict, cfg: dict, ids: torch.Tensor, block: int = 512) -> torch.Tensor:
    """Logits ``[T, V]`` f32 of the sequence ``ids`` [T] at every position."""
    eps = cfg["rms_norm_eps"]
    nh = cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank = cfg["kv_lora_rank"]
    t = ids.shape[0]
    dev = ids.device
    with _no_tf32():
        x = sd["model.embed_tokens.weight"][ids].float()
        cos, sin = rope_tables(cfg, t, dev)
        scale = softmax_scale(cfg)
        causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
        for i in range(cfg["num_hidden_layers"]):
            p = f"model.layers.{i}."
            a = p + "self_attn."
            h = _rms(x, sd[p + "input_layernorm.weight"], eps)
            q = F.linear(h, sd[a + "q_proj.weight"].float()).view(t, nh, nope + rope)
            q = q.transpose(0, 1)  # [nh, T, nope + rope]
            ckv = F.linear(h, sd[a + "kv_a_proj_with_mqa.weight"].float())
            c, k_pe = ckv[:, :rank], ckv[:, rank:]
            kv = F.linear(_rms(c, sd[a + "kv_a_layernorm.weight"], eps),
                          sd[a + "kv_b_proj.weight"].float()).view(t, nh, nope + vd)
            kv = kv.transpose(0, 1)
            k_nope, v = kv[..., :nope], kv[..., nope:]
            q_pe = _rotate(q[..., nope:], cos, sin)
            k_pe = _rotate(k_pe[None], cos, sin).expand(nh, t, rope)
            qs = torch.cat([q[..., :nope], q_pe], dim=-1)
            ks = torch.cat([k_nope, k_pe], dim=-1)
            s = (qs @ ks.transpose(1, 2)) * scale
            att = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
            ctx = (att @ v).transpose(0, 1).reshape(t, nh * vd)
            x = x + F.linear(ctx, sd[a + "o_proj.weight"].float())
            h = _rms(x, sd[p + "post_attention_layernorm.weight"], eps)
            if i < cfg["first_k_dense_replace"]:
                x = x + _mlp(h, p + "mlp.", sd)
            else:
                x = x + _moe(h, p + "mlp.", sd, cfg)
        x = _rms(x, sd["model.norm.weight"], eps)
        head = sd["lm_head.weight"].float()
        out = torch.empty((t, head.shape[0]), dtype=torch.float32, device=dev)
        for s0 in range(0, t, block):
            out[s0 : s0 + block] = x[s0 : s0 + block] @ head.T
        return out
