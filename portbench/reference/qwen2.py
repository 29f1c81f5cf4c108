"""Qwen2 (``Qwen2ForCausalLM``) in plain PyTorch, float32 with TF32 off.

Written from the published architecture over a state dict in the Hugging
Face layout: RMSNorm, q/k/v projections with biases, rotary embedding in the
``rotate_half`` convention with ``rope_theta``, grouped-query attention with
a causal mask, a SwiGLU MLP, and the head tied to the embedding table.
Departures: no cache and no batching (one sequence, every position at once),
no sliding window (``use_sliding_window`` is false in the published config),
and the head's logits are computed in blocks of positions to bound memory.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.xlmr import _no_tf32


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def logits(sd: dict, cfg: dict, ids: torch.Tensor, block: int = 512) -> torch.Tensor:
    """Logits ``[T, V]`` f32 of the sequence ``ids`` [T] at every position."""
    eps = cfg["rms_norm_eps"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // heads
    t = ids.shape[0]
    dev = ids.device
    with _no_tf32():
        emb = sd["model.embed_tokens.weight"]
        x = emb[ids].float()
        inv = cfg["rope_theta"] ** (-torch.arange(0, hd, 2, device=dev, dtype=torch.float32) / hd)
        ang = torch.arange(t, device=dev, dtype=torch.float32)[:, None] * inv[None, :]
        ang = torch.cat([ang, ang], dim=-1)
        cos, sin = ang.cos()[None], ang.sin()[None]
        causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
        for i in range(cfg["num_hidden_layers"]):
            p = f"model.layers.{i}."

            def proj(h, name, n):
                w = sd[p + name + ".weight"].float()
                b = sd.get(p + name + ".bias")
                y = F.linear(h, w, None if b is None else b.float())
                return y.reshape(t, n, hd).transpose(0, 1)

            h = _rms(x, sd[p + "input_layernorm.weight"], eps)
            q = _rotate(proj(h, "self_attn.q_proj", heads), cos, sin)
            k = _rotate(proj(h, "self_attn.k_proj", kv), cos, sin)
            v = proj(h, "self_attn.v_proj", kv)
            k = k.repeat_interleave(heads // kv, dim=0)
            v = v.repeat_interleave(heads // kv, dim=0)
            s = (q @ k.transpose(1, 2)) / math.sqrt(hd)
            att = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
            ctx = (att @ v).transpose(0, 1).reshape(t, heads * hd)
            x = x + F.linear(ctx, sd[p + "self_attn.o_proj.weight"].float())
            h = _rms(x, sd[p + "post_attention_layernorm.weight"], eps)
            gate = F.linear(h, sd[p + "mlp.gate_proj.weight"].float())
            up = F.linear(h, sd[p + "mlp.up_proj.weight"].float())
            x = x + F.linear(F.silu(gate) * up, sd[p + "mlp.down_proj.weight"].float())
        x = _rms(x, sd["model.norm.weight"], eps)
        head = sd.get("lm_head.weight", emb).float()
        out = torch.empty((t, head.shape[0]), dtype=torch.float32, device=dev)
        for s0 in range(0, t, block):
            out[s0 : s0 + block] = x[s0 : s0 + block] @ head.T
        return out
