"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434) over the paged
latent pool, in plain PyTorch operations.

A token's attention state is one entry of the pool: the ``kv_a_layernorm``-
normed latent ``c`` (``kv_lora_rank`` values) and its rotated ``k_pe``
(``qk_rope_dim`` values, shared by every head). Keys and values are never
materialised: scores and context run in the absorbed form. Head ``h``'s
``q_nope`` goes through its slice of ``kv_b_proj`` (``W_UK[h]``) into the
latent's dims and meets the whole entry with ``q_pe`` beside it; the context
is a weighted sum of latents lifted through ``W_UV[h]``. Decode and prefill
chunks take the same path: write the new entries into their pages, gather the
rows' first ``span`` pages, two batched products. The published model's
un-absorbed form is ``portbench/reference/deepseek_v2.py``.

Rotary embedding follows the published ``apply_rotary_pos_emb``: q_pe and
k_pe are de-interleaved (even dims, then odd) before the half-split rotation,
with YaRN's frequencies and its cos/sin scale; YaRN also scales the softmax
(:func:`softmax_scale`). No host synchronisation: every index stays on the
device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from outline_rag_tpu_torch.models.decoder import DecoderConfig, MLAConfig, _rms_norm
from outline_rag_tpu_torch.ops.paged_attention import _rope


def yarn_mscale(scale: float, mscale: float) -> float:
    """The published ``yarn_get_mscale``."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float, max_pos: int) -> float:
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) / (2 * math.log(base))


def correction_range(mla: MLAConfig, base: float) -> tuple[int, int]:
    """The pairs between which YaRN ramps from kept to interpolated
    frequencies (the published ``yarn_find_correction_range``)."""
    y, dim = mla.yarn, mla.qk_rope_dim
    low = math.floor(_correction_dim(y.beta_fast, dim, base, y.original_max))
    high = math.ceil(_correction_dim(y.beta_slow, dim, base, y.original_max))
    return max(low, 0), min(high, dim - 1)


def rope_frequencies(cfg: DecoderConfig, device=None) -> torch.Tensor:
    """The rotary inverse frequencies of the rope dims, f32 ``[qk_rope_dim /
    2]``: YaRN's published mix of ``rope_theta``'s (``freq_extra``) and the
    ``factor``-interpolated ones (``freq_inter``)."""
    mla = cfg.mla
    dim, base = mla.qk_rope_dim, cfg.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (mla.yarn.factor * base ** exps)
    low, high = correction_range(mla, base)
    high = high + 0.001 if low == high else high
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def table_scale(mla: MLAConfig) -> float:
    """YaRN's factor on the cos and sin tables (1 at DeepSeek-V2's numbers,
    where ``mscale`` equals ``mscale_all_dim``)."""
    y = mla.yarn
    return yarn_mscale(y.factor, y.mscale) / yarn_mscale(y.factor, y.mscale_all_dim)


def softmax_scale(mla: MLAConfig) -> float:
    """``(qk_nope + qk_rope) ** -0.5``, times YaRN's ``mscale_all_dim``
    term squared: 0.11472 at DeepSeek-V2's numbers."""
    scale = (mla.qk_nope_dim + mla.qk_rope_dim) ** -0.5
    return scale * yarn_mscale(mla.yarn.factor, mla.yarn.mscale_all_dim) ** 2


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """The published ``view(..., d/2, 2).transpose``: even dims, then odd."""
    d = x.shape[-1]
    return x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)


@dataclasses.dataclass
class Walk:
    """What every layer of one forward shares: the rotary tables ``cos`` /
    ``sin`` f32 ``[B, T, 1, rope/2]``, the new entries' pages and slots
    ``[B, T]`` (positions past the table go to the scratch page 0), the pool
    pages each row reads ``[B, span]`` and which of their slots each new
    token sees ``[B, T, span * page]``."""

    cos: torch.Tensor
    sin: torch.Tensor
    pages: torch.Tensor
    slots: torch.Tensor
    read: torch.Tensor
    seen: torch.Tensor


def walk(freq: torch.Tensor, table: torch.Tensor, start_pos: torch.Tensor, t: int, page: int,
         span: int | None, cfg: DecoderConfig) -> Walk:
    """The :class:`Walk` of ``t`` new tokens a row from ``start_pos`` [B]
    over ``table`` [B, MAXP] (``span`` leading columns read; all when None),
    with the rotary frequencies ``freq`` (:func:`rope_frequencies`)."""
    dev = start_pos.device
    maxp = table.shape[1]
    span = maxp if span is None else min(int(span), maxp)
    positions = start_pos.long()[:, None] + torch.arange(t, device=dev)[None, :]  # [B, T]
    ang = positions.float()[:, :, None] * freq[None, None, :]
    mscale = table_scale(cfg.mla)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    tbl = table.long()
    page_idx = positions // page
    looked_up = torch.gather(tbl, 1, page_idx.clamp(max=maxp - 1))
    pages = torch.where(page_idx < maxp, looked_up, torch.zeros_like(looked_up))
    seen = torch.arange(span * page, device=dev)[None, None, :] <= positions[:, :, None]
    return Walk(cos[:, :, None, :], sin[:, :, None, :], pages, positions % page,
                tbl[:, :span], seen)


def attend(h: torch.Tensor, layer: dict, pool: torch.Tensor, at: Walk,
           cfg: DecoderConfig) -> torch.Tensor:
    """One layer's latent attention for the ln1-normed input ``h`` [B, T,
    hidden]: writes the T new entries into ``pool`` [P, page, entry] (in
    place) and returns the context ``[B, T, heads * v_head_dim]`` before
    ``o_proj``. Scores are the bf16 products' f32 values times
    :func:`softmax_scale`, softmax in f32, the probabilities cast to the
    model dtype before the context product."""
    mla = cfg.mla
    dt = h.dtype
    b, t, _ = h.shape
    nh, nope, rank = cfg.heads, mla.qk_nope_dim, mla.kv_lora_rank
    q = (h @ layer["wq"]).view(b, t, nh, nope + mla.qk_rope_dim)
    ckv = h @ layer["wkv_a"]  # [B, T, rank + rope]
    c = _rms_norm(ckv[..., :rank], layer["kv_norm"], cfg.norm_eps)
    q_pe = _rope(deinterleave(q[..., nope:]), at.cos, at.sin)
    k_pe = _rope(deinterleave(ckv[..., None, rank:]), at.cos, at.sin)[:, :, 0]
    pool[at.pages, at.slots] = torch.cat([c, k_pe], dim=-1)
    entries = pool[at.read].flatten(1, 2)  # [B, span * page, entry]
    q_lat = torch.einsum("bthd,hdc->bthc", q[..., :nope], layer["w_uk"])
    qe = torch.cat([q_lat, q_pe], dim=-1).reshape(b, t * nh, mla.entry)
    s = torch.bmm(qe, entries.transpose(1, 2)).float().view(b, t, nh, -1)
    s = (s * softmax_scale(mla)).masked_fill(~at.seen[:, :, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).to(dt).view(b, t * nh, -1)
    ctx = torch.bmm(p, entries[..., :rank]).view(b, t, nh, rank)
    out = torch.einsum("bthc,hdc->bthd", ctx, layer["w_uv"])  # [B, T, heads, v_head_dim]
    return out.reshape(b, t, nh * mla.v_head_dim)
