"""Routed experts with shared experts (DeepSeek-V2's ``DeepseekV2MoE``), in
plain PyTorch operations and, on the card, one grouped product a projection.

The router runs in float32 (the published ``MoEGate`` does, so that bf16
does not flip near ties): softmax scores over the experts, greedy top-k, the
weights as they are (``norm_topk_prob`` false, ``routed_scaling_factor`` 1
in DeepSeek-V2-Lite; ``models/convert.py`` refuses other values). The
routed (token, expert) pairs are grouped by expert with a stable sort and
counted by a ``scatter_add_`` into the caller's counter row, which also gives
the groups' offsets: nothing leaves the device. On the card the experts run
as two ``torch._grouped_mm`` launches over experts stacked in the published
``[out, in]`` layout (gate and up as one ``[E, 2F, hidden]`` product, then
down); elsewhere a plain loop over the experts computes the same function
(:func:`experts_plain`). The pairs' outputs go back to token order and are
summed with their weights in f32, as the published ``moe_infer`` does, then
the shared experts (one SwiGLU of width ``n_shared_experts *
moe_intermediate_size``) are added.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from outline_rag_tpu_torch.models.decoder import DecoderConfig


def route(x: torch.Tensor, router: torch.Tensor, cfg: DecoderConfig):
    """The experts and weights of each token of ``x`` [N, hidden]:
    ``(idx [N, k] int64, weights [N, k] f32)``, the top-k in no set order.
    ``router``: f32 ``[experts, hidden]``."""
    scores = F.linear(x.float(), router).softmax(dim=-1)
    weights, idx = torch.topk(scores, cfg.moe.top_k, dim=-1, sorted=False)
    return idx, weights


def _swiglu(gu: torch.Tensor) -> torch.Tensor:
    gate, up = gu.chunk(2, dim=-1)
    return F.silu(gate) * up


def experts_grouped(xs: torch.Tensor, counts: torch.Tensor, gate_up: torch.Tensor,
                    down: torch.Tensor) -> torch.Tensor:
    """The routed experts over pairs sorted by expert: ``xs`` [M, hidden],
    ``counts`` [E] (expert e takes the next ``counts[e]`` rows), ``gate_up``
    [E, 2F, hidden] and ``down`` [E, hidden, F] in the published ``[out,
    in]`` layout. Two grouped launches; the groups' ends stay on the
    device."""
    offs = counts.cumsum(0).to(torch.int32)
    act = _swiglu(torch._grouped_mm(xs, gate_up.transpose(1, 2), offs=offs))
    return torch._grouped_mm(act, down.transpose(1, 2), offs=offs)


def experts_plain(xs: torch.Tensor, counts: torch.Tensor, gate_up: torch.Tensor,
                  down: torch.Tensor) -> torch.Tensor:
    """:func:`experts_grouped`'s function as a loop over the experts (it
    reads the counts on the host)."""
    out = torch.empty_like(xs)
    start = 0
    for e, n in enumerate(counts.tolist()):
        if n:
            rows = xs[start : start + n]
            out[start : start + n] = F.linear(_swiglu(F.linear(rows, gate_up[e])), down[e])
            start += n
    return out


def forward(h: torch.Tensor, layer: dict, cfg: DecoderConfig,
            counts: torch.Tensor) -> torch.Tensor:
    """One expert layer's output for the ln2-normed input ``h`` [B, T,
    hidden] (the residual is the caller's). ``counts``: int64 [E] zeros,
    left holding the pairs each expert took."""
    lead, hidden = h.shape[:-1], h.shape[-1]
    k = cfg.moe.top_k
    x = h.reshape(-1, hidden)
    idx, weights = route(x, layer["router"], cfg)
    flat = idx.flatten()
    order = torch.argsort(flat, stable=True)  # pairs grouped by expert
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    xs = x.index_select(0, torch.div(order, k, rounding_mode="floor"))
    run = experts_grouped if xs.is_cuda else experts_plain
    ys = run(xs, counts, layer["experts_gu"], layer["experts_down"])
    pairs = torch.empty_like(ys).index_copy_(0, order, ys).view(-1, k, hidden)
    routed = (pairs.float() * weights[..., None]).sum(dim=1).to(h.dtype)
    shared = _swiglu(x @ layer["shared_gu"]) @ layer["shared_down"]
    return (routed + shared).view(*lead, hidden)
