"""Fine-tuning of the three models on one device, and of the dual encoder
data-parallel over processes.

Port of ``outline_rag_tpu/models/train.py``: in-batch-negatives InfoNCE for
the dual encoder (the BGE-family recipe), group cross-entropy for the
cross-encoder (the bge-reranker recipe) and next-token cross-entropy for the
local decoder, each a step ``(state, batch) -> (state, {"loss": loss})``
that updates the parameters with AdamW.

The JAX package's steps are pure functions of a parameter pytree; here the
parameters are an :class:`~outline_rag_tpu_torch.models.encoder.Encoder` /
:class:`~outline_rag_tpu_torch.models.reranker.Reranker` module or the
decoder's parameter dictionary, and a step updates them and the optimizer's
moments in place and returns the same :class:`TrainState`, its ``step`` one
higher. Leaves are named as ``nn.Module.named_parameters`` names them
(``"layers.3.q.weight"``) or by their path in the dictionary
(``"layers.3.wq"``); the optimizer's moments and the checkpoints are keyed
by those names.

:func:`make_optimizer` is optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8,
decoupled weight decay) written in torch ops in optax's order. A leaf decays
iff it is a matrix (``ndim >= 2``): the embeddings, every projection and the
classifier's matrices; biases and norm scales never do. That is the JAX
package's name-and-rank mask on its per-layer parameter list. On its
stacked decoder tree the JAX mask also decays the RMSNorm scales ``ln1`` and
``ln2`` (``[L, H]``, no ``ln_`` or ``b`` prefix); the port does not.

:func:`make_dp_train_step` is the contrastive step data-parallel over the
processes of ``torch.distributed``: each process encodes its slice of the
global batch and the loss is the single-device step's over the whole batch
(see its docstring).

Attention through the flash kernel has no backward (``ops/attention.py``),
so a model trained here runs its attention as einsum: ``"auto"`` takes it
below 2,048 tokens. Training runs in the model's dtype; f32 stays true f32
while TF32 is off (the PyTorch default).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from outline_rag_tpu_torch.models.decoder import decoder_forward, init_cache
from outline_rag_tpu_torch.models.encoder import EncoderConfig, pooled_embeddings

Params = Any  # an nn.Module or the decoder's parameter dictionary


def named_params(params: Params) -> dict[str, torch.Tensor]:
    """The leaves that train, by name: a module's parameters that require
    grad, or every leaf of a decoder parameter dictionary (which
    :func:`init_train_state` makes require grad). A quantized leaf cannot
    train: it raises ``ValueError``."""
    if isinstance(params, nn.Module):
        return {n: p for n, p in params.named_parameters() if p.requires_grad}
    out = {}

    def walk(prefix: str, x) -> None:
        if isinstance(x, Mapping):
            if "q" in x or "q4" in x:
                raise ValueError(f"{prefix}: a quantized weight cannot train")
            for k, v in x.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{prefix}.{i}", v)
        else:
            out[prefix] = x

    walk("", params)
    return out


def decays(p: torch.Tensor) -> bool:
    """The weight-decay mask: matrices decay, vectors (biases, norm scales)
    do not."""
    return p.ndim >= 2


@dataclasses.dataclass
class AdamWState:
    """optax's ``ScaleByAdamState``: the update count and the first and
    second moments of every leaf, by name."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``adamw(lr, b1, b2, eps, weight_decay=wd, mask=...)`` with the
    mask of :func:`decays`."""

    lr: float
    weight_decay: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Params) -> AdamWState:
        leaves = named_params(params)
        return AdamWState(
            count=0,
            mu={n: torch.zeros_like(p) for n, p in leaves.items()},
            nu={n: torch.zeros_like(p) for n, p in leaves.items()},
        )

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: AdamWState, params: Params) -> None:
        """One update of ``params`` and ``state`` in place, in optax's order:
        the moments ``(1 - b) * g + b * m``, their bias corrections, ``mu_hat
        / (sqrt(nu_hat) + eps)``, ``+ wd * p`` where the leaf decays, times
        ``-lr``, added to the leaf."""
        state.count += 1
        bc1 = 1.0 - self.b1**state.count
        bc2 = 1.0 - self.b2**state.count
        for name, p in named_params(params).items():
            g, mu, nu = grads[name], state.mu[name], state.nu[name]
            mu.mul_(self.b1).add_(g * (1.0 - self.b1))
            nu.mul_(self.b2).add_(g.square() * (1.0 - self.b2))
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            if decays(p):
                u.add_(p * self.weight_decay)
            p.add_(u.mul_(-self.lr))


def make_optimizer(lr: float = 1e-5, weight_decay: float = 0.01) -> AdamW:
    """AdamW with the BERT-family decay mask: norm scales and every bias are
    excluded from weight decay; matrices (embeddings, attention / MLP
    weights, the classifier) decay."""
    return AdamW(lr=lr, weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: AdamWState
    step: int


def init_train_state(params: Params, optimizer: AdamW) -> TrainState:
    """The state a step starts from. A decoder parameter dictionary's leaves
    are made to require grad here (a module's parameters already do)."""
    if not isinstance(params, nn.Module):
        for p in named_params(params).values():
            p.requires_grad_(True)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def value_and_grad(
    loss_fn: Callable[[Params], torch.Tensor], params: Params
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``jax.value_and_grad`` for the port's parameters: the loss (detached)
    and the gradient of every leaf that trains, by name; a leaf the loss does
    not reach gets zeros, as JAX gives it."""
    leaves = named_params(params)
    with torch.enable_grad():
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {
        n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(leaves.items(), grads)
    }


def save_train_state(path: str, state: TrainState) -> None:
    """One file, ``torch.save`` of the leaves, the optimizer's count and
    moments, and the step."""
    torch.save(
        {
            "params": {n: p.detach() for n, p in named_params(state.params).items()},
            "count": state.opt_state.count,
            "mu": state.opt_state.mu,
            "nu": state.opt_state.nu,
            "step": state.step,
        },
        path,
    )


def load_train_state(path: str, template: TrainState) -> TrainState:
    """Read a :func:`save_train_state` file (``weights_only``) into
    ``template``'s tensors, in place, and return it. The leaves' names and
    shapes must be the template's."""
    leaves = named_params(template.params)
    device = next(iter(leaves.values())).device
    blob = torch.load(path, map_location=device, weights_only=True)
    for key in ("params", "mu", "nu"):
        if blob[key].keys() != leaves.keys():
            raise ValueError(f"{path}: {key} has other leaves than the template")
    with torch.no_grad():
        for n, p in leaves.items():
            p.copy_(blob["params"][n])
            template.opt_state.mu[n].copy_(blob["mu"][n])
            template.opt_state.nu[n].copy_(blob["nu"][n])
    template.opt_state.count = int(blob["count"])
    template.step = int(blob["step"])
    return template


def contrastive_loss(
    encoder: nn.Module,
    q_ids: torch.Tensor,
    q_mask: torch.Tensor,
    p_ids: torch.Tensor,
    p_mask: torch.Tensor,
    temperature: float = 0.05,
    remat: bool = False,
) -> torch.Tensor:
    """Symmetric InfoNCE with in-batch negatives: query i's positive is
    passage i; all other passages in the batch are negatives. ``remat``
    recomputes each encoder layer in the backward pass."""
    q_emb = pooled_embeddings(encoder, q_ids, q_mask, remat=remat)  # [B, H] f32
    p_emb = pooled_embeddings(encoder, p_ids, p_mask, remat=remat)
    return info_nce(q_emb, p_emb, temperature)


def info_nce(q_emb: torch.Tensor, p_emb: torch.Tensor, temperature: float) -> torch.Tensor:
    """Symmetric InfoNCE of paired [B, H] embeddings, row i's positive the
    other side's row i."""
    logits = (q_emb @ p_emb.T) / temperature  # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss_qp = F.cross_entropy(logits, labels, reduction="none")
    loss_pq = F.cross_entropy(logits.T, labels, reduction="none")
    return (loss_qp + loss_pq).mean() * 0.5


def reranker_loss(
    reranker: nn.Module,
    pair_ids: torch.Tensor,  # [B*group, T] pair sequences, positives first
    pair_mask: torch.Tensor,  # [B*group, T]
    group: int,
    remat: bool = False,
) -> torch.Tensor:
    """Cross-encoder fine-tuning: each query contributes ``group`` pairs, its
    positive chunk at slot 0 followed by group-1 hard negatives, and the loss
    is cross-entropy over the group's relevance scores."""
    logits = reranker(pair_ids, pair_mask, remat=remat).reshape(-1, group)
    labels = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
    return F.cross_entropy(logits, labels)


def lm_loss(
    params: dict,
    tokens: torch.Tensor,  # [B, S] integers
    mask: torch.Tensor,  # [B, S], 1 for real tokens
    cfg,  # DecoderConfig
) -> torch.Tensor:
    """Next-token cross-entropy for the local decoder: the prefill forward
    from position 0 on a fresh KV ring, each position scored on the next
    real token; padded positions are left out of the mean."""
    b, s = tokens.shape
    if s > cfg.max_cache:
        raise ValueError(f"{s} tokens for a {cfg.max_cache}-slot cache")
    cache = init_cache(cfg, b, tokens.device)
    start = torch.zeros((b,), dtype=torch.int32, device=tokens.device)
    logits, _ = decoder_forward(params, tokens, cache, start, cfg)
    losses = F.cross_entropy(
        logits[:, :-1].reshape(b * (s - 1), -1), tokens[:, 1:].reshape(-1).long(), reduction="none"
    ).reshape(b, s - 1)
    m = mask[:, 1:].float()
    return (losses * m).sum() / m.sum().clamp_min(1.0)


def _step(optimizer: AdamW, loss_of: Callable[[Params, dict], torch.Tensor]):
    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        loss, grads = value_and_grad(lambda p: loss_of(p, batch), state.params)
        optimizer.update(grads, state.opt_state, state.params)
        state.step += 1
        return state, {"loss": loss}

    return step


def _check_config(model: nn.Module, cfg: EncoderConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the state's model has config {model.cfg}, the step {cfg}")


def make_train_step(
    cfg: EncoderConfig, optimizer: AdamW, temperature: float = 0.05, remat: bool = False
):
    """(state, batch) -> (state, metrics) for the dual encoder. ``batch`` =
    dict(q_ids, q_mask, p_ids, p_mask)."""

    def loss_of(encoder, batch):
        _check_config(encoder, cfg)
        return contrastive_loss(
            encoder, batch["q_ids"], batch["q_mask"], batch["p_ids"], batch["p_mask"],
            temperature, remat=remat,
        )

    return _step(optimizer, loss_of)


def make_reranker_train_step(cfg: EncoderConfig, optimizer: AdamW, group: int, remat: bool = False):
    """(state, batch) -> (state, metrics) for the cross-encoder. ``batch`` =
    dict(pair_ids, pair_mask) with ``group`` pairs per query."""

    def loss_of(reranker, batch):
        _check_config(reranker, cfg)
        return reranker_loss(reranker, batch["pair_ids"], batch["pair_mask"], group, remat=remat)

    return _step(optimizer, loss_of)


def make_lm_train_step(cfg, optimizer: AdamW):
    """(state, batch) -> (state, metrics) causal-LM step for the local
    decoder. ``batch`` = dict(tokens [B, S], mask [B, S])."""
    return _step(optimizer, lambda params, batch: lm_loss(params, batch["tokens"], batch["mask"], cfg))


class _GatherRows(torch.autograd.Function):
    """All-gather of every process's rows in process order, differentiable:
    the backward hands each process the gradient of its own rows only.
    Every process computes the same loss from the gathered rows, so the
    gradients of its rows are the whole loss's; the parameter gradients are
    then summed over the processes, which counts the one loss once."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        from outline_rag_tpu_torch.parallel.multihost import all_gather_tensor  # noqa: PLC0415

        ctx.rows, ctx.rank = x.shape[0], torch.distributed.get_rank()
        return torch.cat(all_gather_tensor(x), dim=0)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]


def _sum_over_processes_(grads: dict[str, torch.Tensor], bucket: int = 1 << 26) -> None:
    """Each gradient summed over the processes, in place: flattened into
    buckets of up to ``bucket`` elements, one all-reduce a bucket."""
    from outline_rag_tpu_torch.parallel.multihost import all_reduce_sum_  # noqa: PLC0415

    names = list(grads)
    while names:
        take, size = [], 0
        while names and (not take or size + grads[names[0]].numel() <= bucket):
            take.append(names.pop(0))
            size += grads[take[-1]].numel()
        flat = all_reduce_sum_(torch.cat([grads[n].reshape(-1) for n in take]))
        for n, part in zip(take, torch.split(flat, [grads[n].numel() for n in take])):
            grads[n] = part.view_as(grads[n])


def make_dp_train_step(
    cfg: EncoderConfig, optimizer: AdamW, temperature: float = 0.05, remat: bool = False
):
    """(state, local batch) -> (state, metrics): the dual-encoder step
    data-parallel over the processes of ``torch.distributed`` (initialized
    by the caller, e.g. ``parallel/multihost.py::init_multihost``). Each
    process holds the same parameters and its equal slice of the global
    batch, in process order.

    The step computes the single-device step's function on the global
    batch. Its in-batch negatives span the whole batch: the pooled
    embeddings are all-gathered (differentiably) and every process takes
    the InfoNCE of the gathered ``[B, H]`` pair, so ``loss`` is the global
    batch's. A DDP that averaged each process's local InfoNCE would compute
    another function. The parameter gradients are summed over the processes
    (:class:`_GatherRows` says why that counts the loss once), and every
    process applies the same update."""

    def loss_of(encoder, batch):
        _check_config(encoder, cfg)
        q = _GatherRows.apply(pooled_embeddings(encoder, batch["q_ids"], batch["q_mask"],
                                                remat=remat))
        p = _GatherRows.apply(pooled_embeddings(encoder, batch["p_ids"], batch["p_mask"],
                                                remat=remat))
        return info_nce(q, p, temperature)

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        loss, grads = value_and_grad(lambda p: loss_of(p, batch), state.params)
        _sum_over_processes_(grads)
        optimizer.update(grads, state.opt_state, state.params)
        state.step += 1
        return state, {"loss": loss}

    return step
