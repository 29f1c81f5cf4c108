"""XLM-RoBERTa-family encoder (the BGE-m3 architecture) as an nn.Module.

Port of ``outline_rag_tpu/models/encoder.py`` with its numerics:

- weights in the compute dtype, except the layernorm parameters, which
  stay f32 (the JAX package's cast rule), so the embedding sum runs in the
  compute dtype;
- layernorm statistics in f32, cast back;
- RoBERTa position ids ``cumsum(mask) * mask + pad_id``;
- additive key bias ``(1 - mask) * -1e9``;
- attention logits and softmax in f32, probabilities cast to the compute
  dtype before P.V;
- exact-erf GELU.

Attention has two routes, chosen per call by ``EncoderConfig.attn_impl``
(:func:`use_flash`): plain einsum tensor code, which materialises the
``[B, H, S, S]`` logits (the query and pair widths, 64 and 128), and
``ops/attention.py::flash_attention``, the streaming kernel that
whole-document ingest needs at S >= 2048.

Two rewrites of a loaded trunk, both in place and both the JAX package's
(``fuse_encoder_params``, ``quantize_encoder_params``): :func:`fuse_qkv_`
makes each layer's three attention projections one ``[H, 3H]`` projection
(chosen by ``ORT_ENCODER_FUSE``, :func:`maybe_fuse_qkv_`; unfused by
default), and :func:`quantize_encoder_` turns the six trunk projections of
every layer into :class:`Int8Linear` (w8a8: int8 codes per output channel,
activations quantized per row at every call; ``ENCODER_INT8``). Embeddings,
layernorms, biases and every head keep their dtypes.

BGE-m3's two other heads are optional submodules: ``sparse`` (Linear(H, 1)
+ ReLU: per-token lexical weights) and ``colbert`` (Linear(H, Hc):
per-token late-interaction vectors), with the functions that score them
(``lexical_overlap_scores``, ``late_interaction_scores``) and the int8
codes of the index's ColBERT cache (``colbert_cache_codes``). Their score
paths are f32 matmuls, which stay true fp32 while TF32 is off
(``torch.backends.cuda.matmul.allow_tf32``, the PyTorch default).
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from outline_rag_tpu_torch.device import resolve_device
from outline_rag_tpu_torch.ops.attention import flash_attention
from outline_rag_tpu_torch.ops.int8_linear import w8a8_matmul

ATTN_IMPLS = ("auto", "flash", "einsum")


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 250_002
    hidden: int = 1024
    layers: int = 24
    heads: int = 16
    intermediate: int = 4096
    max_positions: int = 8194  # bge-m3 long-context variant
    pad_id: int = 1
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16  # weight / activation compute dtype
    # "einsum" = plain attention (materialises [B, H, S, S]; fine to ~512),
    # "flash" = ops/attention.py::flash_attention (O(S*D) memory),
    # "auto" = flash where use_flash() says so, einsum otherwise.
    attn_impl: str = "auto"

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r}: use one of {ATTN_IMPLS}")

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @classmethod
    def bge_m3(cls, dtype: torch.dtype = torch.bfloat16, attn_impl: str = "auto") -> "EncoderConfig":
        return cls(dtype=dtype, attn_impl=attn_impl)

    @classmethod
    def tiny(cls, dtype: torch.dtype = torch.float32, attn_impl: str = "auto") -> "EncoderConfig":
        """Small config for tests / CPU parity checks."""
        return cls(
            vocab_size=1024,
            hidden=64,
            layers=2,
            heads=4,
            intermediate=128,
            max_positions=130,
            dtype=dtype,
            attn_impl=attn_impl,
        )


def use_flash(cfg: EncoderConfig, batch: int, seq_len: int, device: torch.device) -> bool:
    """Whether attention runs through the flash kernel. ``"flash"`` and
    ``"einsum"`` force a route. ``"auto"`` takes flash on a CUDA device
    once S >= 2048 or the f32 logits would pass 4 GiB (where plain
    attention stops fitting: at S = 8192 and batch 8 they are 34 GB a
    layer), in either compute dtype; einsum otherwise, the CPU included
    (as the JAX package's auto is einsum off the TPU)."""
    if cfg.attn_impl != "auto":
        return cfg.attn_impl == "flash"
    logits_bytes = batch * cfg.heads * seq_len * seq_len * 4
    return device.type == "cuda" and (seq_len >= 2048 or logits_bytes > (4 << 30))


class LayerNorm(nn.Module):
    """LayerNorm with f32 parameters and statistics, output in the input
    dtype."""

    def __init__(self, width: int, eps: float, device: torch.device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(width, dtype=torch.float32, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mu).square().mean(dim=-1, keepdim=True)
        out = (x32 - mu) * torch.rsqrt(var + self.eps)
        return (out * self.weight + self.bias).to(x.dtype)


def zero_linear(n_in: int, n_out: int, cfg: EncoderConfig, device) -> nn.Linear:
    """``nn.Linear`` in the compute dtype, zero-filled until loaded."""
    lin = nn.Linear(n_in, n_out, device=device, dtype=cfg.dtype)
    with torch.no_grad():
        lin.weight.zero_()
        lin.bias.zero_()
    return lin


class Int8Linear(nn.Module):
    """A w8a8 projection: ``codes [N, K]`` int8 and ``scales [N]`` f32 per
    output channel, the bias in the compute dtype. The forward is the JAX
    package's ``_emm`` then the bias: each row of ``x`` quantized to int8,
    the exact integer product, the f32 rescale (``ops/int8_linear.py::
    w8a8_matmul``), rounded to ``x.dtype`` before the bias is added."""

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.out_features, self.in_features = codes.shape
        self.register_buffer("codes", codes)
        self.register_buffer("scales", scales)
        self.bias = nn.Parameter(bias, requires_grad=False)

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "Int8Linear":
        """The codes of ``lin``'s weight as it is held (already in the
        compute dtype): per output channel, ``scale = amax * f32(1/127)``
        (the JAX package quantizes the trunk under ``jit``, and XLA compiles
        ``amax / 127`` as that product; ``ops/int8_linear.py::
        quantize_linear_weight`` divides, as JAX does eagerly), floored at
        1e-12, ``codes = round(w / scale)`` clipped to +-127."""
        w = lin.weight.detach().float()
        scales = (w.abs().amax(dim=1) * (1.0 / 127.0)).clamp_min(1e-12)
        codes = torch.round(w / scales[:, None]).clamp(-127, 127).to(torch.int8)
        return cls(codes.contiguous(), scales.contiguous(), lin.bias.detach())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        out = w8a8_matmul(x.reshape(-1, self.in_features), self.codes, self.scales)
        return out.reshape(*lead, self.out_features).to(x.dtype) + self.bias.to(x.dtype)


class EncoderLayer(nn.Module):
    """Post-layernorm transformer block: attention, then the GELU MLP. The
    attention projections are ``q``, ``k``, ``v``, or one ``qkv`` once
    fused (:func:`fuse_qkv_`)."""

    def __init__(self, cfg: EncoderConfig, device: torch.device):
        super().__init__()
        h = cfg.hidden
        self.cfg = cfg
        self.q = zero_linear(h, h, cfg, device)
        self.k = zero_linear(h, h, cfg, device)
        self.v = zero_linear(h, h, cfg, device)
        self.qkv = None
        self.o = zero_linear(h, h, cfg, device)
        self.attn_ln = LayerNorm(h, cfg.layer_norm_eps, device)
        self.mlp_in = zero_linear(h, cfg.intermediate, cfg, device)
        self.mlp_out = zero_linear(cfg.intermediate, h, cfg, device)
        self.mlp_ln = LayerNorm(h, cfg.layer_norm_eps, device)

    def attention(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape
        nh, hd = self.cfg.heads, self.cfg.head_dim
        if self.qkv is not None:
            q, k, v = self.qkv(x).split(h, dim=-1)
        else:
            q, k, v = self.q(x), self.k(x), self.v(x)
        q, k, v = (t.reshape(b, s, nh, hd) for t in (q, k, v))
        if use_flash(self.cfg, b, s, x.device):
            q, k, v = (t.contiguous() for t in (q, k, v))  # slices of a fused projection
            ctx = flash_attention(q, k, v, mask_bias[:, 0, 0, :]).reshape(b, s, h)
        else:
            logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
            logits = logits / math.sqrt(hd) + mask_bias  # [B,1,1,S] broadcast
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            ctx = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, s, h)
        return self.o(ctx)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        x = self.attn_ln(x + self.attention(x, mask_bias))
        hmid = F.gelu(self.mlp_in(x), approximate="none")
        return self.mlp_ln(x + self.mlp_out(hmid))


class Encoder(nn.Module):
    """Returns the final hidden states [B, S, H] in ``cfg.dtype``. Built
    with zero weights: fill them with ``models.convert.init_encoder``
    (seeded) or ``models.convert.encoder_from_jax``. ``sparse`` and
    ``colbert_dim`` add BGE-m3's sparse and ColBERT heads (``self.sparse``
    and ``self.colbert``, None without them), which ``forward`` does not
    run: the functions below read them from the hidden states."""

    def __init__(
        self,
        cfg: EncoderConfig,
        device: str | torch.device,
        *,
        sparse: bool = False,
        colbert_dim: int = 0,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.word = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.hidden, dtype=cfg.dtype, device=dev))
        self.position = nn.Parameter(
            torch.zeros(cfg.max_positions, cfg.hidden, dtype=cfg.dtype, device=dev)
        )
        self.token_type = nn.Parameter(torch.zeros(1, cfg.hidden, dtype=cfg.dtype, device=dev))
        self.embed_ln = LayerNorm(cfg.hidden, cfg.layer_norm_eps, dev)
        self.layers = nn.ModuleList(EncoderLayer(cfg, dev) for _ in range(cfg.layers))
        self.sparse = zero_linear(cfg.hidden, 1, cfg, dev) if sparse else None
        self.colbert = zero_linear(cfg.hidden, colbert_dim, cfg, dev) if colbert_dim else None

    def forward(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, remat: bool = False
    ) -> torch.Tensor:
        """``remat=True`` recomputes each layer in the backward pass instead
        of keeping its activations (the JAX package's ``jax.checkpoint`` per
        layer): the same forward, less memory, one more forward of FLOPs."""
        mask = attention_mask.long()
        # RoBERTa position ids: cumulative count of non-pad tokens + pad_id
        positions = torch.cumsum(mask, dim=1) * mask + self.cfg.pad_id
        emb = self.word[input_ids.long()] + self.position[positions] + self.token_type[0]
        x = self.embed_ln(emb)
        # additive attention bias: 0 for real tokens, -1e9 for padding
        mask_bias = ((1.0 - mask.float()) * -1e9)[:, None, None, :]
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, mask_bias, use_reentrant=False)
            else:
                x = layer(x, mask_bias)
        return x


def fuse_qkv_(encoder: Encoder) -> Encoder:
    """Fuse each layer's q, k and v into one ``qkv`` projection of ``3H``
    outputs, in place (a layer already fused is left as it is). Output
    channels are concatenated, so per-channel int8 codes of the fused weight
    are those of the three, byte for byte; fuse before
    :func:`quantize_encoder_`. Returns the encoder."""
    for layer in encoder.layers:
        if layer.qkv is not None:
            continue
        parts = (layer.q, layer.k, layer.v)
        if not all(isinstance(p, nn.Linear) for p in parts):
            raise ValueError("fuse before quantizing: the projections are no longer nn.Linear")
        w = parts[0].weight
        fused = nn.Linear(w.shape[1], 3 * w.shape[0], device=w.device, dtype=w.dtype)
        with torch.no_grad():
            fused.weight.copy_(torch.cat([p.weight for p in parts]))
            fused.bias.copy_(torch.cat([p.bias for p in parts]))
        layer.qkv = fused
        layer.q = layer.k = layer.v = None
    return encoder


def maybe_fuse_qkv_(encoder: Encoder) -> Encoder:
    """The serving path's QKV-fusion policy, the JAX package's
    ``maybe_fuse_encoder_params``: fused only with ``ORT_ENCODER_FUSE=1``
    (the JAX package's default is unfused, chosen by its own A/B; the
    card's A/B at the query, rerank and ingest shapes is in PERF.md)."""
    if os.environ.get("ORT_ENCODER_FUSE", "0") == "1":
        return fuse_qkv_(encoder)
    return encoder


TRUNK_PROJECTIONS = ("q", "k", "v", "qkv", "o", "mlp_in", "mlp_out")


def quantize_encoder_(encoder: Encoder) -> Encoder:
    """The w8a8 trunk (``ENCODER_INT8``), in place: every layer's q, k, v
    (or fused qkv), attention out, intermediate and output projections
    become :class:`Int8Linear`; embeddings, layernorms and the heads stay as
    they are. Apply after the cast and the fusion. Returns the encoder."""
    for layer in encoder.layers:
        for name in TRUNK_PROJECTIONS:
            lin = getattr(layer, name)
            if isinstance(lin, nn.Linear):
                setattr(layer, name, Int8Linear.from_linear(lin))
    return encoder


def cls_pooled(hidden: torch.Tensor) -> torch.Tensor:
    """BGE-m3 dense embedding of hidden states [B, S, H]: the CLS position,
    L2-normalized, f32 [B, H]."""
    cls = hidden[:, 0, :].float()
    return cls / torch.linalg.vector_norm(cls, dim=-1, keepdim=True).clamp_min(1e-9)


def pooled_embeddings(
    encoder: Encoder,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    remat: bool = False,
) -> torch.Tensor:
    """BGE-m3 dense embedding: CLS hidden state, L2-normalized, f32 [B, H]."""
    return cls_pooled(encoder(input_ids, attention_mask, remat=remat))


def _head(lin: nn.Linear, hidden: torch.Tensor) -> torch.Tensor:
    """``hidden @ w + b`` rounded to the hidden dtype after the product and
    again after the bias, as the JAX package computes its heads."""
    return hidden @ lin.weight.T.to(hidden.dtype) + lin.bias.to(hidden.dtype)


def sparse_weights_from_hidden(
    encoder: Encoder,
    hidden: torch.Tensor,  # [B, S, H]
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    min_token_id: int = 3,
) -> torch.Tensor:
    """BGE-m3 lexical weights [B, S] f32: relu(w . h_t + b), with padding
    and the specials below ``min_token_id`` (CLS / PAD / EOS in the XLM-R
    layout) zeroed."""
    raw = torch.relu(_head(encoder.sparse, hidden)[..., 0]).float()
    keep = (attention_mask > 0) & (input_ids >= min_token_id)
    return torch.where(keep, raw, torch.zeros_like(raw))


def sparse_token_weights(
    encoder: Encoder, input_ids: torch.Tensor, attention_mask: torch.Tensor, min_token_id: int = 3
) -> torch.Tensor:
    hidden = encoder(input_ids, attention_mask)
    return sparse_weights_from_hidden(encoder, hidden, input_ids, attention_mask, min_token_id)


def colbert_vectors_from_hidden(
    encoder: Encoder,
    hidden: torch.Tensor,  # [B, S, H]
    attention_mask: torch.Tensor,  # [B, S]
) -> torch.Tensor:
    """Per-token late-interaction vectors [B, S, Hc] f32, L2-normalized,
    with the CLS position and padding zeroed (FlagEmbedding's BGEM3: a
    MaxSim over them floors at 0)."""
    vecs = _head(encoder.colbert, hidden).float()
    vecs = vecs / torch.linalg.vector_norm(vecs, dim=-1, keepdim=True).clamp_min(1e-9)
    keep = (attention_mask > 0).float()
    keep[:, 0] = 0.0
    return vecs * keep[:, :, None]


def colbert_token_vectors(
    encoder: Encoder, input_ids: torch.Tensor, attention_mask: torch.Tensor
) -> torch.Tensor:
    hidden = encoder(input_ids, attention_mask)
    return colbert_vectors_from_hidden(encoder, hidden, attention_mask)


def late_interaction_scores(
    q_vecs: torch.Tensor,  # [B, Tq, Hc] f32 (zeroed at CLS / padding)
    q_mask: torch.Tensor,  # [B, Tq]
    c_vecs: torch.Tensor,  # [B, K, Tc, Hc] f32 (zeroed at CLS / padding)
) -> torch.Tensor:
    """ColBERT MaxSim [B, K] f32: the mean over the real query tokens (CLS
    left out) of each one's best dot product with a candidate token."""
    sim = torch.einsum("bqh,bkth->bkqt", q_vecs.float(), c_vecs.float())
    best = sim.amax(dim=-1)  # [B, K, Tq]; zero vectors floor at 0
    q_valid = (q_mask > 0).float()
    q_valid[:, 0] = 0.0
    denom = q_valid.sum(dim=1, keepdim=True).clamp_min(1.0)  # [B, 1]
    return (best * q_valid[:, None, :]).sum(dim=-1) / denom


COLBERT_SEED = 0x0C01BE47


def colbert_projection(dim: int, rank: int) -> torch.Tensor:
    """The [dim, rank] f32 projection of the cached-ColBERT codes, on the
    CPU: orthonormal columns (QR of a Gaussian drawn from a generator
    seeded ``COLBERT_SEED``, R's diagonal made positive) scaled by
    sqrt(dim / rank), so projected dot products estimate the full ones.
    The construction is the JAX package's, but ``jax.random``'s bits
    cannot be reproduced: the matrices differ, which is why an index pins
    its matrix and a snapshot carries it."""
    g = torch.randn((dim, rank), generator=torch.Generator().manual_seed(COLBERT_SEED))
    q, r = torch.linalg.qr(g)
    q = q * torch.where(torch.diagonal(r) < 0, -1.0, 1.0)[None, :]
    return q * torch.sqrt(torch.tensor(dim, dtype=torch.float32) / rank)


def colbert_quantize(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Projected vectors [..., r] f32 -> (int8 codes, f32 scales [...]):
    per-vector absmax, ``scale = amax * f32(1/127)`` (the compiled JAX
    code's product with the reciprocal), zero vectors to scale 0."""
    scale = p.abs().amax(dim=-1) * (1.0 / 127.0)
    codes = torch.where(
        scale[..., None] > 0.0,
        torch.round(p / scale.clamp_min(1e-12)[..., None]),
        torch.zeros_like(p),
    )
    return codes.clamp(-127, 127).to(torch.int8), scale


def colbert_cache_codes(
    encoder: Encoder,
    input_ids: torch.Tensor,  # [B, S]
    attention_mask: torch.Tensor,  # [B, S]
    proj: torch.Tensor,  # [Hc, rank] f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Projected and int8-quantized per-token ColBERT vectors for the
    index's token cache: (codes [B, S, rank] int8, scales [B, S] f32).
    The zeroed CLS and padding positions get scale 0."""
    vecs = colbert_token_vectors(encoder, input_ids, attention_mask)
    return colbert_quantize(vecs @ proj.to(vecs.device, torch.float32))


def lexical_overlap_scores(
    q_ids: torch.Tensor,  # [B, Tq]
    q_weights: torch.Tensor,  # [B, Tq] f32
    cand_ids: torch.Tensor,  # [B, K, Tc]
    cand_weights: torch.Tensor,  # [B, K, Tc] f32
) -> torch.Tensor:
    """BGE-m3 lexical matching [B, K] f32: for each query token found in
    the candidate, its weight times the largest weight of the matching
    candidate tokens (a token repeated in the candidate counts once)."""
    eq = q_ids[:, None, :, None] == cand_ids[:, :, None, :]  # [B, K, Tq, Tc]
    best = (cand_weights[:, :, None, :] * eq.float()).amax(dim=-1)  # [B, K, Tq]
    return (best * q_weights[:, None, :]).sum(dim=-1)
