"""Encoder embedder.

Port of ``outline_rag_tpu/engine/embedder.py``: ``embed(texts) ->
np.ndarray [n, dim]`` through the XLM-R encoder with CLS pooling, and for
an encoder with BGE-m3's heads the per-token lexical weights
(``token_weights``) and the ColBERT cache codes (``colbert_cache``) of
tokenized chunks.
Sequences are padded to the tokenizer's bucket ladder, and a batch is
split by a token budget so long buckets run at small batch. With
``max_tokens`` past the ladder's top (bge-m3 reads 8,192 tokens), the
embedder is in whole-document mode: the ladder runs up to ``max_tokens``
(``buckets_for``), one document becomes one vector, and attention at
those widths goes through the flash kernel (``EncoderConfig.attn_impl``).
The JAX package also padded the batch dimension to a ladder, to bound
recompiles; eager PyTorch has none, so batches run at their real size.

The embedder owns its encoder: the QKV-fusion policy (``ORT_ENCODER_FUSE``)
and, with ``int8=True`` (``ENCODER_INT8``), the w8a8 trunk rewrite it in
place, in that order, as the JAX package casts, fuses, then quantizes.
"""

from __future__ import annotations

import numpy as np
import torch

from outline_rag_tpu_torch.models.encoder import (
    Encoder,
    colbert_cache_codes,
    maybe_fuse_qkv_,
    pooled_embeddings,
    quantize_encoder_,
    sparse_token_weights,
)
from outline_rag_tpu_torch.models.tokenizer import DEFAULT_BUCKETS, buckets_for

# token budget per encoder forward: activations (B x S x intermediate)
# stay bounded for the long buckets
MAX_BATCH_TOKENS = 64 * 1024


class EncoderEmbedder:
    def __init__(
        self,
        encoder: Encoder,
        tokenizer,
        max_tokens: int = 512,
        seq_buckets=DEFAULT_BUCKETS,
        int8: bool = False,
    ):
        maybe_fuse_qkv_(encoder)
        if int8:
            quantize_encoder_(encoder)
        self.encoder = encoder.eval()
        self.cfg = encoder.cfg
        self.device = encoder.word.device
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens
        if max_tokens > max(seq_buckets):
            seq_buckets = buckets_for(max_tokens)  # whole-document mode
        self.seq_buckets = seq_buckets

    @property
    def dim(self) -> int:
        return self.cfg.hidden

    def _batched(self, fn, input_ids, attention_mask) -> list:
        """``fn(ids, mask)`` over slices of the batch that keep each
        forward within the token budget."""
        ids = torch.as_tensor(input_ids, device=self.device)
        mask = torch.as_tensor(attention_mask, device=self.device)
        step = max(1, MAX_BATCH_TOKENS // ids.shape[1])
        return [fn(ids[s : s + step], mask[s : s + step]) for s in range(0, ids.shape[0], step)]

    @torch.inference_mode()
    def embed(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        tb = self.tokenizer.batch(texts, self.max_tokens, self.seq_buckets)
        outs = self._batched(
            lambda i, m: pooled_embeddings(self.encoder, i, m), tb.input_ids, tb.attention_mask
        )
        return torch.cat(outs).cpu().numpy()

    @property
    def has_sparse_head(self) -> bool:
        return self.encoder.sparse is not None

    @torch.inference_mode()
    def token_weights(self, input_ids, attention_mask) -> np.ndarray | None:
        """Per-token lexical weights [n, S] f32 of tokenized chunks (the
        sparse head), or None for an encoder without it."""
        if not self.has_sparse_head:
            return None
        outs = self._batched(
            lambda i, m: sparse_token_weights(self.encoder, i, m), input_ids, attention_mask
        )
        return torch.cat(outs).cpu().numpy()

    @property
    def has_colbert_head(self) -> bool:
        return self.encoder.colbert is not None

    @torch.inference_mode()
    def colbert_cache(
        self, input_ids, attention_mask, rank: int, proj: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray] | tuple[None, None]:
        """Projected int8 ColBERT codes [n, S, rank] and scales [n, S] of
        tokenized chunks for the index's cache, or (None, None) for an
        encoder without the head. ``proj`` is the index's pinned matrix
        (``VectorIndex.colbert_projection_for``), so ingest and query
        project alike."""
        if not self.has_colbert_head:
            return None, None
        proj_t = torch.tensor(np.asarray(proj, np.float32), device=self.device)
        if tuple(proj_t.shape) != (self.encoder.colbert.out_features, rank):
            raise ValueError(f"projection {tuple(proj_t.shape)} for rank {rank}")
        outs = self._batched(
            lambda i, m: colbert_cache_codes(self.encoder, i, m, proj_t),
            input_ids, attention_mask,
        )
        return (
            torch.cat([c for c, _ in outs]).cpu().numpy(),
            torch.cat([s for _, s in outs]).cpu().numpy(),
        )


def get_embedder(settings=None, dim: int | None = None, device: str = "cuda"):
    """Factory honouring Settings: the encoder of ``ENCODER_WEIGHTS_PATH``
    on ``device`` (``HFTokenizer``, ``ENCODER_MAX_TOKENS``,
    ``ENCODER_INT8``) when a path is configured, the deterministic hash
    embedder (the offline seam) otherwise. A configured checkpoint that
    fails to load raises ``RuntimeError`` naming the path: serving hash
    vectors in its place would break retrieval without a word."""
    from outline_rag_tpu_torch.models.hash_embedder import HashEmbedder

    if settings is not None and settings.encoder_weights_path:
        path = settings.encoder_weights_path
        try:
            from outline_rag_tpu_torch.models.convert import load_pretrained
            from outline_rag_tpu_torch.models.tokenizer import HFTokenizer

            model = load_pretrained(path, device)
            # a cross-encoder checkpoint embeds with its trunk, as in the JAX package
            encoder = getattr(model, "encoder", model)
            return EncoderEmbedder(
                encoder, HFTokenizer(path), max_tokens=settings.encoder_max_tokens,
                int8=settings.encoder_int8,
            )
        except Exception as exc:
            raise RuntimeError(
                f"ENCODER_WEIGHTS_PATH is set but the checkpoint failed to load from {path!r}"
            ) from exc
    d = dim or (settings.vector_dim if settings else 1024)
    return HashEmbedder(dim=d)
