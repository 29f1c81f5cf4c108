"""Rerank backends.

Port of ``outline_rag_tpu/engine/rerank.py``. Interface:
``rerank(query, passages, top_n) -> list[(orig_index, score)]`` sorted by
score descending. The JAX package's cross-encoder returned ``[]`` on any
error; here an error propagates to the caller. The cross-encoder owns its
module: the QKV-fusion policy and, with ``int8=True`` (``ENCODER_INT8``),
the w8a8 trunk rewrite its trunk in place; the classifier head stays f32.
"""

from __future__ import annotations

import numpy as np
import torch

from outline_rag_tpu_torch.models.encoder import maybe_fuse_qkv_, quantize_encoder_
from outline_rag_tpu_torch.models.reranker import Reranker


class NoopReranker:
    """Keeps retrieval order; used when no reranker weights are available.
    Scores passed through are the caller's retrieval scores."""

    def rerank(
        self, query: str, passages: list[str], top_n: int
    ) -> list[tuple[int, float]]:
        return [(i, float(len(passages) - i)) for i in range(min(top_n, len(passages)))]


class CrossEncoderReranker:
    def __init__(
        self,
        reranker: Reranker,
        tokenizer,
        max_tokens: int = 512,
        pair_buckets=(64, 128, 256, 512),
        int8: bool = False,
    ):
        maybe_fuse_qkv_(reranker.encoder)
        if int8:
            quantize_encoder_(reranker.encoder)
        self.model = reranker.eval()
        self.device = reranker.encoder.word.device
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens
        self.pair_buckets = pair_buckets

    @torch.inference_mode()
    def rerank(
        self, query: str, passages: list[str], top_n: int
    ) -> list[tuple[int, float]]:
        if not passages:
            return []
        tb = self.tokenizer.batch_pairs(
            [query] * len(passages), passages, self.max_tokens, self.pair_buckets
        )
        scores = self.model(
            torch.as_tensor(tb.input_ids, device=self.device),
            torch.as_tensor(tb.attention_mask, device=self.device),
        ).cpu().numpy()
        order = np.argsort(-scores, kind="stable")[:top_n]
        return [(int(i), float(scores[i])) for i in order]
