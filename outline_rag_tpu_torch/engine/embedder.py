"""Encoder embedder.

Port of ``outline_rag_tpu/engine/embedder.py``: ``embed(texts) ->
np.ndarray [n, dim]`` through the XLM-R encoder with CLS pooling.
Sequences are padded to the tokenizer's bucket ladder, and a batch is
split by a token budget so long buckets run at small batch. With
``max_tokens`` past the ladder's top (bge-m3 reads 8,192 tokens), the
embedder is in whole-document mode: the ladder runs up to ``max_tokens``
(``buckets_for``), one document becomes one vector, and attention at
those widths goes through the flash kernel (``EncoderConfig.attn_impl``).
The JAX package also padded the batch dimension to a ladder, to bound
recompiles; eager PyTorch has none, so batches run at their real size.
"""

from __future__ import annotations

import numpy as np
import torch

from outline_rag_tpu_torch.models.encoder import Encoder, pooled_embeddings
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
    ):
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

    @torch.inference_mode()
    def embed(self, texts: list[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        tb = self.tokenizer.batch(texts, self.max_tokens, self.seq_buckets)
        ids = torch.as_tensor(tb.input_ids, device=self.device)
        mask = torch.as_tensor(tb.attention_mask, device=self.device)
        step = max(1, MAX_BATCH_TOKENS // ids.shape[1])
        outs = [
            pooled_embeddings(self.encoder, ids[s : s + step], mask[s : s + step])
            for s in range(0, ids.shape[0], step)
        ]
        return torch.cat(outs).cpu().numpy()
