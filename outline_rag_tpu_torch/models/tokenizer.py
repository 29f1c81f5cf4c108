"""Host-side tokenization with fixed-shape bucketing.

Port of ``outline_rag_tpu/models/tokenizer.py``: the deterministic
whitespace + hash tokenizer and the bucket ladder, producing the same ids
as the JAX package. The HF tokenizer wrapper is not ported yet.
"""

from __future__ import annotations

import hashlib

import numpy as np

DEFAULT_BUCKETS = (32, 64, 128, 256, 512)
# Whole-document embedding ladder (BGE-m3 supports 8192 tokens).
LONG_BUCKETS = DEFAULT_BUCKETS + (1024, 2048, 4096, 8192)


def buckets_for(max_len: int, buckets=LONG_BUCKETS) -> tuple[int, ...]:
    """The bucket ladder truncated to ``max_len`` (always >= one bucket)."""
    kept = tuple(b for b in buckets if b <= max_len)
    return kept or (buckets[0],)


def pick_bucket(length: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


class TokenBatch:
    __slots__ = ("input_ids", "attention_mask")

    def __init__(self, input_ids: np.ndarray, attention_mask: np.ndarray):
        self.input_ids = input_ids
        self.attention_mask = attention_mask


def _pad_rows(encoded: list[list[int]], width: int, pad_id: int) -> TokenBatch:
    ids = np.full((len(encoded), width), pad_id, np.int32)
    mask = np.zeros((len(encoded), width), np.int32)
    for i, e in enumerate(encoded):
        e = e[:width]
        ids[i, : len(e)] = e
        mask[i, : len(e)] = 1
    return TokenBatch(ids, mask)


class HashTokenizer:
    """Deterministic stand-in tokenizer: whitespace split + stable hash to
    a fixed vocab. CLS=0, PAD=1, EOS=2 (XLM-R special-id layout)."""

    cls_id, pad_id, eos_id = 0, 1, 2

    def __init__(self, vocab_size: int = 1024):
        self.vocab_size = vocab_size

    def _tok(self, word: str) -> int:
        h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "big")
        return 3 + (h % (self.vocab_size - 3))

    def encode(self, text: str, max_len: int) -> list[int]:
        ids = [self.cls_id]
        for w in text.split():
            if len(ids) >= max_len - 1:
                break
            ids.append(self._tok(w))
        ids.append(self.eos_id)
        return ids

    def batch(
        self, texts: list[str], max_len: int = 512, buckets=DEFAULT_BUCKETS
    ) -> TokenBatch:
        encoded = [self.encode(t, max_len) for t in texts]
        longest = max((len(e) for e in encoded), default=1)
        width = min(pick_bucket(longest, buckets), max_len)
        return _pad_rows(encoded, width, self.pad_id)

    def batch_pairs(
        self,
        queries: list[str],
        passages: list[str],
        max_len: int = 512,
        buckets=DEFAULT_BUCKETS,
    ) -> TokenBatch:
        """Cross-encoder pair encoding: CLS q EOS EOS p EOS (XLM-R pair
        layout)."""
        encoded = []
        # each distinct query is encoded once, not once per pair
        q_cache: dict[str, list[int]] = {}
        for q, p in zip(queries, passages):
            qe = q_cache.get(q)
            if qe is None:
                qe = q_cache[q] = self.encode(q, max_len // 2)
            pe = self.encode(p, max_len - len(qe) - 1)[1:]  # drop its CLS
            encoded.append(qe + [self.eos_id] + pe)
        longest = max((len(e) for e in encoded), default=1)
        width = min(pick_bucket(longest, buckets), max_len)
        return _pad_rows(encoded, width, self.pad_id)
