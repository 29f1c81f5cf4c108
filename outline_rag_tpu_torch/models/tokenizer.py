"""Host-side tokenization with fixed-shape bucketing.

The reference never tokenizes (remote APIs do); its only tokenizer artifact
is a pre-cached-but-unused tiktoken BPE (reference
``app/llm_services.py:111-116``). Here tokenization is a real pipeline
stage: HF fast tokenizer (sentencepiece/XLM-R) on the host producing fixed
padded shapes from a small bucket ladder, so every encoder invocation hits
an already-compiled XLA program (SURVEY.md section 5 "long-context": fixed
padded batches, document-level parallelism).

When no tokenizer asset is available (offline test environments) a
deterministic whitespace+hash tokenizer stands in behind the same
interface — the fake-backend seam of SURVEY.md section 4.
"""

from __future__ import annotations

import hashlib

import numpy as np

DEFAULT_BUCKETS = (32, 64, 128, 256, 512)
# Whole-document embedding ladder (BGE-m3 supports 8192 tokens); the
# encoder switches to the flash-attention kernel at these lengths.
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
        ids = np.full((len(texts), width), self.pad_id, np.int32)
        mask = np.zeros((len(texts), width), np.int32)
        for i, e in enumerate(encoded):
            e = e[:width]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return TokenBatch(ids, mask)

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
        # rerank calls pass the SAME query for every passage: encode each
        # distinct query once, not once per pair (serving hot path)
        q_cache: dict[str, list[int]] = {}
        for q, p in zip(queries, passages):
            qe = q_cache.get(q)
            if qe is None:
                qe = q_cache[q] = self.encode(q, max_len // 2)
            pe = self.encode(p, max_len - len(qe) - 1)[1:]  # drop its CLS
            encoded.append(qe + [self.eos_id] + pe)
        longest = max((len(e) for e in encoded), default=1)
        width = min(pick_bucket(longest, buckets), max_len)
        ids = np.full((len(encoded), width), self.pad_id, np.int32)
        mask = np.zeros((len(encoded), width), np.int32)
        for i, e in enumerate(encoded):
            e = e[:width]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return TokenBatch(ids, mask)


class HFTokenizer:
    """HF fast-tokenizer wrapper producing the same bucketed TokenBatch."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer  # noqa: PLC0415

        self.tok = AutoTokenizer.from_pretrained(path)
        self.pad_id = self.tok.pad_token_id

    def batch(self, texts, max_len: int = 512, buckets=DEFAULT_BUCKETS):
        enc = self.tok(
            list(texts), truncation=True, max_length=max_len, padding=False
        )
        longest = max((len(e) for e in enc["input_ids"]), default=1)
        width = min(pick_bucket(longest, buckets), max_len)
        # HF pad(padding="max_length") never TRUNCATES: when max_len is
        # not itself a bucket value (e.g. ENCODER_MAX_TOKENS=600 over a
        # 512-top ladder) rows longer than the picked width must be cut
        # or return_tensors="np" gets ragged rows and raises
        enc["input_ids"] = [e[:width] for e in enc["input_ids"]]
        enc["attention_mask"] = [m[:width] for m in enc["attention_mask"]]
        out = self.tok.pad(
            enc, padding="max_length", max_length=width, return_tensors="np"
        )
        return TokenBatch(
            out["input_ids"].astype(np.int32),
            out["attention_mask"].astype(np.int32),
        )

    def batch_pairs(self, queries, passages, max_len: int = 512, buckets=DEFAULT_BUCKETS):
        enc = self.tok(
            list(queries),
            list(passages),
            truncation=True,
            max_length=max_len,
            padding=False,
        )
        longest = max((len(e) for e in enc["input_ids"]), default=1)
        width = min(pick_bucket(longest, buckets), max_len)
        enc["input_ids"] = [e[:width] for e in enc["input_ids"]]
        enc["attention_mask"] = [m[:width] for m in enc["attention_mask"]]
        out = self.tok.pad(
            enc, padding="max_length", max_length=width, return_tensors="np"
        )
        return TokenBatch(
            out["input_ids"].astype(np.int32),
            out["attention_mask"].astype(np.int32),
        )
