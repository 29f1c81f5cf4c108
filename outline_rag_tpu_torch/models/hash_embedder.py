"""Deterministic fallback embedder (no weights required).

Role: the offline/test seam for the embedding stage — the analogue of the
deterministic fake embedder SURVEY.md section 4 prescribes for replacing
the remote ``SiliconFlowEmbeddings`` seam (reference
``app/llm_services.py:199``). It hashes word n-grams into a sparse random
projection, giving stable, text-similarity-correlated unit vectors of the
configured dimension. It is NOT a quality embedder; deployments load real
BGE-m3 weights via ``models/convert.py``. Keeping it behind the same
``embed(texts) -> [n, dim]`` interface means every downstream layer
(index, engine, serve) runs unmodified in environments with no checkpoint.
"""

from __future__ import annotations

import hashlib

import numpy as np


class HashEmbedder:
    def __init__(self, dim: int = 1024, seed: int = 0):
        self.dim = dim
        self.seed = seed
        # natural text repeats a small vocabulary constantly: memoize
        # per-token features (sha256 + a dim-sized Gaussian draw each)
        # with a bounded FIFO so ingest isn't dominated by rehashing
        self._cache: dict[str, np.ndarray] = {}
        self._cache_cap = 65536

    @property
    def model_name(self) -> str:
        return f"hash-embedder-{self.dim}"

    def _feature(self, token: str) -> np.ndarray:
        v = self._cache.get(token)
        if v is not None:
            return v
        h = hashlib.sha256(f"{self.seed}:{token}".encode()).digest()
        rng = np.random.default_rng(int.from_bytes(h[:8], "big"))
        v = rng.standard_normal(self.dim).astype(np.float32)
        v /= np.linalg.norm(v)
        if len(self._cache) >= self._cache_cap:
            self._cache.pop(next(iter(self._cache)))
        self._cache[token] = v
        return v

    def embed(self, texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, text in enumerate(texts):
            words = text.lower().split()
            feats = []
            for w in words:
                feats.append(self._feature(w))
            for a, b in zip(words, words[1:]):
                feats.append(self._feature(a + " " + b))
            if feats:
                v = np.sum(feats, axis=0)
                out[i] = v / max(np.linalg.norm(v), 1e-9)
        return out
