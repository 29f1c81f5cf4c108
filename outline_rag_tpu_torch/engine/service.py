"""RetrievalService: the engine facade.

Port of ``outline_rag_tpu/engine/service.py``. Two paths behind one
``retrieve_batch`` call:

- fused (``engine/fused.py``) when the embedder and the reranker are the
  port's encoder classes and the index carries a token cache;
- staged: embed -> ``index.query`` -> rerank as separate calls, for setups
  without a cross-encoder or a token cache.

An error on the fused path propagates: there is no retry and no downgrade
to the staged path. Each batch is a span of the process's metrics
(``utils/profiling.py``) under the JAX package's stage names:
``retrieve.fused`` (the fused engine's stage spans are its children) or
``retrieve.staged``, and the staged path's ``retrieve.embed`` and
``retrieve.index``.
"""

from __future__ import annotations

import dataclasses

from outline_rag_tpu_torch.engine.embedder import EncoderEmbedder
from outline_rag_tpu_torch.engine.fused import FusedEngine
from outline_rag_tpu_torch.engine.rerank import CrossEncoderReranker, NoopReranker
from outline_rag_tpu_torch.index.store import VectorIndex
from outline_rag_tpu_torch.utils.profiling import metrics


@dataclasses.dataclass
class RetrievedChunk:
    chunk_id: str
    score: float  # retrieval (dense) score on both paths
    rerank_score: float | None = None  # cross-encoder score


class RetrievalService:
    def __init__(
        self,
        index: VectorIndex,
        embedder,
        reranker=None,
        top_k: int = 12,
        rerank_k: int = 3,
        chunk_text_lookup=None,  # callable chunk_id -> text (staged rerank)
        lex_weight: float = 0.0,  # > 0: the fused path's lexical term
        colbert_weight: float = 0.0,  # > 0: the fused path's ColBERT term
    ):
        self.index = index
        self.embedder = embedder
        self.reranker = reranker or NoopReranker()
        self.top_k = top_k
        self.rerank_k = rerank_k
        self.chunk_text_lookup = chunk_text_lookup
        self._fused = None
        if (
            isinstance(embedder, EncoderEmbedder)
            and isinstance(self.reranker, CrossEncoderReranker)
            and index.tokens is not None
        ):
            self._fused = FusedEngine(
                embedder, self.reranker, index, top_k, rerank_k,
                lex_weight=lex_weight, colbert_weight=colbert_weight,
            )

    @property
    def fused(self) -> bool:
        return self._fused is not None

    def retrieve_batch(self, queries: list[str]) -> list[list[RetrievedChunk]]:
        if not queries:
            return []
        if self._fused is not None:
            with metrics.timeit("retrieve.fused"):
                fused_out = self._fused.query(queries)
            return [
                [RetrievedChunk(cid, dense, rerank_score=rr) for cid, rr, dense in row]
                for row in fused_out
            ]
        with metrics.timeit("retrieve.staged"):
            return self._staged(queries)

    def retrieve(self, query: str) -> list[RetrievedChunk]:
        return self.retrieve_batch([query])[0]

    def _staged(self, queries: list[str]) -> list[list[RetrievedChunk]]:
        with metrics.timeit("retrieve.embed"):
            qvecs = self.embedder.embed(queries)
        with metrics.timeit("retrieve.index"):
            ids, scores = self.index.query(qvecs, self.top_k)
        out: list[list[RetrievedChunk]] = []
        for qi, (query, chunk_ids) in enumerate(zip(queries, ids)):
            if not chunk_ids:
                out.append([])
                continue
            if isinstance(self.reranker, NoopReranker) or self.chunk_text_lookup is None:
                out.append(
                    [
                        RetrievedChunk(cid, float(scores[qi, j]))
                        for j, cid in enumerate(chunk_ids[: self.rerank_k])
                    ]
                )
                continue
            texts = [self.chunk_text_lookup(cid) or "" for cid in chunk_ids]
            ranked = self.reranker.rerank(query, texts, self.rerank_k)
            out.append(
                [
                    RetrievedChunk(chunk_ids[i], float(scores[qi, i]), rerank_score=s)
                    for i, s in ranked
                ]
            )
        return out
