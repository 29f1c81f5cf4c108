"""Query engine: embedder (with the sparse and ColBERT heads' outputs),
rerankers, the fused query and its hybrid terms, the retrieval service
and the micro-batcher."""

from outline_rag_tpu_torch.engine.batcher import QueryBatcher
from outline_rag_tpu_torch.engine.embedder import EncoderEmbedder
from outline_rag_tpu_torch.engine.fused import (
    Q_WIDTH,
    FusedEngine,
    add_hybrid_terms,
    encode_queries,
    fused_query,
)
from outline_rag_tpu_torch.engine.rerank import CrossEncoderReranker, NoopReranker
from outline_rag_tpu_torch.engine.service import RetrievalService, RetrievedChunk

__all__ = [
    "Q_WIDTH",
    "CrossEncoderReranker",
    "EncoderEmbedder",
    "FusedEngine",
    "NoopReranker",
    "QueryBatcher",
    "RetrievalService",
    "RetrievedChunk",
    "add_hybrid_terms",
    "encode_queries",
    "fused_query",
]
