"""Query engine: embedder (with the sparse and ColBERT heads' outputs),
rerankers, the fused query (one device or a row-sharded mesh) and its
hybrid terms, the retrieval service
and the micro-batcher."""

from outline_rag_tpu_torch.engine.batcher import QueryBatcher
from outline_rag_tpu_torch.engine.embedder import EncoderEmbedder, get_embedder
from outline_rag_tpu_torch.engine.fused import (
    Q_WIDTH,
    FusedEngine,
    add_hybrid_terms,
    encode_queries,
    fused_query,
    fused_query_mesh,
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
    "fused_query_mesh",
    "get_embedder",
]
