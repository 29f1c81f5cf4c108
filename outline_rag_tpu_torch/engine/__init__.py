"""Query engine: embedder, rerankers, the fused query, the retrieval
service and the micro-batcher."""

from outline_rag_tpu_torch.engine.batcher import QueryBatcher
from outline_rag_tpu_torch.engine.embedder import EncoderEmbedder
from outline_rag_tpu_torch.engine.fused import FusedEngine, fused_query
from outline_rag_tpu_torch.engine.rerank import CrossEncoderReranker, NoopReranker
from outline_rag_tpu_torch.engine.service import RetrievalService, RetrievedChunk

__all__ = [
    "CrossEncoderReranker",
    "EncoderEmbedder",
    "FusedEngine",
    "NoopReranker",
    "QueryBatcher",
    "RetrievalService",
    "RetrievedChunk",
    "fused_query",
]
