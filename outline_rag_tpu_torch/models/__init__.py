"""Model forward passes: the XLM-R encoder, the cross-encoder reranker,
the hash tokenizer and the JAX-params converter."""

from outline_rag_tpu_torch.models.convert import (
    config_from_jax,
    encoder_from_jax,
    init_encoder,
    init_reranker,
    reranker_from_jax,
)
from outline_rag_tpu_torch.models.encoder import Encoder, EncoderConfig, pooled_embeddings
from outline_rag_tpu_torch.models.reranker import Reranker

__all__ = [
    "Encoder",
    "EncoderConfig",
    "Reranker",
    "config_from_jax",
    "encoder_from_jax",
    "init_encoder",
    "init_reranker",
    "pooled_embeddings",
    "reranker_from_jax",
]
