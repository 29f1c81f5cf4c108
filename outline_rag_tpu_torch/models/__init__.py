"""Model forward passes: the XLM-R encoder, the cross-encoder reranker,
the Llama/Qwen-family chat decoder, the hash tokenizer and the JAX-params
converters."""

from outline_rag_tpu_torch.models.convert import (
    config_from_jax,
    decoder_config_from_jax,
    decoder_from_jax,
    decoder_params_from_state_dict,
    encoder_from_jax,
    init_encoder,
    init_reranker,
    paged_kv_from_jax,
    reranker_from_jax,
)
from outline_rag_tpu_torch.models.decoder import (
    DecoderConfig,
    PagedKV,
    cast_decoder_params,
    decoder_forward,
    fuse_decoder_params,
    generate_chunk,
    init_cache,
    init_decoder,
    init_paged_cache,
    key_at,
    make_key,
    quantize_decoder_params,
    sample_token,
)
from outline_rag_tpu_torch.models.encoder import Encoder, EncoderConfig, pooled_embeddings
from outline_rag_tpu_torch.models.reranker import Reranker

__all__ = [
    "DecoderConfig",
    "Encoder",
    "EncoderConfig",
    "PagedKV",
    "Reranker",
    "cast_decoder_params",
    "config_from_jax",
    "decoder_config_from_jax",
    "decoder_forward",
    "decoder_from_jax",
    "decoder_params_from_state_dict",
    "encoder_from_jax",
    "fuse_decoder_params",
    "generate_chunk",
    "init_cache",
    "init_decoder",
    "init_encoder",
    "init_paged_cache",
    "init_reranker",
    "key_at",
    "make_key",
    "paged_kv_from_jax",
    "pooled_embeddings",
    "quantize_decoder_params",
    "reranker_from_jax",
    "sample_token",
]
