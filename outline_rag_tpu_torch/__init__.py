"""outline_rag_tpu_torch — the retrieval path and the local chat decoder
of ``outline_rag_tpu`` on PyTorch and CUDA (NVIDIA Hopper).

The JAX package beside it is the reference; this package keeps its module
names so each counterpart is easy to find, and it never imports jax:

- ``device``  : explicit device resolution (no silent CPU fallback).
- ``ops``     : the hand-written CUDA kernels in ``csrc/`` (int8 and float
                scan top-K, flash attention, paged attention, KV page
                write, w8a16 linear), each with its plain PyTorch twin; row
                and weight quantizers; the exact fp32 candidate rescore.
- ``index``   : the capacity-padded int8/int8r shard, the chunk-token
                cache and the mutable ``VectorIndex``.
- ``models``  : the XLM-R (BGE-m3) encoder, the cross-encoder reranker,
                the Llama/Qwen-family chat decoder with its ring and paged
                KV caches, the hash tokenizer and the JAX-params converters.
- ``engine``  : the embedder, the reranker backends, the fused
                embed -> scan -> rescore -> rerank query, the retrieval
                service and the query micro-batcher.
- ``serve``   : the continuous decode batcher (paged KV pool, prefix
                cache) and the local chat provider.
"""

__version__ = "0.1.0"
