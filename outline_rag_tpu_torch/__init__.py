"""outline_rag_tpu_torch — the retrieval path of ``outline_rag_tpu`` on
PyTorch and CUDA (NVIDIA Hopper).

The JAX package beside it is the reference; this package keeps its module
names so each counterpart is easy to find, and it never imports jax:

- ``device``  : explicit device resolution (no silent CPU fallback).
- ``ops``     : the int8 scan top-K (hand-written CUDA kernel in ``csrc/``
                with its plain PyTorch twin), row quantizers and the exact
                fp32 candidate rescore.
- ``index``   : the capacity-padded int8/int8r shard, the chunk-token
                cache and the mutable ``VectorIndex``.
- ``models``  : the XLM-R (BGE-m3) encoder, the cross-encoder reranker,
                the hash tokenizer and the JAX-params converter.
- ``engine``  : the embedder, the reranker backends, the fused
                embed -> scan -> rescore -> rerank query, the retrieval
                service and the query micro-batcher.
"""

__version__ = "0.1.0"
