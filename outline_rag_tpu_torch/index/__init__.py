"""The mutable device index: float / bf16 / f32x2 / int8 / int8r shard, token cache
(with its ColBERT planes), VectorIndex with growth, compaction and snapshots."""

from outline_rag_tpu_torch.index.shard import DeviceShard, ShardState
from outline_rag_tpu_torch.index.store import VectorIndex
from outline_rag_tpu_torch.index.tokens import ColbertCacheState, TokenCache, TokenCacheState

__all__ = [
    "ColbertCacheState",
    "DeviceShard",
    "ShardState",
    "TokenCache",
    "TokenCacheState",
    "VectorIndex",
]
