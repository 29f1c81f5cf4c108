"""The mutable device index: float / bf16 / f32x2 / int8 / int8r shard, token cache, VectorIndex."""

from outline_rag_tpu_torch.index.shard import DeviceShard, ShardState
from outline_rag_tpu_torch.index.store import VectorIndex
from outline_rag_tpu_torch.index.tokens import TokenCache, TokenCacheState

__all__ = ["DeviceShard", "ShardState", "TokenCache", "TokenCacheState", "VectorIndex"]
