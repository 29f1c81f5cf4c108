"""Mesh parallelism: row-sharded scoring with a cross-shard top-K merge,
data-parallel encoding and training, multi-process index builds and
Megatron tensor parallelism for the decoder.

Port of ``outline_rag_tpu/parallel/``. A mesh is an explicit, ordered list
of devices (``mesh.py``); each shard's kernel launches on its own device,
and what crosses devices is the tiny ``[B, K]`` lists of the merge
(``query.py``) or the row-parallel partial sums of the decoder (``tp.py``).
"""

from outline_rag_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    RowShards,
    data_mesh,
    row_sharding,
)
from outline_rag_tpu_torch.parallel.query import sharded_topk

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "RowShards",
    "data_mesh",
    "row_sharding",
    "sharded_topk",
]
