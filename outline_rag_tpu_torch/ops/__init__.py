"""Retrieval ops: the int8 scan top-K (CUDA kernel + plain twin), the row
quantizers and the exact fp32 candidate rescore."""

from outline_rag_tpu_torch.ops.quant import (
    dequantize_rows_int8,
    int8_topk,
    quantize_rows_int8,
    quantize_rows_int8_residual,
    rescore_candidates,
    rescore_fp32,
)
from outline_rag_tpu_torch.ops.topk import (
    NEG,
    merge_topk,
    topk_int8,
    topk_int8_plain,
    topk_plain,
)

__all__ = [
    "NEG",
    "dequantize_rows_int8",
    "int8_topk",
    "merge_topk",
    "quantize_rows_int8",
    "quantize_rows_int8_residual",
    "rescore_candidates",
    "rescore_fp32",
    "topk_int8",
    "topk_int8_plain",
    "topk_plain",
]
