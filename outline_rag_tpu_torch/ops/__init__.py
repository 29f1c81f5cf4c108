"""Retrieval ops: the int8 and float scan top-Ks (CUDA kernels + plain
twins), the flash attention of whole-document ingest (CUDA kernel + plain
twin), the row quantizers and the exact fp32 candidate rescore."""

from outline_rag_tpu_torch.ops.attention import (
    NEG_BIAS,
    flash_attention,
    flash_attention_plain,
)
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
    cosine_topk,
    join_bf16x2,
    merge_topk,
    split_f32_bf16x2,
    topk_float,
    topk_float_plain,
    topk_int8,
    topk_int8_plain,
    topk_plain,
)

__all__ = [
    "NEG",
    "NEG_BIAS",
    "cosine_topk",
    "dequantize_rows_int8",
    "flash_attention",
    "flash_attention_plain",
    "int8_topk",
    "join_bf16x2",
    "merge_topk",
    "quantize_rows_int8",
    "quantize_rows_int8_residual",
    "rescore_candidates",
    "rescore_fp32",
    "split_f32_bf16x2",
    "topk_float",
    "topk_float_plain",
    "topk_int8",
    "topk_int8_plain",
    "topk_plain",
]
