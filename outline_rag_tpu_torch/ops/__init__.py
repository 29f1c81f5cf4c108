"""Ops: the int8 and float scan top-Ks, the flash attention of
whole-document ingest, the decoder's paged attention, KV page write and
w8a16 linear, the int4 linears (w4a8, w4a16), the floors of the scan and
of the int4 stream, and the row gather and scatter of a host-resident plane
(each a CUDA kernel with its plain twin), the row and weight quantizers, the
w8a8 product, the exact fp32 candidate rescore and its host-residual tier."""

from outline_rag_tpu_torch.ops.attention import (
    NEG_BIAS,
    flash_attention,
    flash_attention_plain,
)
# ``int8_linear`` and ``paged_attention`` are imported from their modules of
# the same name, not re-exported here: a package attribute would shadow the
# submodule for ``import outline_rag_tpu_torch.ops.paged_attention as m``.
from outline_rag_tpu_torch.ops.hostmem import (
    gather_rows,
    gather_rows_plain,
    host_gather_rows,
    host_scatter_rows,
    is_host_resident,
    make_host_append,
    scatter_rows_plain,
    to_pinned_host,
)
from outline_rag_tpu_torch.ops.hostres import host_residual_topk
from outline_rag_tpu_torch.ops.int4_linear import (
    int4_kernel_eligible,
    int4_stream_floor,
    int4_stream_floor_plain,
    quantize_int4_weight,
    quantize_rows,
    unpack_int4,
    w4a8_matmul,
    w4a8_matmul_plain,
    w4a16_matmul,
    w4a16_matmul_plain,
)
from outline_rag_tpu_torch.ops.int8_linear import (
    int8_linear_plain,
    quantize_linear_weight,
    w8a8_matmul,
)
from outline_rag_tpu_torch.ops.paged_attention import (
    paged_attention_plain,
    paged_kv_write,
    paged_kv_write_plain,
    paged_kv_write_rope,
    paged_kv_write_rope_plain,
)
from outline_rag_tpu_torch.ops.quant import (
    dequantize_rows_int8,
    int8_topk,
    int8_topk_candidates,
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
    topk_floor,
    topk_floor_plain,
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
    "gather_rows",
    "gather_rows_plain",
    "host_gather_rows",
    "host_scatter_rows",
    "int4_kernel_eligible",
    "int4_stream_floor",
    "int4_stream_floor_plain",
    "int8_linear_plain",
    "host_residual_topk",
    "is_host_resident",
    "make_host_append",
    "int8_topk",
    "int8_topk_candidates",
    "join_bf16x2",
    "merge_topk",
    "paged_attention_plain",
    "paged_kv_write",
    "paged_kv_write_plain",
    "paged_kv_write_rope",
    "paged_kv_write_rope_plain",
    "quantize_int4_weight",
    "quantize_linear_weight",
    "quantize_rows_int8",
    "quantize_rows_int8_residual",
    "rescore_candidates",
    "rescore_fp32",
    "scatter_rows_plain",
    "split_f32_bf16x2",
    "topk_float",
    "topk_float_plain",
    "topk_floor",
    "topk_floor_plain",
    "topk_int8",
    "topk_int8_plain",
    "topk_plain",
    "to_pinned_host",
    "unpack_int4",
    "quantize_rows",
    "w4a8_matmul",
    "w4a8_matmul_plain",
    "w4a16_matmul",
    "w4a16_matmul_plain",
    "w8a8_matmul",
]
