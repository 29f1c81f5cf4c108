// topk_int8.cu — per-query top-K of an int8 index scan, for NVIDIA Hopper
// (built for sm_90a by outline_rag_tpu_torch/ops/_build.py, bound with ctypes
// by outline_rag_tpu_torch/ops/topk.py::topk_int8).
//
// Replaces the int8 mode of the Pallas TPU kernel
// outline_rag_tpu/ops/topk.py::_fused_topk_kernel_qmajor (launched by
// _topk_pallas_qmajor_jit). For each query b it returns the top K (K <= 64)
// over all N rows of
//
//     score[b, n] = (float(sum_d q[b, d] * c[n, d]) * cscale[n]) * qscale[b]
//                   + penalty[n]
//
// sorted by score descending, the lower row index first on ties. A row whose
// score is <= NEG/2 is never selected, and unfilled slots come out as
// (NEG, 0), exactly as the Pallas kernel emits them.
//
// What bounds it on the card: the scan reads 1 byte per element of the
// [N, D] corpus (1 GiB at 1M x 1024, 0.32 ms at 3.35 TB/s) once per tile of
// 32 queries, so at the serving batch (B <= 32) the corpus is read once. The
// int8 dots run on the tensor cores, as the reference gives them to the
// TPU's matrix unit with int32 accumulation: at B = 32 they are 68.7 G
// operations, 0.035 ms at the int8 peak, so bytes bind by 9x. The [B, N]
// score matrix never reaches device memory: only [chunks, B, K] partial
// lists.
//
// Design (two passes, on the float scan's score pass and selection):
//   pass 1 (scan_kernel): a block owns 32 queries and a contiguous chunk of
//     rows (a multiple of 256), walked in 128-row tiles. The score pass
//     (topk_float_tile.cuh, mode INT8) streams 128-byte slabs of the tile
//     and of the queries through a three-slot cp.async ring as bytes, so the
//     next slabs are in flight while one is multiplied, across tile edges
//     too; each warp multiplies its 16 rows against the 32 queries with
//     mma.sync.m16n8k32 (s8 x s8 -> s32) fed by ldmatrix. The int32 sums are
//     exact in any order. After a tile's last slab each thread applies the
//     scales and the penalty in the Pallas order, converting once and
//     rounding each step alone (__int2float_rn, __fmul_rn, __fadd_rn: no FMA
//     contraction), so the values agree bit for bit with the plain PyTorch
//     version (the block's query scales wait in shared memory, the rows'
//     scales and penalties are read as the tile ends), and writes the scores
//     to shared memory. The selection is
//     topk_common.cuh's WarpSelect, as in topk_float.cu: a per-query vote
//     against the k-th value in a register, winners buffered in shared
//     memory and merged into a register list by a warp's bitonic network.
//   pass 2 (merge_kernel, topk_common.cuh): one block per query merges the
//     chunks' sorted lists.
// Row offsets are 64-bit: N * D passes 2^31 at 10M x 1024.

#include "topk_float_tile.cuh"

namespace {

using S8 = Shape<INT8>;

__host__ __device__ constexpr int int8_scan_smem() {
  return ring_bytes<INT8>() + TB * (S8::TN + STW) * 4 + TB * LIST * 8 + TB * 4;
}
static_assert(2 * (int8_scan_smem() + 1024) <= 233472, "two int8 blocks an SM");

__global__ void __launch_bounds__(THREADS, S8::MIN_BLOCKS)
scan_kernel(const int8_t* __restrict__ q, const float* __restrict__ qscale,
            const int8_t* __restrict__ corpus, const float* __restrict__ cscale,
            const float* __restrict__ penalty, int B, long long N, int D, int K,
            long long rows_per_chunk, float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int TN = S8::TN;
  extern __shared__ __align__(128) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem + ring_bytes<INT8>());  // [TB][TN + STW] scores
  float* buf_v = st + TB * (TN + STW);                               // [TB][LIST] candidates
  int* buf_i = reinterpret_cast<int*>(buf_v + TB * LIST);            // [TB][LIST]
  float* qsc = reinterpret_cast<float*>(buf_i + TB * LIST);          // [TB] query scales

  Scan<INT8> sc{q, corpus, B, D, static_cast<int>(blockIdx.x) * TB, 0, 0};
  const long long chunk = blockIdx.y;
  chunk_rows(chunk, rows_per_chunk, N, sc.row_begin, sc.row_end);
  const long long row_end = sc.row_end;

  // the block's query scales; a query past B has 0
  if (threadIdx.x < TB)
    qsc[threadIdx.x] = sc.q0 + threadIdx.x < B ? qscale[sc.q0 + threadIdx.x] : 0.f;

  WarpSelect sel;  // warp w selects for queries 4w .. 4w + 3
  const int live = B - sc.q0;
  score_rows<INT8>(sc, smem, [&](long long tile, const auto& acc) {
    // epilogue: (float(acc) * cscale) * qscale + penalty, each step rounded
    // alone; rows past the chunk are NEG
    acc.visit([&](int, int r, int qq, int dot) {
      const long long row = tile + r;
      float s = NEG;
      if (row < row_end) {
        const float csc = cscale[row];
        s = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(dot), csc), qsc[qq]), penalty[row]);
      }
      st[qq * (TN + STW) + r] = s;
    });
    __syncthreads();
    sel.offer<TN, TN + STW>(st, buf_v, buf_i, tile, live, K);
  });
  sel.write(buf_v, buf_i, live, K, chunk * B + sc.q0, part_v, part_i);
}

}  // namespace

// Launches both passes on `stream`; allocates nothing. Returns 0 or the CUDA
// error code of the failed call (cudaGetLastError after each launch).
extern "C" int topk_int8_launch(const void* q, const void* qscale,
                                const void* corpus, const void* cscale,
                                const void* penalty, int B, long long N, int D,
                                int K, int n_chunks, long long rows_per_chunk,
                                void* part_v, void* part_i, void* out_v,
                                void* out_i, void* stream) {
  if (B <= 0 || N <= 0 || N > 0x7fffffffLL || D <= 0 || D % 16 || K <= 0 ||
      K > KMAX || K > N || n_chunks <= 0 || n_chunks > 65535 ||
      rows_per_chunk <= 0 || rows_per_chunk % CHUNK_ROWS ||
      (long long)n_chunks * rows_per_chunk < N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int8_scan_smem());
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + TB - 1) / TB, n_chunks);
  scan_kernel<<<grid, THREADS, int8_scan_smem(), s>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(qscale),
      static_cast<const int8_t*>(corpus), static_cast<const float*>(cscale),
      static_cast<const float*>(penalty), B, N, D, K, rows_per_chunk,
      static_cast<float*>(part_v), static_cast<int*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<B, THREADS, 0, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), B, K,
      n_chunks, 0, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
