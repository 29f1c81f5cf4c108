// topk_float.cu — per-query top-K of a float index scan (fp32, bf16, and the
// compensated bf16x2 "f32x2" layout), for NVIDIA Hopper (built for sm_90a by
// outline_rag_tpu_torch/ops/_build.py, bound with ctypes by
// outline_rag_tpu_torch/ops/topk.py::topk_float).
//
// Replaces the float modes of the Pallas TPU kernel
// outline_rag_tpu/ops/topk.py::_fused_topk_kernel_qmajor (launched by
// _topk_pallas_qmajor_jit) and its transposed twin _fused_topk_kernel
// (_topk_pallas_jit, orientation "cmajor": the same function, written out
// as [K, B]). For each query b it returns the top K (K <= 64) over all N
// rows of
//
//     fp32:   score[b, n] = sum_d q[b, d] * c[n, d] + penalty[n]   (f32 FMAs)
//     bf16:   the same over bf16 q and c: every product is exact in f32
//     f32x2:  q and c are [*, 2D] bf16 pairs (hi ++ lo, split_f32_bf16x2);
//             score = (hi.hi + hi.lo) + lo.hi + penalty, three f32 sums
//             (the Pallas _dot_compensated)
//
// sorted by score descending, the lower row first on ties. A row scoring
// <= NEG/2 is never selected, and unfilled slots come out as (NEG, 0), as
// the Pallas kernel emits them.
//
// What bounds it on the card: at 1M x 1024 the fp32 and f32x2 corpora are
// 4 GiB (1.28 ms at 3.35 TB/s), bf16 2 GiB (0.64 ms). The bf16 and f32x2
// dots run on the tensor cores, as the reference gives them to the TPU's
// matrix unit (Precision.DEFAULT, and three bf16 passes for f32x2): at
// B = 32 their work is 0.07 / 0.21 ms at the bf16 peak, so both are bound by
// bytes. fp32 stays on the CUDA cores (Precision.HIGHEST; no TF32): a
// 32-query tile does 32 x 1M x 1024 FMAs, 1.03 ms at 67 TFLOP/s, so fp32
// sits on the line between bytes and FMAs at B = 32 and is bound by FMAs
// above it. The [B, N] score matrix never reaches device memory: only
// [chunks, B, K] partial lists.
//
// Design (two passes):
//   pass 1 (scan_kernel): a block owns 32 queries and a contiguous chunk of
//     rows (a multiple of 256), walked in tiles of 128 rows (bf16, f32x2) or
//     256 (fp32). The score pass (topk_float_tile.cuh, shared with
//     topk_floor.cu) streams 64-dimension (32 for fp32) slabs of the tile and
//     of the queries through a three-slot cp.async ring in their storage
//     type, so the next slabs are in flight while one is multiplied, across
//     tile edges too. After a tile's last slab each thread adds the penalty
//     to its scores and writes them to shared memory; the selection
//     (topk_common.cuh's WarpSelect, which topk_int8.cu runs too): one warp
//     per query reads the tile's scores and votes whether any beats the query's
//     k-th value, kept in a register (the Pallas kernel's needs_merge test).
//     Only then are the scores that beat it appended to the query's buffer
//     in shared memory (one vote and a prefix count a 32-row group); a full
//     buffer is sorted by a warp's bitonic network and merged into the
//     query's sorted running list of 64, which the warp holds in registers
//     (two entries a lane), raising the k-th value. Once a list is full,
//     most tiles cost the one vote.
//   pass 2 (merge_kernel, topk_common.cuh): one block per query merges the
//     chunks' lists; it writes [B, K] or, for cmajor, [K, B].
// Row offsets are 64-bit.

#include "topk_float_tile.cuh"

namespace {

template <int MODE>
__host__ __device__ constexpr int scan_smem() {
  return ring_bytes<MODE>() + TB * (Shape<MODE>::TN + STW) * 4 + TB * LIST * 8;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, Shape<MODE>::MIN_BLOCKS)
scan_kernel(const typename Shape<MODE>::T* __restrict__ q,
            const typename Shape<MODE>::T* __restrict__ corpus,
            const float* __restrict__ penalty, int B, long long N, int D, int K,
            long long rows_per_chunk, float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int TN = Shape<MODE>::TN;
  extern __shared__ __align__(128) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem + ring_bytes<MODE>());  // [TB][TN + STW] scores
  float* buf_v = st + TB * (TN + STW);                               // [TB][LIST] candidates
  int* buf_i = reinterpret_cast<int*>(buf_v + TB * LIST);            // [TB][LIST]

  Scan<MODE> sc{q, corpus, B, D, static_cast<int>(blockIdx.x) * TB, 0, 0};
  const long long chunk = blockIdx.y;
  chunk_rows(chunk, rows_per_chunk, N, sc.row_begin, sc.row_end);
  const long long row_end = sc.row_end;

  WarpSelect sel;  // warp w selects for queries 4w .. 4w + 3
  const int live = B - sc.q0;
  score_rows<MODE>(sc, smem, [&](long long tile, const auto& acc) {
    // epilogue: + penalty, each rounded alone; rows past the chunk are NEG
    acc.visit([&](int, int r, int qq, float dot) {
      const long long row = tile + r;
      st[qq * (TN + STW) + r] = row < row_end ? __fadd_rn(dot, penalty[row]) : NEG;
    });
    __syncthreads();
    sel.offer<TN, TN + STW>(st, buf_v, buf_i, tile, live, K);
  });
  sel.write(buf_v, buf_i, live, K, chunk * B + sc.q0, part_v, part_i);
}

static_assert(scan_smem<FP32>() <= 232448 && scan_smem<F32X2>() <= 232448, "one block an SM");
static_assert(2 * (scan_smem<BF16>() + 1024) <= 233472, "two bf16 blocks an SM");

template <int MODE>
int launch_scan(const void* q, const void* corpus, const void* penalty, int B, long long N,
                int D, int K, int n_chunks, long long rows_per_chunk, void* part_v,
                void* part_i, cudaStream_t s) {
  using T = typename Shape<MODE>::T;
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, scan_smem<MODE>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + TB - 1) / TB, n_chunks);
  scan_kernel<MODE><<<grid, THREADS, scan_smem<MODE>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(corpus),
      static_cast<const float*>(penalty), B, N, D, K, rows_per_chunk,
      static_cast<float*>(part_v), static_cast<int*>(part_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 fp32, 1 bf16, 2 f32x2. D is the logical width: q and corpus rows
// hold D elements (2D bf16 in f32x2 mode). transposed: write out as [K, B].
// Launches both passes on `stream`; allocates nothing. Returns 0 or the CUDA
// error code of the failed call (cudaGetLastError after each launch).
extern "C" int topk_float_launch(int mode, const void* q, const void* corpus,
                                 const void* penalty, int B, long long N, int D,
                                 int K, int n_chunks, long long rows_per_chunk,
                                 int transposed, void* part_v, void* part_i,
                                 void* out_v, void* out_i, void* stream) {
  if (mode < FP32 || mode > F32X2 || B <= 0 || N <= 0 || N > 0x7fffffffLL ||
      D <= 0 || D % DSTEP || K <= 0 || K > KMAX || K > N || n_chunks <= 0 ||
      n_chunks > 65535 || rows_per_chunk <= 0 || rows_per_chunk % CHUNK_ROWS ||
      (long long)n_chunks * rows_per_chunk < N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (mode == FP32)
    rc = launch_scan<FP32>(q, corpus, penalty, B, N, D, K, n_chunks, rows_per_chunk, part_v,
                           part_i, s);
  else if (mode == BF16)
    rc = launch_scan<BF16>(q, corpus, penalty, B, N, D, K, n_chunks, rows_per_chunk, part_v,
                           part_i, s);
  else
    rc = launch_scan<F32X2>(q, corpus, penalty, B, N, D, K, n_chunks, rows_per_chunk, part_v,
                            part_i, s);
  if (rc != 0) return rc;
  merge_kernel<<<B, THREADS, 0, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), B, K,
      n_chunks, transposed, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
