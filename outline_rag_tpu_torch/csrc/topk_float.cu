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
// the Pallas kernel emits them. The fp32 mode runs true fp32 fused
// multiply-adds on the CUDA cores: no TF32 (the Precision.HIGHEST rule).
//
// What bounds it on the card: at 1M x 1024 the fp32 and f32x2 corpora are
// 4 GiB (1.28 ms at 3.35 TB/s), bf16 2 GiB. A 32-query tile does
// 32 x 1M x 1024 FMAs (68.7 GFLOP at B = 32, about 1.1 ms at the H100's
// ~60 TFLOP/s of f32 FMA); f32x2 does three times that. So the fp32 and
// bf16 modes sit near the line between memory and FMA rate at B = 32, and
// f32x2 and every mode at B = 128 are bound by FMAs. As written, the loop
// below is bound before either: its 4 x 4 register tile reads one float
// from shared memory per two FMAs (per three in f32x2), and shared memory
// feeds an SM 32 floats a clock against 128 FMA lanes, so it runs at most
// at half the FMA rate (f32x2 three quarters); a wider register tile is
// the next step. The [B, N] score matrix never reaches device memory:
// only [chunks, B, K] partial lists.
//
// Design (the two passes of topk_int8.cu, simple first; wgmma, TMA and a
// fused single pass are later work):
//   pass 1 (scan_kernel): a block owns 32 queries and a contiguous chunk of
//     rows, walked in 128-row tiles (the score pass is topk_float_tile.cuh,
//     shared with topk_floor.cu). For each 32-dimension step, coalesced
//     16-byte loads stage a [32 queries][32] and a [128 rows][32] slab in
//     shared memory as f32 (bf16 widens exactly); each of the 256 threads
//     forms a 4-row x 4-query block of dots with fmaf, in d order. Every
//     row's score comes from the same instruction sequence wherever the row
//     sits in a tile or chunk, so duplicated rows tie exactly and the lower
//     row wins. One warp per query then inserts the tile's scores into a
//     sorted running top-K list in shared memory (topk_common.cuh).
//   pass 2 (merge_kernel, topk_common.cuh): one block per query merges the
//     chunks' lists; it writes [B, K] or, for cmajor, [K, B].
// Row offsets are 64-bit.

#include "topk_float_tile.cuh"

namespace {

template <typename T, bool COMP>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const T* __restrict__ q, const T* __restrict__ corpus,
            const float* __restrict__ penalty, int B, long long N, int D,
            int K, long long rows_per_chunk, float* __restrict__ part_v,
            int* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  constexpr int PLANES = COMP ? 2 : 1;     // hi (and lo) slabs
  float* cs = smem;                        // [PLANES][TN][CW] corpus slabs
  float* qs = cs + PLANES * TN * CW;       // [PLANES][TB][CW] query slabs
  float* st = cs;                          // [TB][TN] scores (reuses cs)
  float* lv = qs + PLANES * TB * CW;       // [TB][KMAX]
  int* li = reinterpret_cast<int*>(lv + TB * KMAX);  // [TB][KMAX]
  int* cnt = li + TB * KMAX;                         // [TB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TB;
  const long long chunk = blockIdx.y;
  const long long row_begin = chunk * rows_per_chunk;
  const long long row_end =
      row_begin + rows_per_chunk < N ? row_begin + rows_per_chunk : N;
  const long long W = COMP ? 2LL * D : D;  // stored row width
  if (tid < TB) cnt[tid] = 0;
  __syncthreads();

  // thread (lane, warp) computes rows lane + 32*a of the tile against
  // queries 4*warp + b of the block; warp w also selects for those queries
  for (long long tile = row_begin; tile < row_end; tile += TN) {
    float acc[4][4], acc_hl[4][4], acc_lh[4][4];
    score_tile<T, COMP>(q, corpus, W, tile, row_end, q0, B, D, cs, qs, acc,
                        acc_hl, acc_lh);

    // epilogue: (hi.hi + hi.lo) + lo.hi, then + penalty, each rounded alone
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const long long row = tile + lane + 32 * a;
      const bool in_range = row < row_end;
      const float pen = in_range ? penalty[row] : NEG;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float dot = tile_dot<COMP>(acc[a][b], acc_hl[a][b], acc_lh[a][b]);
        st[(warp * 4 + b) * TN + lane + 32 * a] = in_range ? __fadd_rn(dot, pen) : NEG;
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int b = 0; b < 4; ++b) {
      const int qq = warp * 4 + b;
      if (q0 + qq >= B) break;  // the same in every lane of the warp
      int n = cnt[qq];
#pragma unroll 1
      for (int a = 0; a < 4; ++a) {
        const int r = lane + 32 * a;
        warp_offer(lv + qq * KMAX, li + qq * KMAX, n, K, st[qq * TN + r],
                   static_cast<int>(tile + r), tile + r < row_end);
      }
      if (lane == 0) cnt[qq] = n;
    }
    __syncthreads();
  }

  for (int b = 0; b < 4; ++b) {
    const int qq = warp * 4 + b;
    if (q0 + qq >= B) break;
    const long long base = (chunk * B + (q0 + qq)) * (long long)K;
    warp_write(lv + qq * KMAX, li + qq * KMAX, cnt[qq], K, part_v + base,
               part_i + base, 1);
  }
}

template <typename T, bool COMP>
int launch_scan(const void* q, const void* corpus, const void* penalty, int B,
                long long N, int D, int K, int n_chunks,
                long long rows_per_chunk, void* part_v, void* part_i,
                cudaStream_t s) {
  constexpr int PLANES = COMP ? 2 : 1;
  const size_t smem = (size_t)PLANES * (TN + TB) * CW * sizeof(float) +
                      (size_t)TB * KMAX * (sizeof(float) + sizeof(int)) +
                      TB * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<T, COMP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + TB - 1) / TB, n_chunks);
  scan_kernel<T, COMP><<<grid, THREADS, smem, s>>>(
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
      D <= 0 || D % DC || K <= 0 || K > KMAX || K > N || n_chunks <= 0 ||
      n_chunks > 65535 || rows_per_chunk <= 0 || rows_per_chunk % TN ||
      (long long)n_chunks * rows_per_chunk < N)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (mode == FP32)
    rc = launch_scan<float, false>(q, corpus, penalty, B, N, D, K, n_chunks,
                                   rows_per_chunk, part_v, part_i, s);
  else if (mode == BF16)
    rc = launch_scan<__nv_bfloat16, false>(q, corpus, penalty, B, N, D, K,
                                           n_chunks, rows_per_chunk, part_v,
                                           part_i, s);
  else
    rc = launch_scan<__nv_bfloat16, true>(q, corpus, penalty, B, N, D, K,
                                          n_chunks, rows_per_chunk, part_v,
                                          part_i, s);
  if (rc != 0) return rc;
  merge_kernel<<<B, THREADS, 0, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), B, K,
      n_chunks, transposed, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
