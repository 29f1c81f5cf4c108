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
// [N, D] corpus (1 GiB at 1M x 1024) once per tile of 32 queries, so at the
// serving batch (B <= 32) the corpus is read once; the int8 dots run on the
// CUDA cores with __dp4a (4 multiply-adds per instruction), which at B = 32
// costs about as much time as the read. The design keeps the [B, N] score
// matrix out of device memory entirely: only [chunks, B, K] partial lists are
// written.
//
// Design (two passes, simple first; wgmma, TMA and a single fused pass are
// later work):
//   pass 1 (scan_kernel): a block owns 32 queries, held in shared memory for
//     the whole run, and a contiguous chunk of rows, which it walks in
//     128-row tiles. Coalesced 16-byte loads stage a 128-row x 128-byte slab
//     of the corpus in shared memory; each of the 256 threads forms a
//     4-row x 4-query block of int32 dots with __dp4a. The epilogue applies
//     the scales and the penalty in the Pallas order, with explicitly
//     rounded multiplies and adds (__fmul_rn, __fadd_rn: no FMA
//     contraction), so the values agree bit for bit with the plain PyTorch
//     version. One warp per query then inserts the tile's winners into a
//     sorted running top-K list in shared memory; after warm-up most rows
//     fail the k-th-value test and cost one ballot. The list is written out
//     as the chunk's partial top-K.
//   pass 2 (merge_kernel, topk_common.cuh): one block per query merges the
//     chunks' sorted partial lists, one bitonic merge a list in each warp,
//     then merges the eight warp lists.
// Row offsets are 64-bit: N * D passes 2^31 at 10M x 1024.

#include "topk_common.cuh"

namespace {

constexpr int TB = 32;          // queries per pass-1 block
constexpr int TN = 128;         // rows per pass-1 tile
constexpr int DC = 128;         // bytes of each row staged per step
constexpr int CW = DC / 4 + 4;  // words per staged row; the 4 padding words
                                // make the 16-byte shared reads conflict-free
constexpr int THREADS = SEL_THREADS;

__global__ void __launch_bounds__(THREADS)
scan_kernel(const int8_t* __restrict__ q, const float* __restrict__ qscale,
            const int8_t* __restrict__ corpus, const float* __restrict__ cscale,
            const float* __restrict__ penalty, int B, long long N, int D, int K,
            long long rows_per_chunk, float* __restrict__ part_v,
            int* __restrict__ part_i) {
  extern __shared__ __align__(16) int smem[];
  const int DW = D >> 2;                   // words per row
  int* qs = smem;                          // [TB][DW] query words
  int* cs = qs + TB * DW;                  // [TN][CW] staged corpus words
  float* st = reinterpret_cast<float*>(cs);  // [TB][TN] scores (reuses cs)
  float* lv = reinterpret_cast<float*>(cs + TN * CW);  // [TB][KMAX]
  int* li = reinterpret_cast<int*>(lv + TB * KMAX);    // [TB][KMAX]
  int* cnt = li + TB * KMAX;                           // [TB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * TB;
  const long long chunk = blockIdx.y;
  const long long row_begin = chunk * rows_per_chunk;
  const long long row_end =
      row_begin + rows_per_chunk < N ? row_begin + rows_per_chunk : N;

  // the block's queries -> shared memory; rows past B are zero
  const int qvecs = D >> 4;
  for (int v = tid; v < TB * qvecs; v += THREADS) {
    const int r = v / qvecs, c = v % qvecs;
    int4 val = make_int4(0, 0, 0, 0);
    if (q0 + r < B)
      val = reinterpret_cast<const int4*>(q + (long long)(q0 + r) * D)[c];
    reinterpret_cast<int4*>(qs + r * DW)[c] = val;
  }
  if (tid < TB) cnt[tid] = 0;
  __syncthreads();

  // thread (lane, warp) computes rows lane + 32*a of the tile against
  // queries 4*warp + b of the block; warp w also selects for those queries
  for (long long tile = row_begin; tile < row_end; tile += TN) {
    int acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0;

    for (int d0 = 0; d0 < D; d0 += DC) {
      const int width = D - d0 < DC ? D - d0 : DC;  // a multiple of 16
      for (int v = tid; v < TN * (DC >> 4); v += THREADS) {
        const int r = v / (DC >> 4), c = v % (DC >> 4);
        const long long row = tile + r;
        int4 val = make_int4(0, 0, 0, 0);
        if (c * 16 < width && row < row_end)
          val = *reinterpret_cast<const int4*>(corpus + row * D + d0 + c * 16);
        *reinterpret_cast<int4*>(cs + r * CW + c * 4) = val;
      }
      __syncthreads();
      const int* qbase = qs + (warp * 4) * DW + (d0 >> 2);
      for (int w = 0; w < (width >> 2); w += 4) {
        int4 cw[4], qw[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          cw[a] = *reinterpret_cast<const int4*>(cs + (lane + 32 * a) * CW + w);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          qw[b] = *reinterpret_cast<const int4*>(qbase + b * DW + w);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            acc[a][b] = __dp4a(cw[a].x, qw[b].x, acc[a][b]);
            acc[a][b] = __dp4a(cw[a].y, qw[b].y, acc[a][b]);
            acc[a][b] = __dp4a(cw[a].z, qw[b].z, acc[a][b]);
            acc[a][b] = __dp4a(cw[a].w, qw[b].w, acc[a][b]);
          }
      }
      __syncthreads();
    }

    // epilogue: (acc * cscale) * qscale + penalty, each step rounded alone
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const long long row = tile + lane + 32 * a;
      const bool in_range = row < row_end;
      const float csc = in_range ? cscale[row] : 0.f;
      const float pen = in_range ? penalty[row] : NEG;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int qq = warp * 4 + b;
        const float qsc = q0 + qq < B ? qscale[q0 + qq] : 0.f;
        const float s = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[a][b]), csc), qsc), pen);
        st[qq * TN + lane + 32 * a] = in_range ? s : NEG;
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
    const int n = cnt[qq];
    const long long base = (chunk * B + (q0 + qq)) * (long long)K;
    warp_write(lv + qq * KMAX, li + qq * KMAX, n, K, part_v + base,
               part_i + base, 1);
  }
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
      rows_per_chunk <= 0 || rows_per_chunk % TN ||
      (long long)n_chunks * rows_per_chunk < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)TB * D + (size_t)TN * CW * sizeof(int) +
                      (size_t)TB * KMAX * (sizeof(float) + sizeof(int)) +
                      TB * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + TB - 1) / TB, n_chunks);
  scan_kernel<<<grid, THREADS, smem, s>>>(
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
