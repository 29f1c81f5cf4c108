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
//   pass 2 (merge_kernel): one block per query merges the chunks' partial
//     lists with the same warp insertion, then merges the eight warp lists.
// Row offsets are 64-bit: N * D passes 2^31 at 10M x 1024.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 32;          // queries per pass-1 block
constexpr int TN = 128;         // rows per pass-1 tile
constexpr int DC = 128;         // bytes of each row staged per step
constexpr int CW = DC / 4 + 4;  // words per staged row; the 4 padding words
                                // make the 16-byte shared reads conflict-free
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 64;
constexpr float NEG = -1e30f;
constexpr float DEAD = -5e29f;  // NEG / 2: scores at or below are never kept

__device__ __forceinline__ bool ranks_before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// One warp offers up to 32 candidates, one per lane (`valid` marks the real
// ones), to a list in shared memory: lv/li hold n entries (n is the same in
// every lane) sorted by (value desc, index asc), at most k of them. Accepted
// candidates are inserted one at a time at their rank.
__device__ __forceinline__ void warp_offer(float* lv, int* li, int& n, int k,
                                           float v, int i, bool valid) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool want =
      valid && v > DEAD && (n < k || ranks_before(v, i, lv[k - 1], li[k - 1]));
  unsigned pending = __ballot_sync(full, want);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const float cv = __shfl_sync(full, v, src);
    const int ci = __shfl_sync(full, i, src);
    // the k-th entry may have risen since the ballot
    if (n == k && !ranks_before(cv, ci, lv[k - 1], li[k - 1])) continue;
    const int e0 = lane, e1 = lane + 32;
    float v0 = 0.f, v1 = 0.f;
    int i0 = 0, i1 = 0;
    if (e0 < n) { v0 = lv[e0]; i0 = li[e0]; }
    if (e1 < n) { v1 = lv[e1]; i1 = li[e1]; }
    const int pos =
        __popc(__ballot_sync(full, e0 < n && ranks_before(v0, i0, cv, ci))) +
        __popc(__ballot_sync(full, e1 < n && ranks_before(v1, i1, cv, ci)));
    const int nn = n < k ? n + 1 : k;
    __syncwarp();
    // entries pos .. nn-2 move down one slot; the last one drops when full
    if (e0 >= pos && e0 + 1 < nn) { lv[e0 + 1] = v0; li[e0 + 1] = i0; }
    if (e1 >= pos && e1 + 1 < nn) { lv[e1 + 1] = v1; li[e1 + 1] = i1; }
    if (lane == 0) { lv[pos] = cv; li[pos] = ci; }
    __syncwarp();
    n = nn;
  }
}

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
    for (int e = lane; e < K; e += 32) {
      part_v[base + e] = e < n ? lv[qq * KMAX + e] : NEG;
      part_i[base + e] = e < n ? li[qq * KMAX + e] : 0;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
             int B, int K, int n_chunks, float* __restrict__ out_v,
             int* __restrict__ out_i) {
  __shared__ float lv[WARPS][KMAX];
  __shared__ int li[WARPS][KMAX];
  __shared__ int cnt[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;

  int n = 0;
  for (int c = warp; c < n_chunks; c += WARPS) {
    const long long base = ((long long)c * B + b) * K;
    for (int e0 = 0; e0 < K; e0 += 32) {
      const int e = e0 + lane;
      const bool valid = e < K;
      warp_offer(lv[warp], li[warp], n, K, valid ? part_v[base + e] : NEG,
                 valid ? part_i[base + e] : 0, valid);
    }
  }
  if (lane == 0) cnt[warp] = n;
  __syncthreads();
  if (warp != 0) return;

  for (int w = 1; w < WARPS; ++w) {
    const int m = cnt[w];
    for (int e0 = 0; e0 < m; e0 += 32) {
      const int e = e0 + lane;
      const bool valid = e < m;
      warp_offer(lv[0], li[0], n, K, valid ? lv[w][e] : NEG,
                 valid ? li[w][e] : 0, valid);
    }
  }
  for (int e = lane; e < K; e += 32) {
    out_v[(long long)b * K + e] = e < n ? lv[0][e] : NEG;
    out_i[(long long)b * K + e] = e < n ? li[0][e] : 0;
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
      n_chunks, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
