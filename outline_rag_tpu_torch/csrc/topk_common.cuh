// topk_common.cuh — the selection half shared by the top-K scan kernels
// (topk_int8.cu, topk_float.cu): the warp insertion into a sorted running
// top-K list in shared memory, the write-out of a chunk's list, and the
// per-query merge pass over the chunks' lists.
//
// Order: value descending, the lower row index first on ties. A candidate
// scoring <= NEG/2 is never inserted, and unfilled slots are written as
// (NEG, 0), exactly as the Pallas kernel emits them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KMAX = 64;
constexpr int SEL_THREADS = 256;
constexpr int SEL_WARPS = SEL_THREADS / 32;
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

// One warp writes a list of n entries as K slots at out + e * stride,
// unfilled slots as (NEG, 0).
__device__ __forceinline__ void warp_write(const float* lv, const int* li,
                                           int n, int k, float* out_v,
                                           int* out_i, long long stride) {
  for (int e = threadIdx.x & 31; e < k; e += 32) {
    out_v[e * stride] = e < n ? lv[e] : NEG;
    out_i[e * stride] = e < n ? li[e] : 0;
  }
}

// Pass 2: one block per query merges the chunks' partial lists
// ([n_chunks, B, K]) with the same warp insertion, then merges the eight
// warp lists. The result goes out as [B, K], or as [K, B] when
// `transposed` (the column-major output of the Pallas cmajor kernel).
__global__ void __launch_bounds__(SEL_THREADS)
merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
             int B, int K, int n_chunks, int transposed,
             float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float lv[SEL_WARPS][KMAX];
  __shared__ int li[SEL_WARPS][KMAX];
  __shared__ int cnt[SEL_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;

  int n = 0;
  for (int c = warp; c < n_chunks; c += SEL_WARPS) {
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

  for (int w = 1; w < SEL_WARPS; ++w) {
    const int m = cnt[w];
    for (int e0 = 0; e0 < m; e0 += 32) {
      const int e = e0 + lane;
      const bool valid = e < m;
      warp_offer(lv[0], li[0], n, K, valid ? lv[w][e] : NEG,
                 valid ? li[w][e] : 0, valid);
    }
  }
  if (transposed)
    warp_write(lv[0], li[0], n, K, out_v + b, out_i + b, B);
  else
    warp_write(lv[0], li[0], n, K, out_v + (long long)b * K,
               out_i + (long long)b * K, 1);
}

}  // namespace
