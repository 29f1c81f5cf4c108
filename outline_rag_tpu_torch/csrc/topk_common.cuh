// topk_common.cuh — the selection half shared by the top-K scan kernels
// (topk_int8.cu, topk_float.cu): the warp insertion into a sorted running
// top-K list in shared memory and the write-out of a chunk's list (the int8
// scan), a warp's bitonic network over 64 entries held in registers (the
// float scan's lists), and the per-query merge pass over the chunks' lists.
//
// Order: value descending, the lower row index first on ties. A candidate
// scoring <= NEG/2 is never inserted, and unfilled slots are written as
// (NEG, 0), exactly as the Pallas kernel emits them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
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

// An entry of a list: a score and its row. Empty entries are (-inf, INT_MAX)
// and rank after every real one.
struct Entry {
  float v;
  int i;
};
constexpr int NO_ROW = 0x7fffffff;

__device__ __forceinline__ bool better(const Entry& a, const Entry& b) {
  return ranks_before(a.v, a.i, b.v, b.i);
}
__device__ __forceinline__ Entry shfl_xor(const Entry& e, int m) {
  return {__shfl_xor_sync(0xffffffffu, e.v, m), __shfl_xor_sync(0xffffffffu, e.i, m)};
}
__device__ __forceinline__ Entry shfl_from(const Entry& e, int lane) {
  return {__shfl_sync(0xffffffffu, e.v, lane), __shfl_sync(0xffffffffu, e.i, lane)};
}

// One step of a bitonic network over the 64 entries: entry e meets entry
// e ^ j and keeps the better of the two if e < e ^ j and its block of
// `size` runs descending (e & size == 0), else the worse.
__device__ __forceinline__ void bitonic_step(Entry (&x)[2], int size, int j) {
  const int lane = threadIdx.x & 31;
  if (j == 32) {  // entries lane and lane + 32, in one block of 64 or more: descending
    if (better(x[1], x[0])) {
      const Entry t = x[0];
      x[0] = x[1];
      x[1] = t;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = lane + 32 * r;
    const Entry o = shfl_xor(x[r], j);
    const bool keep_better = ((e & j) == 0) == ((e & size) == 0);
    x[r] = better(x[r], o) == keep_better ? x[r] : o;
  }
}

// The better 64 of two lists of 64 entries held as above, each sorted
// descending: entry e of one meets entry 63 - e of the other (x[0] of lane
// l meets y[1] of lane 31 - l), the better of each pair is the best 64 of
// both in a bitonic order, and that is sorted.
__device__ __forceinline__ void merge_sorted(Entry (&x)[2], const Entry (&y)[2]) {
  const int lane = threadIdx.x & 31;
  const Entry r1 = shfl_from(y[1], 31 - lane), r0 = shfl_from(y[0], 31 - lane);
  if (better(r1, x[0])) x[0] = r1;
  if (better(r0, x[1])) x[1] = r0;
#pragma unroll
  for (int j = 32; j > 0; j >>= 1) bitonic_step(x, 128, j);
}

// Entry e (< k) of a chunk's sorted list of k at v/i; a dead or missing slot
// is empty.
__device__ __forceinline__ Entry list_entry(const float* v, const int* i, int e, int k) {
  if (e >= k) return {-INFINITY, NO_ROW};
  const float x = v[e];
  return x > DEAD ? Entry{x, i[e]} : Entry{-INFINITY, NO_ROW};
}

// Pass 2: one block per query merges the chunks' partial lists ([n_chunks,
// B, K], each sorted by (value desc, row asc), dead slots (NEG, 0)): warp w
// merges chunks w, w + 8, ... into a sorted list of 64 in registers, one
// bitonic merge a chunk, and warp 0 merges the eight warp lists. The result
// goes out as [B, K], or as [K, B] when `transposed` (the column-major
// output of the Pallas cmajor kernel). The merge is exact, so the result does
// not depend on the order of the chunks.
__global__ void __launch_bounds__(SEL_THREADS)
merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
             int B, int K, int n_chunks, int transposed,
             float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ Entry lists[SEL_WARPS][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;

  Entry x[2] = {{-INFINITY, NO_ROW}, {-INFINITY, NO_ROW}}, y[2];
  auto load = [&](int c, Entry (&to)[2]) {
    const long long base = ((long long)c * B + b) * K;
#pragma unroll
    for (int r = 0; r < 2; ++r) to[r] = list_entry(part_v + base, part_i + base, lane + 32 * r, K);
  };
  if (warp < n_chunks) load(warp, y);
  for (int c = warp; c < n_chunks; c += SEL_WARPS) {
    Entry next[2] = {{-INFINITY, NO_ROW}, {-INFINITY, NO_ROW}};
    if (c + SEL_WARPS < n_chunks) load(c + SEL_WARPS, next);  // in flight during the merge
    merge_sorted(x, y);
    y[0] = next[0];
    y[1] = next[1];
  }
  lists[warp][lane] = x[0];
  lists[warp][lane + 32] = x[1];
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < SEL_WARPS; ++w) {
    y[0] = lists[w][lane];
    y[1] = lists[w][lane + 32];
    merge_sorted(x, y);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = lane + 32 * r;
    if (e >= K) continue;
    const bool live = x[r].v > DEAD;
    const long long at = transposed ? (long long)e * B + b : (long long)b * K + e;
    out_v[at] = live ? x[r].v : NEG;
    out_i[at] = live ? x[r].i : 0;
  }
}

}  // namespace
