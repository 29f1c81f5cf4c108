// topk_common.cuh — the selection half shared by the top-K scan kernels
// (topk_int8.cu, topk_float.cu): a warp's bitonic network over 64 entries
// held in registers; the one selection both scans run after their epilogue
// (a per-query running list in registers, fed through a buffer in shared
// memory, and the write-out of a chunk's list); and the per-query merge pass
// over the chunks' lists.
//
// Order: value descending, the lower row index first on ties. A candidate
// scoring <= NEG/2 is never kept, and unfilled slots are written as
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

constexpr int LIST = 64;  // entries of a running list and of its buffer (two a lane)
static_assert(KMAX <= LIST, "a list holds K entries");

// A query's running list of the LIST best entries seen, sorted by (value
// desc, row asc), held by one warp in registers: entry e is x[e / 32] of
// lane e % 32.
struct WarpList {
  Entry x[2] = {{-INFINITY, NO_ROW}, {-INFINITY, NO_ROW}};
};

// The buffered candidates (n of them, in `bv`/`bi`) merged into the list:
// the buffer is sorted descending, its reverse met entry by entry with the
// list (the better of each pair is the best 64 of both, in a bitonic
// order), and that sorted. Exact: the order is a total one on (value, row).
__device__ __forceinline__ void flush(WarpList& L, const float* bv, const int* bi, int n) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the buffer's entries are written
  Entry c[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = lane + 32 * r;
    c[r] = e < n ? Entry{bv[e], bi[e]} : Entry{-INFINITY, NO_ROW};
  }
  __syncwarp();  // read before the buffer is refilled
#pragma unroll
  for (int size = 2; size <= LIST; size <<= 1)
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) bitonic_step(c, size, j);
  merge_sorted(L.x, c);
}

// The value a score must beat to enter the list's first k: its k-th entry's
// once there are k, else DEAD. Within a chunk rows come in increasing
// order, so a later score equal to it ranks after it: the test is exact.
__device__ __forceinline__ float list_kth(const WarpList& L, int k) {
  const float v = __shfl_sync(0xffffffffu, k - 1 < 32 ? L.x[0].v : L.x[1].v, (k - 1) & 31);
  return fmaxf(v, DEAD);
}

// The selection of a scan block of 4 * SEL_WARPS queries over its chunk:
// warp w selects for queries 4w .. 4w + 3 of the block. For each it keeps
// the running list, the value a score must beat to be a candidate (the
// list's k-th, in a register) and how many candidates wait in the query's
// buffer of LIST in shared memory (`buf_v`/`buf_i`: [4 * SEL_WARPS][LIST]).
// `live` is how many of the block's queries exist (B - q0); the others are
// never selected for.
struct WarpSelect {
  WarpList list[4];
  float kth[4] = {DEAD, DEAD, DEAD, DEAD};
  int waiting[4] = {0, 0, 0, 0};

  // One tile's scores, query qq's row r at st[qq * STRIDE + r], for rows
  // tile .. tile + TN - 1 (a row past the chunk scores NEG). Each warp reads
  // its queries' scores and votes, a 32-row group at a time, which beat the
  // query's k-th value (the Pallas kernel's needs_merge test: once a list is
  // full, most tiles stop at these votes). The winners are appended to the
  // query's buffer in row order, all at once where the buffer has room for
  // them; else a group at a time, a full buffer merged into the list first,
  // which raises the k-th value.
  template <int TN, int STRIDE>
  __device__ __forceinline__ void offer(const float* st, float* buf_v, int* buf_i, long long tile,
                                        int live, int k) {
    constexpr int GROUPS = TN / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1;  // the lanes before this one
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int qq = warp * 4 + b;
      if (qq >= live) break;  // the same in every lane of the warp
      const float* srow = st + qq * STRIDE;
      float vs[GROUPS];
      unsigned wins[GROUPS];
      int total = 0;
#pragma unroll
      for (int a = 0; a < GROUPS; ++a) {
        vs[a] = srow[lane + 32 * a];
        wins[a] = __ballot_sync(0xffffffffu, vs[a] > kth[b]);
        total += __popc(wins[a]);
      }
      if (total == 0) continue;
      float* bv = buf_v + qq * LIST;
      int* bi = buf_i + qq * LIST;
      if (waiting[b] + total <= LIST) {
#pragma unroll
        for (int a = 0; a < GROUPS; ++a) {
          if (wins[a] >> lane & 1) {
            const int slot = waiting[b] + __popc(wins[a] & below);
            bv[slot] = vs[a];
            bi[slot] = static_cast<int>(tile + lane + 32 * a);
          }
          waiting[b] += __popc(wins[a]);
        }
        continue;
      }
#pragma unroll 1
      for (int a = 0; a < GROUPS; ++a) {
        const float va = srow[lane + 32 * a];
        unsigned win = __ballot_sync(0xffffffffu, va > kth[b]);
        if (waiting[b] + __popc(win) > LIST) {  // no room: merge the buffer first
          flush(list[b], bv, bi, waiting[b]);
          kth[b] = list_kth(list[b], k);
          waiting[b] = 0;
          win = __ballot_sync(0xffffffffu, va > kth[b]);
        }
        if (win >> lane & 1) {
          const int slot = waiting[b] + __popc(win & below);
          bv[slot] = va;
          bi[slot] = static_cast<int>(tile + lane + 32 * a);
        }
        waiting[b] += __popc(win);
      }
    }
  }

  // The chunk's lists, after its last tile: what still waits is merged, and
  // query qq's first k entries go to part_v/part_i + (first + qq) * k, dead
  // ones as (NEG, 0). `first` is the row of the block's query 0 in the
  // [chunks * B] lists.
  __device__ __forceinline__ void write(const float* buf_v, const int* buf_i, int live, int k,
                                        long long first, float* part_v, int* part_i) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int qq = warp * 4 + b;
      if (qq >= live) break;
      if (waiting[b] > 0) flush(list[b], buf_v + qq * LIST, buf_i + qq * LIST, waiting[b]);
      const long long base = (first + qq) * k;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = lane + 32 * r;
        const Entry x = list[b].x[r];
        if (e < k) {
          part_v[base + e] = x.v > DEAD ? x.v : NEG;
          part_i[base + e] = x.v > DEAD ? x.i : 0;
        }
      }
    }
  }
};

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
