// topk_float_tile.cuh — the score pass shared by the float scan kernels
// (topk_float.cu, which selects a top-K from the scores, and topk_floor.cu,
// which only keeps a running maximum): tile sizes, the staging of 16-byte
// loads into shared memory as f32, and the 4-row x 4-query register tile of
// fused multiply-adds over one 128-row tile of the corpus.
//
// Every row's score comes from the same instruction sequence wherever the
// row sits in a tile or chunk and whichever kernel asks, so the two kernels'
// scores are bit-equal.

#pragma once

#include "topk_common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int TB = 32;         // queries per pass-1 block
constexpr int TN = 128;        // rows per pass-1 tile
constexpr int DC = 32;         // dimensions staged per step
constexpr int CW = DC + 4;     // floats per staged row; the 4 padding floats
                               // make the 16-byte shared reads conflict-free
constexpr int THREADS = SEL_THREADS;

enum Mode { FP32 = 0, BF16 = 1, F32X2 = 2 };

// Elements per 16-byte load, and their widening to f32.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static void widen(const float* src, float* dst) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void widen(const __nv_bfloat16* src, float* dst) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // little-endian: element 2j is the low half
      dst[2 * j] = __uint_as_float(w[j] << 16);
      dst[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};

// rows [first, first + rows) of `src` (row stride `stride` elements),
// columns [col, col + DC), widened into dst[rows][CW]; rows at or past `end`
// are zero.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src,
                                      long long stride, long long first,
                                      long long end, int rows, int col,
                                      float* dst) {
  constexpr int E = Chunk<T>::N, PER_ROW = DC / E;
  for (int v = threadIdx.x; v < rows * PER_ROW; v += THREADS) {
    const int r = v / PER_ROW, c = (v % PER_ROW) * E;
    float* out = dst + r * CW + c;
    if (first + r < end) {
      Chunk<T>::widen(src + (first + r) * stride + col + c, out);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) out[j] = 0.f;
    }
  }
}

// Shared memory the score pass needs, in floats: the corpus slabs
// [PLANES][TN][CW] at `cs` and the query slabs [PLANES][TB][CW] at `qs`.
template <bool COMP>
constexpr int tile_floats() { return (COMP ? 2 : 1) * (TN + TB) * CW; }

// The dots of rows [tile, tile + TN) of the corpus (rows at or past row_end
// count as zero rows) against queries [q0, q0 + TB): thread (lane, warp)
// forms rows lane + 32*a against queries 4*warp + b, in d order. With COMP
// the three partial sums of the compensated bf16x2 dot: hi.hi in acc, hi.lo
// in acc_hl, lo.hi in acc_lh. Every thread of the block calls this; it
// ends on a __syncthreads().
template <typename T, bool COMP>
__device__ __forceinline__ void score_tile(
    const T* __restrict__ q, const T* __restrict__ corpus, long long W,
    long long tile, long long row_end, int q0, int B, int D, float* cs,
    float* qs, float (&acc)[4][4], float (&acc_hl)[4][4],
    float (&acc_lh)[4][4]) {
  constexpr int PLANES = COMP ? 2 : 1;     // hi (and lo) slabs
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = acc_hl[a][b] = acc_lh[a][b] = 0.f;

  for (int d0 = 0; d0 < D; d0 += DC) {
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      stage<T>(corpus, W, tile, row_end, TN, d0 + p * D, cs + p * TN * CW);
      stage<T>(q, W, q0, B, TB, d0 + p * D, qs + p * TB * CW);
    }
    __syncthreads();
    const float* qbase = qs + (warp * 4) * CW;
#pragma unroll 2
    for (int w = 0; w < DC; w += 4) {
      float4 ch[4], qh[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        ch[a] = *reinterpret_cast<const float4*>(cs + (lane + 32 * a) * CW + w);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        qh[b] = *reinterpret_cast<const float4*>(qbase + b * CW + w);
      if constexpr (COMP) {
        float4 cl[4], ql[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          cl[a] = *reinterpret_cast<const float4*>(cs + TN * CW + (lane + 32 * a) * CW + w);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          ql[b] = *reinterpret_cast<const float4*>(qbase + TB * CW + b * CW + w);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            acc[a][b] = __fmaf_rn(qh[b].x, ch[a].x, acc[a][b]);
            acc[a][b] = __fmaf_rn(qh[b].y, ch[a].y, acc[a][b]);
            acc[a][b] = __fmaf_rn(qh[b].z, ch[a].z, acc[a][b]);
            acc[a][b] = __fmaf_rn(qh[b].w, ch[a].w, acc[a][b]);
            acc_hl[a][b] = __fmaf_rn(qh[b].x, cl[a].x, acc_hl[a][b]);
            acc_hl[a][b] = __fmaf_rn(qh[b].y, cl[a].y, acc_hl[a][b]);
            acc_hl[a][b] = __fmaf_rn(qh[b].z, cl[a].z, acc_hl[a][b]);
            acc_hl[a][b] = __fmaf_rn(qh[b].w, cl[a].w, acc_hl[a][b]);
            acc_lh[a][b] = __fmaf_rn(ql[b].x, ch[a].x, acc_lh[a][b]);
            acc_lh[a][b] = __fmaf_rn(ql[b].y, ch[a].y, acc_lh[a][b]);
            acc_lh[a][b] = __fmaf_rn(ql[b].z, ch[a].z, acc_lh[a][b]);
            acc_lh[a][b] = __fmaf_rn(ql[b].w, ch[a].w, acc_lh[a][b]);
          }
      } else {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            acc[a][b] = __fmaf_rn(qh[b].x, ch[a].x, acc[a][b]);
            acc[a][b] = __fmaf_rn(qh[b].y, ch[a].y, acc[a][b]);
            acc[a][b] = __fmaf_rn(qh[b].z, ch[a].z, acc[a][b]);
            acc[a][b] = __fmaf_rn(qh[b].w, ch[a].w, acc[a][b]);
          }
      }
    }
    __syncthreads();
  }
}

// One score from its partial sums: (hi.hi + hi.lo) + lo.hi, each sum rounded
// alone (the Pallas _dot_compensated); the plain dot without COMP.
template <bool COMP>
__device__ __forceinline__ float tile_dot(float hh, float hl, float lh) {
  if constexpr (COMP) return __fadd_rn(__fadd_rn(hh, hl), lh);
  return hh;
}

}  // namespace
