// topk_float_tile.cuh — the score pass shared by the scan kernels
// (topk_float.cu and topk_int8.cu, which select a top-K from the scores, and
// topk_floor.cu, which only keeps a running maximum): the per-mode tile
// shapes, the ring of shared-memory slabs fed by cp.async in the storage
// type, and the products of one tile of corpus rows against the block's
// queries.
//
//   bf16, f32x2: mma.sync.m16n8k16 (bf16 x bf16 -> f32) fed by ldmatrix. The
//     corpus tile is the A operand ([rows, d] as stored), the queries the B
//     operand ([B, d] row-major is B's column-major). Warp w owns the 16 rows
//     16w .. 16w + 15 of a 128-row tile against all 32 queries (four n8
//     tiles). Each 64-dimension slab's hi.hi sums start from zero and are
//     added to the running sum with one rounded add (__fadd_rn), so the
//     tensor core's truncating accumulation only ever sees a slab's partial
//     sum; f32x2's hi.lo and lo.hi sums (2^-8 of the score) run on the tensor
//     core over all of D.
//   int8: mma.sync.m16n8k32 (s8 x s8 -> s32) fed by ldmatrix, laid out as
//     bf16's: a 16-row x 32-byte A fragment and an 8-query x 32-byte B
//     fragment have bf16's byte addresses, so warp w owns rows 16w .. 16w +
//     15 of a 128-row tile against the 32 queries, in four n8 tiles of int32
//     sums. Slabs are 128 bytes (four 32-byte k-steps); a D with D % 32 ==
//     16 multiplies a last half k-step of zero-filled bytes. The int32 sums
//     are exact (|sum| <= 127^2 D), so they need no per-slab fold and equal
//     the plain version's whatever the order.
//   fp32: true fp32 fused multiply-adds on the CUDA cores in d order (no
//     TF32: the Precision.HIGHEST rule). A thread forms 4 rows x 8 queries of
//     a 256-row tile: its rows are its own, its queries the same in every
//     lane of the warp, so the query reads are broadcasts and one 4-dimension
//     step costs a warp 4 + 8 = 12 shared-memory wavefronts for 128 FMAs.
//
// Every output element sums its products in one order fixed by d alone,
// wherever its row sits in a fragment, warp, tile or chunk and whichever
// kernel asks, so duplicated rows tie bit for bit and the two kernels'
// scores are bit-equal.

#pragma once

#include "hopper_tma.cuh"
#include "topk_common.cuh"

#include <cuda_bf16.h>

namespace {

enum Mode { FP32 = 0, BF16 = 1, F32X2 = 2, INT8 = 3 };

constexpr int THREADS = SEL_THREADS;  // 8 warps
constexpr int TB = 32;                // queries a block
constexpr int STAGES = 3;             // slabs in the ring
constexpr int DSTEP = 32;             // D must be a multiple
constexpr int CHUNK_ROWS = 256;       // a chunk is a whole number of these
constexpr int STW = 4;                // padding of a query's row of scores

template <int MODE> struct Shape;
template <> struct Shape<FP32> {
  using T = float;
  static constexpr int TN = 256;      // rows a tile
  static constexpr int DC = 32;       // dimensions a slab
  static constexpr int PLANES = 1;
  static constexpr int MIN_BLOCKS = 1;  // resident blocks an SM (shared memory)
};
template <> struct Shape<BF16> {
  using T = __nv_bfloat16;
  static constexpr int TN = 128;
  static constexpr int DC = 64;
  static constexpr int PLANES = 1;
  static constexpr int MIN_BLOCKS = 2;
};
template <> struct Shape<F32X2> {
  using T = __nv_bfloat16;
  static constexpr int TN = 128;
  static constexpr int DC = 64;
  static constexpr int PLANES = 2;    // hi, lo
  static constexpr int MIN_BLOCKS = 1;
};
template <> struct Shape<INT8> {
  using T = int8_t;
  static constexpr int TN = 128;
  static constexpr int DC = 128;      // bytes: four 32-byte k-steps
  static constexpr int PLANES = 1;
  static constexpr int MIN_BLOCKS = 2;
};

// A staged row: a slab's bytes of one row and 16 of padding, so that the
// 16-byte reads of 8 rows hit all 32 banks; 16-byte pieces a row.
template <int MODE>
__host__ __device__ constexpr int row_bytes() {
  return Shape<MODE>::DC * sizeof(typename Shape<MODE>::T) + 16;
}
template <int MODE>
__host__ __device__ constexpr int pieces() { return Shape<MODE>::DC * sizeof(typename Shape<MODE>::T) / 16; }
// Bytes of one ring slot: per plane, TN corpus rows then TB query rows.
template <int MODE>
__host__ __device__ constexpr int slot_bytes() {
  return Shape<MODE>::PLANES * (Shape<MODE>::TN + TB) * row_bytes<MODE>();
}
template <int MODE>
__host__ __device__ constexpr int ring_bytes() { return STAGES * slot_bytes<MODE>(); }

static_assert(CHUNK_ROWS % Shape<FP32>::TN == 0 && CHUNK_ROWS % Shape<BF16>::TN == 0 &&
                  CHUNK_ROWS % Shape<INT8>::TN == 0, "tiles");
static_assert(Shape<BF16>::TN == 16 * (THREADS / 32) && Shape<INT8>::TN == 16 * (THREADS / 32),
              "a warp owns 16 rows");
static_assert(TB == 4 * SEL_WARPS, "a warp selects for 4 queries");

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_16832_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where the outputs of an m16n8 tensor-core tile lie: warp w's rows 16w ..
// 16w + 15 against four n8 tiles of queries, four outputs a tile a thread.
struct MmaPlace {
  // f(i, row in the tile, query in the block) for each output i of this thread
  template <typename F>
  static __device__ __forceinline__ void place(F&& f) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      f(i, 16 * warp + g + 8 * ((i & 3) >> 1), 8 * (i >> 2) + 2 * t + (i & 1));
  }
  static constexpr int OUTPUTS = 16;
};

// ldmatrix row addresses in a slot of MODE: A, rows 16w + (lane & 15), k
// half lane >> 4; B, for n8 tiles (2p, 2p + 1): query 16p + 8 (lane >> 4) +
// (lane & 7), k half (lane >> 3) & 1 (a k half is 16 bytes)
template <int MODE>
__device__ __forceinline__ const unsigned char* a_rows(const unsigned char* slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return slot + (16 * warp + (lane & 15)) * row_bytes<MODE>() + (lane >> 4) * 16;
}
template <int MODE>
__device__ __forceinline__ const unsigned char* b_rows(const unsigned char* slot) {
  const int lane = threadIdx.x & 31;
  return slot + (Shape<MODE>::TN + 8 * (lane >> 4) + (lane & 7)) * row_bytes<MODE>() +
         ((lane >> 3) & 1) * 16;
}

// What the score pass hands a block: its operands and its rows.
template <int MODE>
struct Scan {
  using T = typename Shape<MODE>::T;
  const T* q;
  const T* corpus;
  int B, D, q0;
  long long row_begin, row_end;
};

// The sums of one tile and where each of this thread's outputs lies: visit
// calls f(i, row in the tile, query in the block, dot) for each output i.
template <int MODE, bool MMA = (MODE != FP32)>
struct Acc;

template <int MODE>
struct Acc<MODE, true> : MmaPlace {
  static constexpr bool COMP = MODE == F32X2;
  float hh[4][4], run[4][4], hl[4][4], lh[4][4];  // [n8 tile][fragment element]

  __device__ __forceinline__ void start_tile() {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[j][e] = hl[j][e] = lh[j][e] = 0.f;
  }
  __device__ __forceinline__ void start_slab() {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hh[j][e] = 0.f;
  }
  __device__ __forceinline__ void end_slab() {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[j][e] = __fadd_rn(run[j][e], hh[j][e]);
  }

  // ksteps 16-dimension steps of the slab in `slot`
  __device__ __forceinline__ void product(const unsigned char* slot, int ksteps) {
    constexpr int TN = Shape<MODE>::TN, ROW_BYTES = row_bytes<MODE>();
    const unsigned char* a_row = a_rows<MODE>(slot);
    const unsigned char* b_row = b_rows<MODE>(slot);
    constexpr int PLANE = (TN + TB) * ROW_BYTES;
#pragma unroll
    for (int s = 0; s < Shape<MODE>::DC / 16; ++s) {
      if (s < ksteps) {
        uint32_t a[4], b[2][4];
        ldmatrix_x4(a, a_row + 32 * s);
        ldmatrix_x4(b[0], b_row + 32 * s);
        ldmatrix_x4(b[1], b_row + 16 * ROW_BYTES + 32 * s);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_16816(hh[j], a, b[j >> 1][2 * (j & 1)], b[j >> 1][2 * (j & 1) + 1]);
        if constexpr (COMP) {
          uint32_t al[4], bl[2][4];
          ldmatrix_x4(al, a_row + PLANE + 32 * s);
          ldmatrix_x4(bl[0], b_row + PLANE + 32 * s);
          ldmatrix_x4(bl[1], b_row + PLANE + 16 * ROW_BYTES + 32 * s);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // hi.lo: query hi against corpus lo; lo.hi: query lo against corpus hi
            mma_16816(hl[j], al, b[j >> 1][2 * (j & 1)], b[j >> 1][2 * (j & 1) + 1]);
            mma_16816(lh[j], a, bl[j >> 1][2 * (j & 1)], bl[j >> 1][2 * (j & 1) + 1]);
          }
        }
      }
    }
  }

  // One score from its partial sums: (hi.hi + hi.lo) + lo.hi, each sum
  // rounded alone (the Pallas _dot_compensated); the plain dot otherwise.
  __device__ __forceinline__ float dot(int i) const {
    const int j = i >> 2, e = i & 3;
    return COMP ? __fadd_rn(__fadd_rn(run[j][e], hl[j][e]), lh[j][e]) : run[j][e];
  }
  template <typename F>
  __device__ __forceinline__ void visit(F&& f) const {
    place([&](int i, int r, int qq) { f(i, r, qq, dot(i)); });
  }
};

// int8: exact int32 sums over all of D, handed to the epilogue as they are.
template <>
struct Acc<INT8, true> : MmaPlace {
  int acc[4][4];  // [n8 tile][fragment element]

  __device__ __forceinline__ void start_tile() {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  }
  __device__ __forceinline__ void start_slab() {}
  __device__ __forceinline__ void end_slab() {}

  // the slab in `slot` up to its n16-th 16-byte piece: 32-byte k-steps, a
  // last odd piece met by the zero-filled piece after it
  __device__ __forceinline__ void product(const unsigned char* slot, int n16) {
    constexpr int ROW_BYTES = row_bytes<INT8>();
    const unsigned char* a_row = a_rows<INT8>(slot);
    const unsigned char* b_row = b_rows<INT8>(slot);
    const int ksteps = (n16 + 1) >> 1;
#pragma unroll
    for (int s = 0; s < Shape<INT8>::DC / 32; ++s) {
      if (s < ksteps) {
        uint32_t a[4], b[2][4];
        ldmatrix_x4(a, a_row + 32 * s);
        ldmatrix_x4(b[0], b_row + 32 * s);
        ldmatrix_x4(b[1], b_row + 16 * ROW_BYTES + 32 * s);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_16832_s8(acc[j], a, b[j >> 1][2 * (j & 1)], b[j >> 1][2 * (j & 1) + 1]);
      }
    }
  }

  template <typename F>
  __device__ __forceinline__ void visit(F&& f) const {
    place([&](int i, int r, int qq) { f(i, r, qq, acc[i >> 2][i & 3]); });
  }
};

template <int MODE>
struct Acc<MODE, false> {
  float acc[4][8];  // rows (warp >> 2) * 128 + lane + 32a, queries 8 (warp & 3) + b

  __device__ __forceinline__ void start_tile() {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  }
  __device__ __forceinline__ void start_slab() {}
  __device__ __forceinline__ void end_slab() {}

  __device__ __forceinline__ void product(const unsigned char* slot, int) {
    constexpr int TN = Shape<FP32>::TN, ROW_BYTES = row_bytes<FP32>();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float* rows = reinterpret_cast<const float*>(slot + ((warp >> 2) * 128 + lane) * ROW_BYTES);
    const float* qs = reinterpret_cast<const float*>(slot + (TN + 8 * (warp & 3)) * ROW_BYTES);
    constexpr int RF = 32 * ROW_BYTES / 4, QF = ROW_BYTES / 4;  // floats between rows a, queries b
#pragma unroll
    for (int w = 0; w < Shape<FP32>::DC; w += 4) {
      float4 c[4], qv[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) c[a] = *reinterpret_cast<const float4*>(rows + a * RF + w);
#pragma unroll
      for (int b = 0; b < 8; ++b) qv[b] = *reinterpret_cast<const float4*>(qs + b * QF + w);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          acc[a][b] = __fmaf_rn(qv[b].x, c[a].x, acc[a][b]);
          acc[a][b] = __fmaf_rn(qv[b].y, c[a].y, acc[a][b]);
          acc[a][b] = __fmaf_rn(qv[b].z, c[a].z, acc[a][b]);
          acc[a][b] = __fmaf_rn(qv[b].w, c[a].w, acc[a][b]);
        }
    }
  }

  __device__ __forceinline__ float dot(int i) const { return acc[i >> 3][i & 7]; }
  template <typename F>
  static __device__ __forceinline__ void place(F&& f) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < 32; ++i) f(i, (warp >> 2) * 128 + lane + 32 * (i >> 3), 8 * (warp & 3) + (i & 7));
  }
  static constexpr int OUTPUTS = 32;
  template <typename F>
  __device__ __forceinline__ void visit(F&& f) const {
    place([&](int i, int r, int qq) { f(i, r, qq, dot(i)); });
  }
};

// The slab of the tile from row `row0`, dimensions d0 .. d0 + DC, into
// `slot`: each 16-byte piece by cp.async; rows at or past row_end, queries at
// or past B and dimensions at or past D are zero-filled. Every thread commits
// one group, whether it copied anything or not.
template <int MODE>
__device__ __forceinline__ void request(const Scan<MODE>& sc, long long row0, int d0,
                                        unsigned char* slot) {
  using S = Shape<MODE>;
  using T = typename S::T;
  constexpr int E = 16 / sizeof(T), P = pieces<MODE>();  // elements a piece, pieces a row
  const long long W = S::PLANES * (long long)sc.D;  // stored row width
#pragma unroll
  for (int v0 = 0; v0 < S::PLANES * (S::TN + TB) * P; v0 += THREADS) {
    const int v = v0 + threadIdx.x;
    if (v < S::PLANES * (S::TN + TB) * P) {
      const int p = v / ((S::TN + TB) * P), r = (v / P) % (S::TN + TB), c = v % P;
      const int col = d0 + c * E;
      const bool corpus_row = r < S::TN;
      const long long row = corpus_row ? row0 + r : sc.q0 + (r - S::TN);
      const bool live = col < sc.D && (corpus_row ? row < sc.row_end : row < sc.B);
      const T* base = corpus_row ? sc.corpus : sc.q;
      const T* src = live ? base + row * W + p * sc.D + col : base;
      cp_async16(slot + (p * (S::TN + TB) + r) * row_bytes<MODE>() + c * 16, src, live);
    }
  }
  cp_async_commit();
}

// The next slab of a walk: the tile's next dimensions, or the next tile.
template <int MODE>
__device__ __forceinline__ void advance(int& ds, long long& row0, int slabs) {
  if (++ds == slabs) {
    ds = 0;
    row0 += Shape<MODE>::TN;
  }
}

// The score pass over rows [row_begin, row_end): the block walks its tiles
// slab by slab through a ring of STAGES slots, up to STAGES - 1 slabs in
// flight, and calls epilogue(first row of the tile, acc) after each tile's
// last slab (every thread of the block calls this; `ring` holds
// ring_bytes<MODE>()). The first slab is read right after the prologue asks
// for it, so a wait one group short reads a slot before it has landed.
template <int MODE, typename Epilogue>
__device__ __forceinline__ void score_rows(const Scan<MODE>& sc, unsigned char* ring,
                                           Epilogue&& epilogue) {
  using S = Shape<MODE>;
  const int slabs = (sc.D + S::DC - 1) / S::DC;
  const long long tiles = (sc.row_end - sc.row_begin + S::TN - 1) / S::TN;
  const long long total = tiles * slabs;
  Acc<MODE> acc;
  int ds = 0, next_ds = 0;  // the slab within its tile: computed next, requested next
  long long tile = sc.row_begin, next_tile = sc.row_begin;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) {
      request(sc, next_tile, next_ds * S::DC, ring + s * slot_bytes<MODE>());
      advance<MODE>(next_ds, next_tile, slabs);
    } else {
      cp_async_commit();
    }
  }
  int slot = 0;  // of slab s; slab s + STAGES - 1 goes to the slot before it
#pragma unroll 1
  for (long long s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slab s are there
    __syncthreads();              // and everyone's; the slot before slab s's is free
    if (ds == 0) acc.start_tile();
    acc.start_slab();
    acc.product(ring + slot * slot_bytes<MODE>(), min(S::DC, sc.D - ds * S::DC) / 16);
    acc.end_slab();
    // slab s + STAGES - 1 into the slot slab s - 1 left, after slab s's
    // products, which so start without waiting for these copies to issue
    if (s + STAGES - 1 < total) {
      request(sc, next_tile, next_ds * S::DC,
              ring + (slot == 0 ? STAGES - 1 : slot - 1) * slot_bytes<MODE>());
      advance<MODE>(next_ds, next_tile, slabs);
    } else {
      cp_async_commit();
    }
    if (ds == slabs - 1) epilogue(tile, acc);
    advance<MODE>(ds, tile, slabs);
    slot = slot == STAGES - 1 ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

// The rows of chunk `chunk` of `rows_per_chunk`.
__device__ __forceinline__ void chunk_rows(long long chunk, long long rows_per_chunk,
                                           long long N, long long& begin, long long& end) {
  begin = chunk * rows_per_chunk;
  end = begin + rows_per_chunk < N ? begin + rows_per_chunk : N;
}

}  // namespace
