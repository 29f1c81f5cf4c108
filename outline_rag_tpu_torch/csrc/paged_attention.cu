// paged_attention.cu — grouped-query attention over a paged KV pool, causal
// to each row's position, for NVIDIA Hopper (built for sm_90a by
// outline_rag_tpu_torch/ops/_build.py, bound with ctypes by
// outline_rag_tpu_torch/ops/paged_attention.py::paged_attention).
//
// Replaces the Pallas TPU kernels of outline_rag_tpu/ops/paged_attention.py::
// paged_attention: the three page walks _paged_kernel, _paged_kernel_page and
// _paged_kernel_dma and their shared _accumulate_page. The walks differ only
// in how they amortise the TPU's per-grid-step cost; one kernel replaces them.
//
// For q [B, T, H, Dh], a pool [P, KvH, page, Dh] (a token's Dh values
// contiguous; bf16 or f32 like q, or int8 with f32 scales [P, KvH, page]),
// table [B, MAXP] i32 and pos [B] i32 it computes, for batch row b, KV head
// n, group head g (h = n * G + g) and offset t, over the slots j of the
// row's live pages (slot j lives in page table[b, j / page]):
//
//     s_j   = f32(q . k_j) * (1/sqrt(Dh))   [* k_scale_j for an int8 pool]
//     over the keys j <= pos[b] + t (a key past it adds p_j = 0):
//     m_new = max(m, max_j s_j), alpha = exp(m - m_new), p_j = exp(s_j - m_new)
//     l     = l * alpha + sum_j p_j                       (f32 p)
//     acc   = acc * alpha + sum_j P_j * v_j               (f32 accumulate)
//             P_j = bf16(p_j) for a bf16 pool, p_j for an f32 pool,
//             p_j * v_scale_j (f32) for an int8 pool
//
// with m starting at -1e30, key tile by key tile within a split, and the
// splits' states folded into out = acc / l (l <= 0 -> 1) as below. Live
// slots are min(pos[b] + T, MAXP * page); pages past them are neither read
// nor computed, and a block stops at its own rows' causal horizon (the slots
// it skips would add exactly 0). A row whose table is all 0 reads the
// scratch page 0 and yields finite garbage.
//
// What bounds it on the card: bytes. Decode reads each live K and V byte
// once (2 * 22.5 KB a token a layer at TinyLlama width in bf16) for
// 4 * G * Dh flops a slot a KV head, far below the FMA rate; so the products
// are plain f32 FMAs on values widened from their storage type, which also
// makes one code path serve every pool type. What the design must avoid is
// one block walking a whole row: that is bound by one block's latency.
//
// Design: a row's slots are cut at fixed boundaries of SPLIT = 256 slots.
// One block of 128 threads computes, for a tile of R of the G * T query rows
// (ordered t-major, so a tile's rows share a horizon), one partial softmax
// state (m, l, acc) a row over its splits; CLUSTER = 8 blocks, one cluster,
// share a (batch row, KV head, row tile): block c takes splits c, c + 8, ...
// in order (up to 2,048 slots that is one split a block), and a block with
// no split leaves at once. A block walks its splits in tiles of 32 keys
// through a ring of STAGES tiles in shared memory, filled by cp.async 16
// bytes a thread, so that the next two tiles' bytes are in flight while a
// tile is computed; K and V stay in their
// storage type (K rows padded by 16 bytes, so that the lanes reading their
// own key's row hit different banks) and are widened to f32 when read. One
// barrier a tile. Each warp owns R / 4 rows end to end. Scores: lane = key,
// one sequential FMA chain over d per (row, key); softmax statistics in the
// warp's registers (two shuffle reductions per row); a key a row may not
// see adds p = 0 and leaves the max alone, so a split that lies past a
// row's horizon leaves its partial exactly (-1e30, 0, 0). P.V: each lane
// owns Dh / 32 dims of the warp's rows and sums over keys in order, with P
// from the warp's own slice of shared memory. The partials stay in each
// block's shared memory; after one cluster barrier the live blocks share the
// fold of the tile's rows, reading each other's partials through distributed
// shared memory in split order:
//
//     M = max_s m_s,  l = sum_s l_s * exp(m_s - M),
//     acc = sum_s acc_s * exp(m_s - M),  out = acc / l
//
// An empty partial adds exactly 0. Split bounds, tile bounds and every order
// of summation are functions of the slot alone, so a position's output does
// not depend on T, R, the batch or the page-table width: no atomics, and the
// fold runs in the same launch.
//
// What still holds it (kernel_mutants --ablate paged_attention times copies):
// at a decode step of 64 rows the loads, barriers and fold alone take half
// the time and are still twice the byte bound (each block walks up to eight
// tiles in a chain: the ring keeps two in flight, and a short row pays the
// cluster barriers and the fold); the f32 arithmetic on widened values takes
// the other half. A 256-row prefill chunk is the arithmetic's: with 32 rows
// a tile, a warp runs ~1,800 instructions a tile for 1,024 FMAs. Tried on
// copies and not kept: a ring of two tiles (no faster), and blocks without a
// split waiting at the cluster barriers (the design's first form: they held
// SM slots, 16% slower at decode, 40% at the prefill chunk).

#include "hopper_tma.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TK = 32;        // keys per tile: one per lane
constexpr int SPLIT = 256;    // slots a split; a split starts at a multiple of it
constexpr int CLUSTER = 8;    // blocks of a cluster, along the split axis
constexpr int STAGES = 3;     // tiles in the ring
constexpr float EMPTY = -1e30f;  // m of a row that has seen no key

enum Kind { KIND_BF16 = 0, KIND_F32 = 1, KIND_INT8 = 2 };

// The block's shared memory for a pool of kind KV: the query rows [R][DH]
// and P [R][TK] as f32, then the ring; a stage holds a tile's K rows
// (padded), V rows and, for an int8 pool, its k and v scales.
template <int DH, int R, int KV>
struct Layout {
  static constexpr int ES = KV == KIND_BF16 ? 2 : (KV == KIND_F32 ? 4 : 1);  // bytes an element
  static constexpr int CHUNKS = DH * ES / 16;  // 16-byte pieces of a row
  static constexpr int VROW = DH * ES;
  static constexpr int KROW = VROW + 16;
  static constexpr int V_AT = TK * KROW;
  static constexpr int S_AT = V_AT + TK * VROW;
  static constexpr int STAGE = S_AT + 2 * TK * 4;
  static constexpr int RING_AT = (R * DH + R * TK) * 4;
  static constexpr int BYTES = RING_AT + STAGES * STAGE;
  static_assert(R * DH * 4 + R * 16 <= STAGES * STAGE, "the partials fit where the ring was");
  static_assert(BYTES <= 232448, "a block's shared memory on Hopper");
};

// 16 bytes of q (bf16 or f32) at element offset e, widened to f32.
__device__ __forceinline__ void widen_q(const void* q, long long e, int kind, float* dst) {
  if (kind == KIND_BF16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(q) + e);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(h[i]);
  } else {
    const float4 raw = *reinterpret_cast<const float4*>(static_cast<const float*>(q) + e);
    dst[0] = raw.x; dst[1] = raw.y; dst[2] = raw.z; dst[3] = raw.w;
  }
}

// N elements of a pool of kind KV at shared address p (N * ES bytes,
// aligned to them), widened to f32.
template <int KV, int N>
__device__ __forceinline__ void widen(const uint8_t* p, float* dst) {
  if (KV == KIND_BF16) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(p);
    if (N == 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < N; ++i) dst[i] = __bfloat162float(h[i]);
    } else {
#pragma unroll
      for (int i = 0; i < N; i += 2) {
        const __nv_bfloat162 two = reinterpret_cast<const __nv_bfloat162*>(h)[i / 2];
        dst[i] = __low2float(two);
        dst[i + 1] = __high2float(two);
      }
    }
  } else if (KV == KIND_F32) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 two = reinterpret_cast<const float2*>(p)[i / 2];
      dst[i] = two.x;
      dst[i + 1] = two.y;
    }
  } else {
    if (N == 16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int i = 0; i < N; ++i) dst[i] = static_cast<float>(c[i]);
    } else {
#pragma unroll
      for (int i = 0; i < N; i += 2) {
        const char2 two = reinterpret_cast<const char2*>(p)[i / 2];
        dst[i] = static_cast<float>(two.x);
        dst[i + 1] = static_cast<float>(two.y);
      }
    }
  }
}

// Tile k of a block's walk: splits rank, rank + 8, ..., each in tiles of TK
// keys from its start. cnt <= 0 past the walk's end.
__device__ __forceinline__ void tile_of(int k, int rank, int n_slots, int& k0, int& cnt) {
  constexpr int PER = SPLIT / TK;  // tiles a split
  const int sp = rank + CLUSTER * (k / PER);
  k0 = sp * SPLIT + (k % PER) * TK;
  const int s_end = min((sp + 1) * SPLIT, n_slots);
  cnt = min(TK, s_end - k0);
}

template <int DH, int R, int KV>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
paged_kernel(const void* __restrict__ q, const void* __restrict__ pool_k,
             const void* __restrict__ pool_v, const int* __restrict__ table,
             const int* __restrict__ pos, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale, void* __restrict__ out,
             int T, int H, int KvH, int page, int maxp, int q_kind, float scale) {
  using L = Layout<DH, R, KV>;
  constexpr int RPW = R / 4;             // rows of a warp
  constexpr int DPL = DH / 32;           // output dims of a lane in P.V
  constexpr int VEC = 16 / L::ES;        // elements in 16 bytes
  extern __shared__ __align__(16) uint8_t smem[];
  float* Qs = reinterpret_cast<float*>(smem);           // [R][DH]
  float* Ps = Qs + R * DH;                               // [R][TK], a warp's rows its own
  uint8_t* ring = smem + L::RING_AT;                     // STAGES x (K, V, scales)
  float* part_acc = reinterpret_cast<float*>(ring);      // after the walk: [R][DH]
  float* part_ml = part_acc + R * DH;                    // and [R][4]: m, l

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x % CLUSTER;  // the cluster's blocks are consecutive in x
  const int b = blockIdx.z, n = blockIdx.y, G = H / KvH;
  const int rows = G * T, row0 = (blockIdx.x / CLUSTER) * R;
  const int p0 = pos[b];
  const int last_row = min(row0 + R, rows) - 1;
  const long long cap = (long long)maxp * page;
  const long long want = (long long)p0 + last_row / G + 1;  // slots in reach
  const int n_slots = static_cast<int>(want < cap ? want : cap);
  const int n_splits = (n_slots + SPLIT - 1) / SPLIT;
  // A block without a split leaves at once: no block reads its shared memory,
  // and a cluster barrier waits only for the threads that have not exited.
  if (rank >= n_splits) return;
  const int* row_table = table + (long long)b * maxp;

  // Tile k of this block's walk (splits rank, rank + 8, ..., each in tiles of
  // TK keys from its start) into ring slot k % STAGES, as one cp.async group
  // (empty past the walk's end). Keys past the walk's end read as zeros.
  auto request = [&](int k) {
    int k0, cnt;
    tile_of(k, rank, n_slots, k0, cnt);
    uint8_t* st = ring + (k % STAGES) * L::STAGE;
    if (cnt > 0) {
      for (int i = tid; i < TK * L::CHUNKS; i += THREADS) {
        const int j = i / L::CHUNKS, c = i % L::CHUNKS;
        const bool live = j < cnt;
        long long at = 0;
        if (live) {
          const int slot = k0 + j;
          at = (((long long)row_table[slot / page] * KvH + n) * page + slot % page) * DH;
        }
        const size_t off = (size_t)at * L::ES + 16 * c;
        cp_async16(st + j * L::KROW + 16 * c, static_cast<const uint8_t*>(pool_k) + off, live);
        cp_async16(st + L::V_AT + j * L::VROW + 16 * c, static_cast<const uint8_t*>(pool_v) + off,
                   live);
      }
      if (KV == KIND_INT8 && tid < 2 * TK) {
        const int j = tid % TK, slot = k0 + j;
        float* dst = reinterpret_cast<float*>(st + L::S_AT) + tid;
        if (j < cnt)
          cp_async4(dst, (tid < TK ? k_scale : v_scale) +
                             ((long long)row_table[slot / page] * KvH + n) * page + slot % page);
        else
          *dst = 0.f;
      }
    }
    cp_async_commit();
  };
  for (int k = 0; k < STAGES - 1; ++k) request(k);

  // the tile's query rows, widened to f32 (rows past the end are zeros)
  const int qvec = q_kind == KIND_BF16 ? 8 : 4;
  for (int i = tid; i < R * (DH / qvec); i += THREADS) {
    const int r = i / (DH / qvec), d = (i % (DH / qvec)) * qvec;
    float tmp[16];
    const int row = row0 + r;
    if (row < rows) {
      const int t = row / G, g = row % G;
      const long long e = (((long long)b * T + t) * H + n * G + g) * DH + d;
      widen_q(q, e, q_kind, tmp);
    } else {
      for (int j = 0; j < qvec; ++j) tmp[j] = 0.f;
    }
    for (int j = 0; j < qvec; ++j) Qs[r * DH + d + j] = tmp[j];
  }

  // this warp's rows r = warp + 4 * i: softmax state, horizon, and the
  // accumulators of dims lane * DPL + (0 .. DPL)
  float m[RPW], l[RPW], acc[RPW][DPL];
  int horizon[RPW];  // last visible slot of the row
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = EMPTY;
    l[i] = 0.f;
    const int row = row0 + warp + 4 * i;
    horizon[i] = p0 + (row < rows ? row / G : 0);
#pragma unroll
    for (int x = 0; x < DPL; ++x) acc[i][x] = 0.f;
  }
  float* my_ps = Ps + warp * RPW * TK;

  for (int k = 0;; ++k) {
    int k0, cnt;
    tile_of(k, rank, n_slots, k0, cnt);
    if (cnt <= 0) break;
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile k are there
    __syncthreads();  // everyone's are, and every warp is done with tile k - 1
    request(k + STAGES - 1);  // into the slot tile k - 1 held
    const uint8_t* st = ring + (k % STAGES) * L::STAGE;
    const float* sc = reinterpret_cast<const float*>(st + L::S_AT);

    // scores: this lane's key against the warp's rows, d in order
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
    const uint8_t* krow = st + lane * L::KROW;
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c) {
      float kf[16];
      widen<KV, VEC>(krow + 16 * c, kf);
#pragma unroll
      for (int x = 0; x < VEC; x += 4) {
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float4 qq =
              *reinterpret_cast<const float4*>(Qs + (warp + 4 * i) * DH + c * VEC + x);
          s[i] = fmaf(qq.x, kf[x], s[i]);
          s[i] = fmaf(qq.y, kf[x + 1], s[i]);
          s[i] = fmaf(qq.z, kf[x + 2], s[i]);
          s[i] = fmaf(qq.w, kf[x + 3], s[i]);
        }
      }
    }
    const int slot = k0 + lane;
    float alpha[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float v = __fmul_rn(s[i], scale);
      if (KV == KIND_INT8) v = __fmul_rn(v, sc[lane]);
      const bool live = lane < cnt && slot <= horizon[i];
      float mx = live ? v : EMPTY;  // a key the row may not see leaves the max alone
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      const float p = live ? expf(v - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), sum);
      m[i] = m_new;
      float pw = p;
      if (KV == KIND_BF16) pw = __bfloat162float(__float2bfloat16_rn(p));
      if (KV == KIND_INT8) pw = __fmul_rn(p, sc[TK + lane]);
      my_ps[i * TK + lane] = pw;
    }
    __syncwarp();

    // acc = acc * alpha + P . V, keys in order
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int x = 0; x < DPL; ++x) acc[i][x] *= alpha[i];
    const uint8_t* vcol = st + L::V_AT + lane * DPL * L::ES;
#pragma unroll 2
    for (int j = 0; j < TK; j += 4) {
      float vf[4][DPL];
#pragma unroll
      for (int u = 0; u < 4; ++u) widen<KV, DPL>(vcol + (j + u) * L::VROW, vf[u]);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(my_ps + i * TK + j);
#pragma unroll
        for (int x = 0; x < DPL; ++x) {
          acc[i][x] = fmaf(p.x, vf[0][x], acc[i][x]);
          acc[i][x] = fmaf(p.y, vf[1][x], acc[i][x]);
          acc[i][x] = fmaf(p.z, vf[2][x], acc[i][x]);
          acc[i][x] = fmaf(p.w, vf[3][x], acc[i][x]);
        }
      }
    }
  }
  cp_async_wait<0>();  // the empty groups past the end

  // this block's partials, where the ring was
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + 4 * i;
#pragma unroll
    for (int x = 0; x < DPL; ++x) part_acc[r * DH + lane * DPL + x] = acc[i][x];
    if (lane == 0) *reinterpret_cast<float4*>(part_ml + r * 4) = make_float4(m[i], l[i], 0.f, 0.f);
  }
  cluster_sync();

  // the fold: the live blocks share the tile's rows (this one takes rows
  // rank, rank + live_blocks, ...) and add the live blocks' partials in split
  // order
  const int live_blocks = min(n_splits, CLUSTER);
  const int my_rows = (R - rank + live_blocks - 1) / live_blocks;
  for (int i = tid; i < my_rows * (DH / 4); i += THREADS) {
    const int r = rank + live_blocks * (i / (DH / 4)), d = 4 * (i % (DH / 4));
    const int row = row0 + r;
    if (row >= rows) continue;
    float ms[CLUSTER], ls[CLUSTER];
    float M = EMPTY;
#pragma unroll
    for (int c = 0; c < CLUSTER; ++c) {
      if (c < live_blocks) {
        const float4 st = ld_cluster(smem_u32(part_ml + r * 4), c);
        ms[c] = st.x;
        ls[c] = st.y;
        M = fmaxf(M, st.x);
      }
    }
    float sum = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < CLUSTER; ++c) {
      if (c < live_blocks) {
        const float w = expf(ms[c] - M);
        const float4 a = ld_cluster(smem_u32(part_acc + r * DH + d), c);
        sum = __fadd_rn(sum, __fmul_rn(ls[c], w));
        o.x = __fadd_rn(o.x, __fmul_rn(a.x, w));
        o.y = __fadd_rn(o.y, __fmul_rn(a.y, w));
        o.z = __fadd_rn(o.z, __fmul_rn(a.z, w));
        o.w = __fadd_rn(o.w, __fmul_rn(a.w, w));
      }
    }
    const float denom = sum <= 0.f ? 1.f : sum;
    const float o0 = __fdiv_rn(o.x, denom), o1 = __fdiv_rn(o.y, denom);
    const float o2 = __fdiv_rn(o.z, denom), o3 = __fdiv_rn(o.w, denom);
    const int t = row / G, g = row % G;
    const long long e = (((long long)b * T + t) * H + n * G + g) * DH + d;
    if (q_kind == KIND_BF16) {
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + e) =
          make_uint2(pack_bf16(o0, o1), pack_bf16(o2, o3));
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + e) = make_float4(o0, o1, o2, o3);
    }
  }
  cluster_sync();  // no block leaves while another reads its partials
}

template <int DH, int R, int KV>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const int* table, const int* pos, const float* k_scale,
           const float* v_scale, void* out, int B, int T, int H, int KvH,
           int page, int maxp, int q_kind, float scale, cudaStream_t st) {
  constexpr int bytes = Layout<DH, R, KV>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      paged_kernel<DH, R, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = (H / KvH) * T;
  const dim3 grid((rows + R - 1) / R * CLUSTER, KvH, B);
  paged_kernel<DH, R, KV><<<grid, THREADS, bytes, st>>>(
      q, pool_k, pool_v, table, pos, k_scale, v_scale, out, T, H, KvH, page,
      maxp, q_kind, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, int R>
int launch_kind(const void* q, const void* pool_k, const void* pool_v,
                const int* table, const int* pos, const float* k_scale,
                const float* v_scale, void* out, int B, int T, int H, int KvH,
                int page, int maxp, int q_kind, int kv_kind, float scale,
                cudaStream_t st) {
#define PAGED_KIND(KV)                                                            \
  launch<DH, R, KV>(q, pool_k, pool_v, table, pos, k_scale, v_scale, out, B, T, H, \
                    KvH, page, maxp, q_kind, scale, st)
  if (kv_kind == KIND_BF16) return PAGED_KIND(KIND_BF16);
  if (kv_kind == KIND_F32) return PAGED_KIND(KIND_F32);
  return PAGED_KIND(KIND_INT8);
#undef PAGED_KIND
}

}  // namespace

// q, out: [B, T, H, Dh] contiguous, bf16 (q_kind 0) or f32 (q_kind 1).
// pool_k, pool_v: [P, KvH, page, Dh] contiguous, of q's type (kv_kind ==
// q_kind) or int8 (kv_kind 2) with k_scale, v_scale [P, KvH, page] f32.
// table: [B, maxp] i32 page ids; pos: [B] i32. Dh is 64 or 128; B and KvH
// at most 65535. Launches on `stream`; allocates nothing. Returns 0 or the
// CUDA error code.
extern "C" int paged_attention_launch(
    const void* q, const void* pool_k, const void* pool_v, const void* table,
    const void* pos, const void* k_scale, const void* v_scale, void* out, int B,
    int T, int H, int KvH, int Dh, int page, int maxp, int q_kind, int kv_kind,
    float scale, void* stream) {
  const bool kinds_ok = (q_kind == KIND_BF16 || q_kind == KIND_F32) &&
                        (kv_kind == q_kind || kv_kind == KIND_INT8);
  if (B <= 0 || T <= 0 || H <= 0 || KvH <= 0 || H % KvH || page <= 0 ||
      maxp <= 0 || B > 65535 || KvH > 65535 || !kinds_ok ||
      (Dh != 64 && Dh != 128) ||
      (kv_kind == KIND_INT8 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(table);
  const int* ps = static_cast<const int*>(pos);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const bool small = (H / KvH) * T <= 8;  // decode: one tile of 8 rows
#define PAGED_LAUNCH(DH, R)                                                     \
  launch_kind<DH, R>(q, pool_k, pool_v, tb, ps, ks, vs, out, B, T, H, KvH, page, \
                     maxp, q_kind, kv_kind, scale, st)
  if (Dh == 64) return small ? PAGED_LAUNCH(64, 8) : PAGED_LAUNCH(64, 32);
  return small ? PAGED_LAUNCH(128, 8) : PAGED_LAUNCH(128, 32);
#undef PAGED_LAUNCH
}
