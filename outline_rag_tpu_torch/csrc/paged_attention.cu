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
//     s_j   = -1e9 unless j <= pos[b] + t
//     m_new = max(m, max_j s_j), alpha = exp(m - m_new), p_j = exp(s_j - m_new)
//     l     = l * alpha + sum_j p_j                       (f32 p)
//     acc   = acc * alpha + sum_j P_j * v_j               (f32 accumulate)
//             P_j = bf16(p_j) for a bf16 pool, p_j for an f32 pool,
//             p_j * v_scale_j (f32) for an int8 pool
//     out   = acc / l                                     (l <= 0 -> 1)
//
// with m starting at -1e30, key tile by key tile. Live slots are
// min(pos[b] + T, MAXP * page); pages past them are neither read nor
// computed, and a block stops at its own rows' causal horizon (the slots it
// skips would add exactly 0). A row whose table is all 0 reads the scratch
// page 0 and yields finite garbage.
//
// What bounds it on the card: bytes. Decode reads each live K and V byte
// once (2 * 22.5 KB a token a layer at TinyLlama width in bf16) for
// 4 * G * Dh flops a slot a KV head, far below the FMA rate; so the products
// are plain f32 FMAs on values widened from their storage type, which also
// makes one code path serve every pool type, and the design's care goes
// into 16-byte coalesced loads of whole key rows.
//
// Design: one block of 128 threads per (batch row, KV head, tile of R of the
// G * T query rows, ordered t-major so a tile's rows share a horizon). The
// block walks the row's pages in tiles of 32 keys staged in shared memory as
// f32. Scores: lane = key, each warp owns R / 4 rows, one sequential FMA
// chain over d per (row, key). Softmax statistics stay in that warp's
// registers (two shuffle reductions per row). P goes through shared memory
// to the P.V threads, which each own a few output dims of one row in
// registers and sum over keys in order. Every sum has a fixed order, so the
// result depends on neither block scheduling nor R, T or the batch a row
// shares: no atomics, no split over pages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TK = 32;  // keys per tile: one per lane
constexpr float MASKED = -1e9f;

enum Kind { KIND_BF16 = 0, KIND_F32 = 1, KIND_INT8 = 2 };

// 16 bytes of `kind` at element offset `e` of `base`, widened to f32 into
// dst[0 .. n), n = 8 (bf16), 4 (f32) or 16 (int8).
__device__ __forceinline__ int widen16(const void* base, long long e, int kind,
                                       float* dst) {
  if (kind == KIND_BF16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + e);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(h[i]);
    return 8;
  }
  if (kind == KIND_F32) {
    const float4 raw =
        *reinterpret_cast<const float4*>(static_cast<const float*>(base) + e);
    dst[0] = raw.x; dst[1] = raw.y; dst[2] = raw.z; dst[3] = raw.w;
    return 4;
  }
  const uint4 raw =
      *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(base) + e);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(c[i]);
  return 16;
}

template <int DH, int R>
__global__ void __launch_bounds__(THREADS)
paged_kernel(const void* __restrict__ q, const void* __restrict__ pool_k,
             const void* __restrict__ pool_v, const int* __restrict__ table,
             const int* __restrict__ pos, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale, void* __restrict__ out,
             int T, int H, int KvH, int page, int maxp, int q_kind,
             int kv_kind, float scale) {
  constexpr int RPW = R / 4;          // rows per warp in the score phase
  constexpr int TPR = THREADS / R;    // threads per row in the P.V phase
  constexpr int DPT = DH / TPR;       // output dims per thread
  constexpr int KS = DH + 1;          // Ks row stride: lane = key reads
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // [R][DH]
  float* Ks = Qs + R * DH;            // [TK][KS]
  float* Vs = Ks + TK * KS;           // [TK][DH]; TK * KS is a multiple of 4 floats
  float* Ps = Vs + TK * DH;           // [R][TK]
  float* Al = Ps + R * TK;            // [R] alpha, then l at the end
  float* Sc = Al + R;                 // [2][TK] k and v scales

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, n = blockIdx.y, G = H / KvH;
  const int rows = G * T, row0 = blockIdx.x * R;
  const int p0 = pos[b];

  // the tile's query rows, widened to f32 (rows past the end are zeros)
  const int qvec = q_kind == KIND_BF16 ? 8 : 4;
  for (int i = tid; i < R * (DH / qvec); i += THREADS) {
    const int r = i / (DH / qvec), d = (i % (DH / qvec)) * qvec;
    float tmp[16];
    const int row = row0 + r;
    if (row < rows) {
      const int t = row / G, g = row % G;
      const long long e = (((long long)b * T + t) * H + n * G + g) * DH + d;
      widen16(q, e, q_kind, tmp);
    } else {
      for (int j = 0; j < qvec; ++j) tmp[j] = 0.f;
    }
    for (int j = 0; j < qvec; ++j) Qs[r * DH + d + j] = tmp[j];
  }

  // score-phase rows of this warp: r = warp + 4 * i, with their offsets t
  float m[RPW], l[RPW];
  int horizon[RPW];  // last visible slot of the row
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
    const int row = row0 + warp + 4 * i;
    horizon[i] = p0 + (row < rows ? row / G : 0);
  }
  // P.V-phase ownership: row pr, dims (tid % TPR) * 4 + TPR * 4 * i + (0..3)
  const int pr = tid / TPR, pc = (tid % TPR) * 4;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  const int last_row = min(row0 + R, rows) - 1;
  const long long cap = (long long)maxp * page;
  const long long want = (long long)p0 + last_row / G + 1;  // slots in reach
  const int n_slots = static_cast<int>(want < cap ? want : cap);
  const int kvec = kv_kind == KIND_BF16 ? 8 : (kv_kind == KIND_F32 ? 4 : 16);

  for (int pi = 0; pi * page < n_slots; ++pi) {
    const int pg = table[(long long)b * maxp + pi];
    const long long page_base = ((long long)pg * KvH + n) * page;  // slot index
    const int in_page = min(page, n_slots - pi * page);
    for (int k0 = 0; k0 < in_page; k0 += TK) {
      const int cnt = min(TK, in_page - k0);
      __syncthreads();  // the previous tile's reads of Ks / Vs / Ps are done
      for (int i = tid; i < TK * (DH / kvec); i += THREADS) {
        const int j = i / (DH / kvec), d = (i % (DH / kvec)) * kvec;
        float kt[16], vt[16];
        if (j < cnt) {
          const long long e = (page_base + k0 + j) * DH + d;
          widen16(pool_k, e, kv_kind, kt);
          widen16(pool_v, e, kv_kind, vt);
        } else {
          for (int x = 0; x < kvec; ++x) kt[x] = vt[x] = 0.f;
        }
        for (int x = 0; x < kvec; ++x) {
          Ks[j * KS + d + x] = kt[x];
          Vs[j * DH + d + x] = vt[x];
        }
      }
      if (kv_kind == KIND_INT8 && tid < 2 * TK) {
        const int j = tid % TK;
        const float* src = tid < TK ? k_scale : v_scale;
        Sc[tid] = j < cnt ? src[page_base + k0 + j] : 0.f;
      }
      __syncthreads();

      // scores: this lane's key against the warp's rows
      float s[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) s[i] = 0.f;
      const float* krow = Ks + lane * KS;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float kv = krow[d];
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          s[i] = fmaf(Qs[(warp + 4 * i) * DH + d], kv, s[i]);
      }
      const int slot = pi * page + k0 + lane;
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        float v = __fmul_rn(s[i], scale);
        if (kv_kind == KIND_INT8) v = __fmul_rn(v, Sc[lane]);
        if (lane >= cnt || slot > horizon[i]) v = MASKED;
        float mx = v;
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        const float p = expf(v - m_new);
        float sum = p;
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[i] = __fadd_rn(__fmul_rn(l[i], alpha), sum);
        m[i] = m_new;
        float pw = p;
        if (kv_kind == KIND_BF16) pw = __bfloat162float(__float2bfloat16_rn(p));
        if (kv_kind == KIND_INT8) pw = __fmul_rn(p, Sc[TK + lane]);
        const int r = warp + 4 * i;
        Ps[r * TK + lane] = pw;
        if (lane == 0) Al[r] = alpha;
      }
      __syncthreads();

      // acc = acc * alpha + P . V, keys in order
      const float alpha = Al[pr];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
      for (int j = 0; j < TK; ++j) {
        const float p = Ps[pr * TK + j];
#pragma unroll
        for (int i = 0; i < DPT / 4; ++i) {
          const float4 vv =
              *reinterpret_cast<const float4*>(Vs + j * DH + pc + TPR * 4 * i);
          acc[4 * i + 0] = fmaf(p, vv.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
        }
      }
    }
  }

  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) Al[warp + 4 * i] = l[i];
  }
  __syncthreads();
  const int row = row0 + pr;
  if (row < rows) {
    const float denom = Al[pr] <= 0.f ? 1.f : Al[pr];
    const int t = row / G, g = row % G;
    const long long e0 = (((long long)b * T + t) * H + n * G + g) * DH;
#pragma unroll
    for (int i = 0; i < DPT / 4; ++i) {
      const int d = pc + TPR * 4 * i;
      const float o0 = __fdiv_rn(acc[4 * i + 0], denom);
      const float o1 = __fdiv_rn(acc[4 * i + 1], denom);
      const float o2 = __fdiv_rn(acc[4 * i + 2], denom);
      const float o3 = __fdiv_rn(acc[4 * i + 3], denom);
      if (q_kind == KIND_BF16) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(o0, o1);
        __nv_bfloat162 hi = __floats2bfloat162_rn(o2, o3);
        uint2 pk;
        pk.x = *reinterpret_cast<uint32_t*>(&lo);
        pk.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + e0 + d) = pk;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + e0 + d) =
            make_float4(o0, o1, o2, o3);
      }
    }
  }
}

template <int DH, int R>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const int* table, const int* pos, const float* k_scale,
           const float* v_scale, void* out, int B, int T, int H, int KvH,
           int page, int maxp, int q_kind, int kv_kind, float scale,
           cudaStream_t st) {
  // Qs, Ks, Vs, Ps, Al, Sc
  const size_t floats = (size_t)R * DH + TK * (DH + 1) + (size_t)TK * DH +
                        (size_t)R * TK + R + 2 * TK;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_kernel<DH, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = (H / KvH) * T;
  const dim3 grid((rows + R - 1) / R, KvH, B);
  paged_kernel<DH, R><<<grid, THREADS, bytes, st>>>(
      q, pool_k, pool_v, table, pos, k_scale, v_scale, out, T, H, KvH, page,
      maxp, q_kind, kv_kind, scale);
  return static_cast<int>(cudaGetLastError());
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
#define PAGED_LAUNCH(DH, R)                                                   \
  launch<DH, R>(q, pool_k, pool_v, tb, ps, ks, vs, out, B, T, H, KvH, page,   \
                maxp, q_kind, kv_kind, scale, st)
  if (Dh == 64) return small ? PAGED_LAUNCH(64, 8) : PAGED_LAUNCH(64, 32);
  return small ? PAGED_LAUNCH(128, 8) : PAGED_LAUNCH(128, 32);
#undef PAGED_LAUNCH
}
