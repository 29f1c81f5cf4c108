// flash_attention.cu — bidirectional multi-head attention with an additive
// key bias and an online softmax, for NVIDIA Hopper (built for sm_90a by
// outline_rag_tpu_torch/ops/_build.py, bound with ctypes by
// outline_rag_tpu_torch/ops/attention.py::flash_attention).
//
// Replaces the Pallas TPU kernel outline_rag_tpu/ops/attention.py::
// _flash_kernel (launched by _flash_jit). For q, k, v in the encoder's
// [B, S, H, D] layout (bf16 or f32, D = 64) and a [B, S] f32 key bias (0
// for real tokens, NEG_BIAS = -1e9 for padding) it computes, per (batch,
// head, query row), over key tiles:
//
//     s     = f32(q . k) * (1/sqrt(D)) + bias[key]
//     m_new = max(m, max(s)),  alpha = exp(m - m_new),  p = exp(s - m_new)
//     l     = l * alpha + sum(p)          (f32 p)
//     acc   = acc * alpha + bf16(p) . v   (unnormalised p cast to the input
//                                          dtype before P.V, f32 accumulate;
//                                          no cast for f32 inputs)
//     out   = acc / l                      (l <= 0 -> 1: a row with no live
//                                          key emits zeros)
//
// with m starting at -1e30. A key tile whose keys are all padding is skipped
// (it would add exp(-1e9 - m) = 0 everywhere), as the Pallas kernel skips its
// fully-masked tiles. Keys past S count as padding.
//
// What bounds it on the card: 4 * S^2 * D * H flops per batch row (275 GFLOP
// per layer at S = 8192, H = 16), so the bf16 tensor cores (989 TFLOP/s
// dense) are the ceiling; the inputs are O(S * D) bytes. At D = 64 the
// softmax is as long as the products: a 64 x 64 tile of logits is 128
// cycles of tensor-core time twice (Q K^T, P V) and 4,096 exponentials at 16
// a cycle an SM, and the five or six other instructions an element fill the
// issue slots for as long again. So the three must run side by side, K and V
// must not be re-read from L2 more often than need be, and no thread may
// spend an instruction on a copy. The [S, S] logits never reach device
// memory.
//
// bf16 design:
//   - One block per (batch * head, 256 query rows): four consumer warpgroups
//     of 64 rows each and one producer warp. K and V are read from L2 once
//     per 256 rows, and while one warpgroup waits for its products the other
//     three have the issue slots and the exponential unit.
//   - The producer warp walks the key tiles of 64 keys. It reads the tile's
//     64 biases; a tile with no live key is neither loaded nor multiplied
//     (the bias need not be a prefix mask). For a live tile it waits for a
//     free slot of a 4-stage ring, writes the biases (times log2 e) beside
//     it, and issues two TMA copies (cp.async.bulk.tensor, 128-byte swizzle:
//     a head's row is 64 bf16 = 128 bytes, one swizzle atom; the tensor map
//     over [B, S, H, D] has the head as its own dimension and zero-fills
//     rows past S) that complete on the slot's mbarrier. No thread of a
//     consumer ever touches a K or V byte, and no load is synchronous. An
//     end marker in the slot after the last live tile ends the consumers.
//   - A consumer warpgroup computes S = Q K^T with wgmma.mma_async
//     m64n64k16 (Q and the K tile from shared memory as they lie, both
//     K-major), the softmax in the wgmma accumulator layout (a row lives in
//     four lanes; exp2 of s * (scale * log2 e) + bias * log2 e - m, one
//     MUFU instruction an element; in a tile without padding the maximum is
//     taken of s itself and the rest is one fused multiply-add; the row sum
//     stays a per-lane partial sum until the end; O is rescaled only when a
//     maximum moved), and O += P V with P packed to bf16 straight from the
//     accumulator registers as the A operand and the V tile [key][d] as an
//     MN-major B operand (the instruction's transpose flag): there is no
//     transposed copy of V anywhere.
//   - Fixed order, no atomics, no split over keys: two runs are bit-equal.
//
// The f32 instantiation (one query row a thread, f32 FMAs) is further down.

#include "hopper_tma.cuh"

namespace {

constexpr int HD = 64;           // head dim
constexpr int BQ = 256;          // query rows per block: 64 a consumer warpgroup
constexpr int BK = 64;           // keys per tile
constexpr int STAGES = 4;        // K/V tiles in flight
constexpr int CONSUMERS = 4;     // warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;  // and one producer warp
constexpr float NEG_BIAS = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t TILE_BYTES = BK * HD * 2;  // one K or V tile: 8 KB

struct FlashSmem {                 // 1024-byte aligned: the swizzle's period
  __nv_bfloat16 q[BQ * HD];        // [row][d], 128-byte swizzled by the TMA
  __nv_bfloat16 k[STAGES][BK * HD];
  __nv_bfloat16 v[STAGES][BK * HD];
  float bias[STAGES][BK];          // bias * log2 e of the slot's keys
  int key0[STAGES];                // the slot's first key; -1: no tile follows
  int unmasked[STAGES];            // every bias of the slot is 0
  uint64_t full[STAGES], empty[STAGES], q_full;
};
constexpr size_t SMEM_BYTES = sizeof(FlashSmem) + 1024;  // room to align

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU instruction
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- wgmma -----------------------------------------------------------------

// s[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both from shared memory, K-major.
__device__ __forceinline__ void wgmma_qk(float (&s)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(s[0]), "+f"(s[1]), "+f"(s[2]), "+f"(s[3]),
        "+f"(s[4]), "+f"(s[5]), "+f"(s[6]), "+f"(s[7]),
        "+f"(s[8]), "+f"(s[9]), "+f"(s[10]), "+f"(s[11]),
        "+f"(s[12]), "+f"(s[13]), "+f"(s[14]), "+f"(s[15]),
        "+f"(s[16]), "+f"(s[17]), "+f"(s[18]), "+f"(s[19]),
        "+f"(s[20]), "+f"(s[21]), "+f"(s[22]), "+f"(s[23]),
        "+f"(s[24]), "+f"(s[25]), "+f"(s[26]), "+f"(s[27]),
        "+f"(s[28]), "+f"(s[29]), "+f"(s[30]), "+f"(s[31])
      : "l"(a), "l"(b), "r"(accumulate)
      : "memory");
}
// o[64 x 64] += P[64 x 16] . V[16 x 64]: P from registers (the accumulator
// layout of s is the A layout), V [key][d] from shared memory, MN-major.
__device__ __forceinline__ void wgmma_pv(float (&o)[32], const uint32_t (&p)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : "+f"(o[0]), "+f"(o[1]), "+f"(o[2]), "+f"(o[3]),
        "+f"(o[4]), "+f"(o[5]), "+f"(o[6]), "+f"(o[7]),
        "+f"(o[8]), "+f"(o[9]), "+f"(o[10]), "+f"(o[11]),
        "+f"(o[12]), "+f"(o[13]), "+f"(o[14]), "+f"(o[15]),
        "+f"(o[16]), "+f"(o[17]), "+f"(o[18]), "+f"(o[19]),
        "+f"(o[20]), "+f"(o[21]), "+f"(o[22]), "+f"(o[23]),
        "+f"(o[24]), "+f"(o[25]), "+f"(o[26]), "+f"(o[27]),
        "+f"(o[28]), "+f"(o[29]), "+f"(o[30]), "+f"(o[31])
      : "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "l"(b), "r"(1)
      : "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
flash_kernel(const __grid_constant__ CUtensorMap q_map,
             const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map,
             const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
             int S, int H, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  FlashSmem& sm = *reinterpret_cast<FlashSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q_row0 = blockIdx.x * BQ;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&sm.full[i], 1);               // the producer's one arrival
      mbar_init(&sm.empty[i], CONSUMERS * 4);  // one a consumer warp
    }
    mbar_init(&sm.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // ---- the producer warp ----
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.q_full, BQ * HD * 2);
      tma_load(sm.q, &q_map, &sm.q_full, h, q_row0, b);
    }
    const float* brow = bias + (long long)b * S;
    auto load_bias = [&](int key0, float (&x)[BK / 32]) {
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) {
        const int key = key0 + lane + 32 * i;
        x[i] = key < S ? brow[key] : NEG_BIAS;
      }
    };
    float cur[BK / 32], nxt[BK / 32];
    load_bias(0, cur);
    int it = 0;  // live tiles so far
    for (int key0 = 0; key0 < S; key0 += BK) {
      if (key0 + BK < S) load_bias(key0 + BK, nxt);  // in flight during the wait below
      bool live = false, zero = true;
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) {
        live |= cur[i] > NEG_BIAS * 0.5f;
        zero &= cur[i] == 0.f;
      }
      zero = __all_sync(0xffffffffu, zero);
      if (__any_sync(0xffffffffu, live)) {  // else: an all-padding key tile
        const int st = it % STAGES;
        mbar_wait(&sm.empty[st], ((it / STAGES) & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < BK / 32; ++i) sm.bias[st][lane + 32 * i] = cur[i] * LOG2E;
        if (lane == 0) {
          sm.key0[st] = key0;
          sm.unmasked[st] = zero;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.full[st], 2 * TILE_BYTES);
          tma_load(sm.k[st], &k_map, &sm.full[st], h, key0, b);
          tma_load(sm.v[st], &v_map, &sm.full[st], h, key0, b);
        }
        ++it;
      }
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) cur[i] = nxt[i];
    }
    const int st = it % STAGES;  // the end marker
    mbar_wait(&sm.empty[st], ((it / STAGES) & 1) ^ 1);
    if (lane == 0) {
      sm.key0[st] = -1;
      mbar_arrive(&sm.full[st]);
    }
    return;
  }

  // ---- a consumer warpgroup: 64 query rows ----
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group, column pair
  const uint64_t q_desc = tile_desc(sm.q + wg * 64 * HD);

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = -1e30f, m1 = -1e30f;  // rows g, g + 8 of this warp's 16
  float l0 = 0.f, l1 = 0.f;        // this lane's share of the row sums

  mbar_wait(&sm.q_full, 0);
  for (int it = 0;; ++it) {
    const int st = it % STAGES;
    mbar_wait(&sm.full[st], (it / STAGES) & 1);
    if (sm.key0[st] < 0) break;

    // S = Q K^T
    float s[BK / 2];
    const uint64_t k_desc = tile_desc(sm.k[st]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_qk(s, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);

    // t = s * (scale * log2 e) + bias * log2 e, its row maxima m, and
    // p = 2^(t - m): exactly 0 for a padding key. p is packed to bf16 as the A
    // fragments of P V (the accumulators of key columns 16kk .. 16kk + 15).
    float mx0 = -1e30f, mx1 = -1e30f;  // every t is far above (>= ~-1.5e9)
    float alpha0, alpha1, sum0 = 0.f, sum1 = 0.f;
    uint32_t p[BK / 16][4];
    if (sm.unmasked[st]) {
      // no bias in this tile: the maximum of t is the scaled maximum of s,
      // and t - m is one fused multiply-add
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j + 0], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
      alpha0 = ex2(m0 - mn0);
      alpha1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = ex2(fmaf(s[4 * j + 0], scale_log2, -mn0));
        const float p1 = ex2(fmaf(s[4 * j + 1], scale_log2, -mn0));
        const float p2 = ex2(fmaf(s[4 * j + 2], scale_log2, -mn1));
        const float p3 = ex2(fmaf(s[4 * j + 3], scale_log2, -mn1));
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        p[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
        p[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
    } else {
      const float* bs = sm.bias[st];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float2 bj = *reinterpret_cast<const float2*>(bs + j * 8 + 2 * t);
        s[4 * j + 0] = fmaf(s[4 * j + 0], scale_log2, bj.x);
        s[4 * j + 1] = fmaf(s[4 * j + 1], scale_log2, bj.y);
        s[4 * j + 2] = fmaf(s[4 * j + 2], scale_log2, bj.x);
        s[4 * j + 3] = fmaf(s[4 * j + 3], scale_log2, bj.y);
        mx0 = fmaxf(mx0, fmaxf(s[4 * j + 0], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      alpha0 = ex2(m0 - mn0);
      alpha1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = ex2(s[4 * j + 0] - mn0), p1 = ex2(s[4 * j + 1] - mn0);
        const float p2 = ex2(s[4 * j + 2] - mn1), p3 = ex2(s[4 * j + 3] - mn1);
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        p[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
        p[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    // the accumulator is rescaled only where a row's maximum moved
    if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j + 0] *= alpha0;
        o[4 * j + 1] *= alpha0;
        o[4 * j + 2] *= alpha1;
        o[4 * j + 3] *= alpha1;
      }
    }

    // O += bf16(P) V
    const uint64_t v_desc = tile_desc(sm.v[st]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_pv(o, p[kk], v_desc + kk * (16 * HD * 2 >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    pin(o);

    __syncwarp();  // every lane's reads of the slot are done
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  }

  // the row sums: the four lanes that share a row
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 <= 0.f ? 1.f : l0, inv1 = l1 <= 0.f ? 1.f : l1;
  const int r0 = q_row0 + wg * 64 + (warp & 3) * 16 + g, r1 = r0 + 8;
  const long long row_stride = (long long)H * HD;
  __nv_bfloat16* obase = out + (long long)b * S * row_stride + (long long)h * HD + 2 * t;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(obase + r0 * row_stride + j * 8) =
          pack_bf16(__fdiv_rn(o[4 * j + 0], inv0), __fdiv_rn(o[4 * j + 1], inv0));
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(obase + r1 * row_stride + j * 8) =
          pack_bf16(__fdiv_rn(o[4 * j + 2], inv1), __fdiv_rn(o[4 * j + 3], inv1));
  }
}

// The f32 instantiation: what _flash_kernel computes for f32 inputs (P is
// not rounded; both products are f32 FMAs, no TF32). One thread per query
// row, its q and output rows in registers; a block of BQ32 rows walks
// BK32-key tiles of K and V staged in shared memory, where every lane of
// a warp reads the same key (a broadcast). The softmax statistics are the
// thread's own. Bound: the f32 FMA rate, 2 * S^2 * D * H FMAs per batch
// row (137 G per layer at S = 8192, H = 16).
constexpr int BQ32 = 64;
constexpr int BK32 = 32;

__global__ void __launch_bounds__(BQ32)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, int S, int H, float scale) {
  __shared__ __align__(16) float Ks[BK32][HD];
  __shared__ __align__(16) float Vs[BK32][HD];
  __shared__ float bs[BK32];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long row_stride = (long long)H * HD;
  const long long head0 = (long long)b * S * row_stride + (long long)h * HD;
  const int row = blockIdx.x * BQ32 + tid;

  float qr[HD], o[HD];
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S) x = *reinterpret_cast<const float4*>(q + head0 + row * row_stride + d);
    qr[d] = x.x; qr[d + 1] = x.y; qr[d + 2] = x.z; qr[d + 3] = x.w;
    o[d] = o[d + 1] = o[d + 2] = o[d + 3] = 0.f;
  }
  float m = -1e30f, l = 0.f;

  for (int key0 = 0; key0 < S; key0 += BK32) {
    __syncthreads();  // the previous tile's reads of Ks / Vs are done
    bool live = false;
    if (tid < BK32) {
      const int key = key0 + tid;
      const float kb = key < S ? bias[(long long)b * S + key] : NEG_BIAS;
      bs[tid] = kb;
      live = kb > NEG_BIAS * 0.5f;
    }
    for (int i = tid; i < BK32 * (HD / 4); i += BQ32) {
      const int key = i / (HD / 4), c = (i % (HD / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key0 + key < S) {
        kv = *reinterpret_cast<const float4*>(k + head0 + (key0 + key) * row_stride + c);
        vv = *reinterpret_cast<const float4*>(v + head0 + (key0 + key) * row_stride + c);
      }
      *reinterpret_cast<float4*>(&Ks[key][c]) = kv;
      *reinterpret_cast<float4*>(&Vs[key][c]) = vv;
    }
    if (!__syncthreads_or(live)) continue;  // an all-padding key tile

    float s[BK32];
    float mx = -1e30f;
#pragma unroll
    for (int j = 0; j < BK32; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[j][d]);
        acc = fmaf(qr[d], kk.x, acc);
        acc = fmaf(qr[d + 1], kk.y, acc);
        acc = fmaf(qr[d + 2], kk.z, acc);
        acc = fmaf(qr[d + 3], kk.w, acc);
      }
      s[j] = __fadd_rn(__fmul_rn(acc, scale), bs[j]);
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx), alpha = expf(m - mn);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK32; ++j) {
      s[j] = expf(s[j] - mn);
      sum += s[j];
    }
    l = l * alpha + sum;
    m = mn;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BK32; ++j)
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[j][d]);
        o[d] = fmaf(s[j], vv.x, o[d]);
        o[d + 1] = fmaf(s[j], vv.y, o[d + 1]);
        o[d + 2] = fmaf(s[j], vv.z, o[d + 2]);
        o[d + 3] = fmaf(s[j], vv.w, o[d + 3]);
      }
  }

  if (row < S) {
    const float inv = l <= 0.f ? 1.f : l;
#pragma unroll
    for (int d = 0; d < HD; d += 4)
      *reinterpret_cast<float4*>(out + head0 + row * row_stride + d) =
          make_float4(__fdiv_rn(o[d], inv), __fdiv_rn(o[d + 1], inv),
                      __fdiv_rn(o[d + 2], inv), __fdiv_rn(o[d + 3], inv));
  }
}

// A [B, S, H, 64] bf16 tensor as a 4-d map (d, head, position, batch) whose
// box is one head's [rows][64] tile, 128-byte swizzled; rows past S read 0.
bool head_tile_map(CUtensorMap* map, const void* base, int B, int S, int H, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {HD, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {HD * 2, (cuuint64_t)H * HD * 2, (cuuint64_t)S * H * HD * 2};
  const cuuint32_t box[4] = {HD, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q, k, v, out: [B, S, H, 64] contiguous and 16-byte aligned, all bf16
// (f32 == 0) or all f32 (f32 == 1); bias: [B, S] f32. Launches on `stream`;
// allocates nothing. Returns 0 or the CUDA error code (cudaGetLastError after
// the launch; cudaErrorNotSupported when the driver gives no tensor map).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* out, int B, int S, int H, int D,
                                      int f32, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D != HD || (long long)B * H > 65535 ||
      (f32 != 0 && f32 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32) {
    const dim3 grid((S + BQ32 - 1) / BQ32, B * H);
    flash_kernel_f32<<<grid, BQ32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(bias),
        static_cast<float*>(out), S, H, scale);
  } else {
    CUtensorMap q_map, k_map, v_map;
    if (!head_tile_map(&q_map, q, B, S, H, BQ) || !head_tile_map(&k_map, k, B, S, H, BK) ||
        !head_tile_map(&v_map, v, B, S, H, BK))
      return static_cast<int>(cudaErrorNotSupported);
    static int allowed_on = -1;  // the device whose limit was raised: once, not a launch
    int device = 0;
    cudaError_t rc = cudaGetDevice(&device);
    if (rc == cudaSuccess && device != allowed_on) {
      rc = cudaFuncSetAttribute(flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)SMEM_BYTES);
      if (rc == cudaSuccess) allowed_on = device;
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const dim3 grid((S + BQ - 1) / BQ, B * H);
    flash_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
        q_map, k_map, v_map, static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(out), S, H, scale * LOG2E);
  }
  return static_cast<int>(cudaGetLastError());
}
