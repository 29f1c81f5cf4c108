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
// dense) are the ceiling; the inputs are O(S * D) bytes. The design keeps
// the [S, S] logits out of device memory entirely.
//
// bf16 design (FlashAttention-2 shape, simple first; wgmma, TMA, double-buffered
// tiles and warp specialisation are later work):
//   one block of 4 warps per (batch * head, 64-query tile); each warp owns
//   16 query rows, whose Q fragments stay in registers. The block walks the
//   64-key tiles: K is staged row-major and V transposed in shared memory
//   (so both feed mma.sync's B operand with conflict-free 32-bit reads),
//   S = Q K^T and O += P V run on mma.sync.m16n8k16 (bf16 in, f32
//   accumulate), and the softmax statistics of each row live in the 4 lanes
//   that hold it (reduced with two shuffles). P goes from the S accumulator
//   registers straight into the A fragments of P V.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;           // head dim
constexpr int BQ = 64;           // query rows per block (16 per warp)
constexpr int BK = 64;           // keys per tile
constexpr int KP = HD + 8;       // Ks row stride (bf16): conflict-free reads
constexpr int VP = BK + 8;       // Vt row stride (bf16)
constexpr int THREADS = 128;
constexpr float NEG_BIAS = -1e9f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&h);
}

// D[16x8] += A[16x16] . B[16x8], bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
             int S, int H, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BK][KP];   // [key][d]
  __shared__ __align__(16) __nv_bfloat16 Vt[HD][VP];   // [d][key]
  __shared__ float bs[BK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long row_stride = (long long)H * HD;  // elements between positions
  const long long head0 = (long long)b * S * row_stride + (long long)h * HD;
  const int q_row0 = blockIdx.x * BQ + warp * 16;

  // Q fragments (A operand) for rows g and g + 8 of the warp, all of D
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q_row0 + g + (r & 1) * 8;
      const int d = kk * 16 + (r >> 1) * 8 + 2 * t;
      qa[kk][r] = row < S ? *reinterpret_cast<const uint32_t*>(
                                q + head0 + row * row_stride + d)
                          : 0u;
    }

  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;  // rows g, g + 8

  for (int key0 = 0; key0 < S; key0 += BK) {
    __syncthreads();  // the previous tile's reads of Ks / Vt are done
    bool live = false;
    if (tid < BK) {
      const int key = key0 + tid;
      const float kb = key < S ? bias[(long long)b * S + key] : NEG_BIAS;
      bs[tid] = kb;
      live = kb > NEG_BIAS * 0.5f;
    }
    // K: 8 lanes per key row, 16 bytes each, stored row-major
    for (int i = tid; i < BK * (HD / 8); i += THREADS) {
      const int key = i >> 3, c = (i & 7) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (key0 + key < S)
        val = *reinterpret_cast<const uint4*>(k + head0 + (key0 + key) * row_stride + c);
      *reinterpret_cast<uint4*>(&Ks[key][c]) = val;
    }
    // V: consecutive lanes take consecutive keys, so the transposed 2-byte
    // stores of a warp land in distinct banks
    for (int i = tid; i < BK * (HD / 8); i += THREADS) {
      const int key = i % BK, c = (i / BK) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (key0 + key < S)
        val = *reinterpret_cast<const uint4*>(v + head0 + (key0 + key) * row_stride + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[c + j][key] = e[j];
    }
    if (!__syncthreads_or(live)) continue;  // an all-padding key tile

    // S = Q K^T: 8 column tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Ks[j * 8 + g][kk * 16 + 2 * t]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Ks[j * 8 + g][kk * 16 + 8 + 2 * t]);
        mma_bf16(s[j], qa[kk], b0, b1);
      }
    }
    // s * scale + bias; the tile's row maxima
    float mx0 = -1e30f, mx1 = -1e30f;  // every s is far above (>= ~-1e9)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b_lo = bs[j * 8 + 2 * t], b_hi = bs[j * 8 + 2 * t + 1];
      s[j][0] = __fadd_rn(__fmul_rn(s[j][0], scale), b_lo);
      s[j][1] = __fadd_rn(__fmul_rn(s[j][1], scale), b_hi);
      s[j][2] = __fadd_rn(__fmul_rn(s[j][2], scale), b_lo);
      s[j][3] = __fadd_rn(__fmul_rn(s[j][3], scale), b_hi);
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] *= alpha0;
      o[j][1] *= alpha0;
      o[j][2] *= alpha1;
      o[j][3] *= alpha1;
    }
    // O += bf16(P) V: the S accumulators of key tiles 2kk, 2kk+1 are the A
    // fragment of the kk-th 16-key step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Vt[j * 8 + g][kk * 16 + 2 * t]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Vt[j * 8 + g][kk * 16 + 8 + 2 * t]);
        mma_bf16(o[j], pa, b0, b1);
      }
    }
  }

  const float inv0 = l0 <= 0.f ? 1.f : l0, inv1 = l1 <= 0.f ? 1.f : l1;
  const int r0 = q_row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = j * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + head0 + r0 * row_stride + d) =
          pack_bf16(__fdiv_rn(o[j][0], inv0), __fdiv_rn(o[j][1], inv0));
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(out + head0 + r1 * row_stride + d) =
          pack_bf16(__fdiv_rn(o[j][2], inv1), __fdiv_rn(o[j][3], inv1));
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

}  // namespace

// q, k, v, out: [B, S, H, 64] contiguous, all bf16 (f32 == 0) or all f32
// (f32 == 1); bias: [B, S] f32. Launches on `stream`; allocates nothing.
// Returns 0 or the CUDA error code (cudaGetLastError after the launch).
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
    const dim3 grid((S + BQ - 1) / BQ, B * H);
    flash_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(out), S, H, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
