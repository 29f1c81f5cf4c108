// int8_linear.cu — w8a16 linear: bf16 activations times int8 weights that
// are dequantized tile by tile on the chip, for NVIDIA Hopper (built for
// sm_90a by outline_rag_tpu_torch/ops/_build.py, bound with ctypes by
// outline_rag_tpu_torch/ops/int8_linear.py::int8_linear).
//
// Replaces the Pallas TPU kernel outline_rag_tpu/ops/int8_linear.py::_kernel
// (launched by int8_linear). For x [M, K] bf16, w_q [N, K] int8 and
// per-output-channel scales s [N] f32 it computes
//
//     w[n, k]   = bf16(bf16(w_q[n, k]) * bf16(s[n]))     (the scale is rounded
//                                                         to bf16 first, and so
//                                                         is the product)
//     out[m, n] = sum_k x[m, k] * w[n, k]                 (f32 accumulate)
//
// written as bf16 or f32. The dequantized weight never reaches device memory.
//
// What bounds it on the card: bytes. At decode M is 8-256, so each weight
// byte is read once for 2 * M flops (M = 64: 128 flops a byte against the
// card's ~295 a byte in bf16): the N * K weight bytes at the memory rate are
// the floor (23 MB for the 2048 x 11264 gate/up projection, 7 us).
//
// Design: one block of 4 warps per (32 output channels, 64 rows of x). The
// block walks K in tiles of 64: the int8 weight tile arrives as one 16-byte
// load per thread, is dequantized into shared memory as bf16, and feeds
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) as the B operand; each warp
// owns 16 rows of x and all 32 channels. The next tile's global loads are
// issued before the current tile's products, so they overlap. Blocks over N
// only (and M tiles), no split over K: every output is one block's sum in a
// fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows of x per block (16 per warp)
constexpr int BN = 32;        // output channels per block
constexpr int BK = 64;        // contraction tile
constexpr int SP = BK + 8;    // shared row stride (bf16): conflict-free reads
constexpr int THREADS = 128;
constexpr int XV = BM * BK / 8 / THREADS;  // 16-byte x loads per thread: 4

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
int8_linear_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ wq, const float* __restrict__ s,
                   void* __restrict__ out, int M, int N, int K, int out_f32) {
  __shared__ __align__(16) __nv_bfloat16 Xs[BM][SP];
  __shared__ __align__(16) __nv_bfloat16 Ws[BN][SP];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  // this thread's weight word: channel wn, 16 values from column wc of the tile
  const int wn = tid >> 2, wc = (tid & 3) * 16;
  const bool w_live = n0 + wn < N;
  const float sb =
      w_live ? __bfloat162float(__float2bfloat16_rn(s[n0 + wn])) : 0.f;

  uint4 xr[XV], wr;
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int v = tid + i * THREADS, r = v >> 3, c = (v & 7) * 8;
      xr[i] = make_uint4(0, 0, 0, 0);
      if (m0 + r < M && k0 + c < K)
        xr[i] = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * K + k0 + c);
    }
    wr = make_uint4(0, 0, 0, 0);
    if (w_live && k0 + wc < K)
      wr = *reinterpret_cast<const uint4*>(wq + (long long)(n0 + wn) * K + k0 + wc);
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int v = tid + i * THREADS, r = v >> 3, c = (v & 7) * 8;
      *reinterpret_cast<uint4*>(&Xs[r][c]) = xr[i];
    }
    const int8_t* q8 = reinterpret_cast<const int8_t*>(&wr);
    __align__(16) __nv_bfloat16 w16[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)  // int8 is exact in bf16; the product rounds once
      w16[i] = __float2bfloat16_rn(__fmul_rn(static_cast<float>(q8[i]), sb));
    *reinterpret_cast<uint4*>(&Ws[wn][wc]) = *reinterpret_cast<const uint4*>(&w16[0]);
    *reinterpret_cast<uint4*>(&Ws[wn][wc + 8]) = *reinterpret_cast<const uint4*>(&w16[8]);
  };

  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous tile's reads of Xs / Ws are done
    store_tile();
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);  // in flight during the products
    const int r = warp * 16 + g;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          *reinterpret_cast<const uint32_t*>(&Xs[r][kk * 16 + 2 * t]),
          *reinterpret_cast<const uint32_t*>(&Xs[r + 8][kk * 16 + 2 * t]),
          *reinterpret_cast<const uint32_t*>(&Xs[r][kk * 16 + 8 + 2 * t]),
          *reinterpret_cast<const uint32_t*>(&Xs[r + 8][kk * 16 + 8 + 2 * t]),
      };
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Ws[j * 8 + g][kk * 16 + 2 * t]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Ws[j * 8 + g][kk * 16 + 8 + 2 * t]);
        mma_bf16(acc[j], a, b0, b1);
      }
    }
  }

  const int r0 = m0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + j * 8 + 2 * t;
    if (n >= N) continue;  // N is even: the pair (n, n + 1) is in or out together
    if (out_f32) {
      float* o = static_cast<float*>(out);
      if (r0 < M) *reinterpret_cast<float2*>(o + (long long)r0 * N + n) = make_float2(acc[j][0], acc[j][1]);
      if (r1 < M) *reinterpret_cast<float2*>(o + (long long)r1 * N + n) = make_float2(acc[j][2], acc[j][3]);
    } else {
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
      if (r0 < M) *reinterpret_cast<__nv_bfloat162*>(o + (long long)r0 * N + n) = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
      if (r1 < M) *reinterpret_cast<__nv_bfloat162*>(o + (long long)r1 * N + n) = __floats2bfloat162_rn(acc[j][2], acc[j][3]);
    }
  }
}

}  // namespace

// x: [M, K] bf16; wq: [N, K] int8; s: [N] f32; out: [M, N] bf16 (out_f32 ==
// 0) or f32 (out_f32 == 1), all contiguous. K is a multiple of 16 and N of
// 8 (so every 16-byte load and paired store is whole); M at most 65535 * 64.
// Launches on `stream`; allocates nothing. Returns 0 or the CUDA error code.
extern "C" int int8_linear_launch(const void* x, const void* wq, const void* s,
                                  void* out, int M, int N, int K, int out_f32,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 8 ||
      (M + BM - 1) / BM > 65535 || (out_f32 != 0 && out_f32 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_linear_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(s), out, M, N, K, out_f32);
  return static_cast<int>(cudaGetLastError());
}
