// int4_linear.cu — linears over nibble-packed int4 weights that are decoded
// on the chip, for NVIDIA Hopper (built for sm_90a by
// outline_rag_tpu_torch/ops/_build.py, bound with ctypes by
// outline_rag_tpu_torch/ops/int4_linear.py). Three kernels over one storage
// format:
//
//   w4a8          replaces the Pallas TPU kernel
//                 outline_rag_tpu/ops/int4_linear.py::_w4a8_kernel_v3
//                 (launched by w4a8_matmul)
//   w4a16         replaces ::_w4a16_kernel_v2 and ::_w4a16_kernel (the two
//                 variants of w4a16_matmul; one kernel serves both here)
//   stream_floor  replaces tools/bench_int4_kernel.py::_dma_kernel (launched
//                 by dma_floor)
//
// Storage (the JAX package's bytes): q4 is [N, K/2] uint8, block-pair packed:
// byte 128c + j holds element 256c + j in its LOW nibble as the biased value
// v + 8, and element 256c + 128 + j in its HIGH nibble in two's complement.
// s4 is [N, G] f32, s4[n, g] scaling elements [g * gsz, (g + 1) * gsz) of row
// n. K % 256 == 0, gsz % 128 == 0 (so each 128-element half of a pair block
// lies in one group) and N % 128 == 0. Four consecutive packed bytes are four
// consecutive low elements and four consecutive high elements: one 32-bit
// word decodes into two int8x4 operands with a mask, an XOR and one
// subtraction that cannot borrow across bytes (decode4). The TPU kernel's
// tricks for a vector unit without narrow shifts (the +8 bias folded into a
// correction dot, the high nibble used as 16 * v) are not carried over.
//
// w4a8:   out[m, n] = sum_g s4[n, g] * float(sum_{k in g} xq[m, k] * v[n, k])
//   for xq [M, K] int8 (the wrapper quantizes each row and multiplies the
//   result by the row's scale). The integer sums are exact in int32 (at most
//   gsz * 127 * 8); the f32 sum over groups runs in ascending g, one thread
//   an output, each product and each sum rounded on its own: two runs are
//   bit-equal and a row's result depends on neither M nor its neighbours.
//   Bound on the card: bytes. At decode M <= 32, so a weight byte is read once
//   for 4 * M int8 operations, far below the card's ~590 int8 operations a
//   byte; the packed N * K / 2 bytes at the memory rate are the floor.
//   Design: a warp owns 8 output channels and walks the whole K alone (no
//   split over K, no shared memory, no barrier). A thread loads 16 packed
//   bytes at a time (two 16-byte loads a pair block, the next block's loads
//   issued before this block's products), decodes them in registers, and
//   feeds mma.sync.m16n8k32 (s8 x s8 -> s32) with them as the B operand; the
//   A operand is 16-byte loads of xq through L1 (xq is M * K bytes, shared by
//   every warp of the card). The contraction index inside one instruction is
//   permuted (the same way for A and B: thread t's four registers hold 16
//   consecutive elements), which an exact integer sum allows. 16 * MT rows a
//   block, MT in {1, 2, 4} by M, blocks over N and row tiles only.
//
// w4a16:  out[m, n] = sum_k x[m, k] * dt(float(v[n, k]) * s4[n, g(k)]), f32
//   accumulation, for x in dt (bf16 or f32): the unbiased decode, the product
//   v * s formed in f32 (__fmul_rn, so that it cannot be fused into the sum)
//   and rounded once to dt. bf16: the shape of int8_linear.cu, a 64-element K
//   tile of 32 channels decoded into shared memory as bf16, mma.sync.m16n8k16
//   with f32 accumulation, 64 rows a block. f32: the same tiles as floats and
//   a 4 x 4 register tile of fused multiply-adds in ascending k: true f32, no
//   TF32. Blocks over N and row tiles only; fixed order. Bound: the packed
//   bytes, as above (bf16: 2 * M flops a weight element against ~295 a byte).
//
// stream_floor: the w4a8 kernel's blocks and 16-byte loads with the products
//   taken out: every word of q4 is XOR-folded into one int32 a row (on a GPU
//   a load that nothing uses is not issued), and value[n] = float(q4[n, 0]) *
//   x[0, 0] is what the JAX tool's floor returns. Its time is the packed-byte
//   stream as the card delivers it to this load shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Four nibbles of a packed word as four int8 values, one a byte: the low
// nibbles (biased, v + 8) or the high nibbles (two's complement).
__device__ __forceinline__ uint32_t decode4(uint32_t w, bool hi) {
  const uint32_t nib = (hi ? w >> 4 : w) & 0x0f0f0f0fu;
  const uint32_t u = hi ? nib ^ 0x08080808u : nib;  // both halves biased now
  // u - 8 a byte: (u | 0x80) - 8 never borrows, and the XOR takes 0x80 out
  return ((u | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// ---------------------------------------------------------------------------
// w4a8
// ---------------------------------------------------------------------------

constexpr int W8_WARPS = 2;  // warps a block, 8 output channels each
constexpr int W8_THREADS = W8_WARPS * 32;

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int MT>
__global__ void __launch_bounds__(W8_THREADS)
w4a8_kernel(const int8_t* __restrict__ xq, const uint8_t* __restrict__ q4,
            const float* __restrict__ s4, float* __restrict__ out, int M, int N,
            int K, int gsz) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = (blockIdx.x * W8_WARPS + warp) * 8;
  if (n0 >= N) return;
  const int m0 = blockIdx.y * (16 * MT);
  const int KP = K >> 1, G = K / gsz, chunks = K >> 8;
  // B operand: channel n0 + g, 16 packed bytes at 16 * t of each 64-byte span
  const uint8_t* wrow = q4 + (long long)(n0 + g) * KP + 16 * t;
  // the accumulator's columns are channels n0 + 2t and n0 + 2t + 1
  const float* sc0 = s4 + (long long)(n0 + 2 * t) * G;
  const float* sc1 = sc0 + G;

  int acc[MT][4];
  float sum[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) { acc[mt][i] = 0; sum[mt][i] = 0.f; }

  // a finished group's integer sums join the f32 sums, ascending g
  auto flush = [&](int grp) {
    const float s0 = sc0[grp], s1 = sc1[grp];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      sum[mt][0] = __fadd_rn(sum[mt][0], __fmul_rn(s0, __int2float_rn(acc[mt][0])));
      sum[mt][1] = __fadd_rn(sum[mt][1], __fmul_rn(s1, __int2float_rn(acc[mt][1])));
      sum[mt][2] = __fadd_rn(sum[mt][2], __fmul_rn(s0, __int2float_rn(acc[mt][2])));
      sum[mt][3] = __fadd_rn(sum[mt][3], __fmul_rn(s1, __int2float_rn(acc[mt][3])));
      acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0;
    }
  };
  // 128 elements from kbase on: the low or the high nibbles of one pair block
  auto half = [&](const uint4& w0, const uint4& w1, int kbase, bool hi) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4& w = i ? w1 : w0;
      const uint32_t b0 = decode4(w.x, hi), b1 = decode4(w.y, hi);
      const uint32_t b2 = decode4(w.z, hi), b3 = decode4(w.w, hi);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = m0 + mt * 16 + g, r1 = r0 + 8;
        const long long off = kbase + 64 * i + 16 * t;
        uint4 x0 = make_uint4(0, 0, 0, 0), x1 = make_uint4(0, 0, 0, 0);
        if (r0 < M) x0 = ldg16(xq + (long long)r0 * K + off);
        if (r1 < M) x1 = ldg16(xq + (long long)r1 * K + off);
        mma_s8(acc[mt], x0.x, x1.x, x0.y, x1.y, b0, b1);
        mma_s8(acc[mt], x0.z, x1.z, x0.w, x1.w, b2, b3);
      }
    }
  };

  uint4 w0 = ldg16(wrow), w1 = ldg16(wrow + 64);
  for (int c = 0; c < chunks; ++c) {
    const uint4 c0 = w0, c1 = w1;
    if (c + 1 < chunks) {  // in flight during this block's products
      w0 = ldg16(wrow + 128 * (c + 1));
      w1 = ldg16(wrow + 128 * (c + 1) + 64);
    }
    const int e = c << 8;
    const int gl = e / gsz, gh = (e + 128) / gsz, gn = (e + 256) / gsz;
    half(c0, c1, e, false);
    if (gh != gl) flush(gl);
    half(c0, c1, e + 128, true);
    if (gn != gh) flush(gh);  // the last block ends the last group: gn == G
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = m0 + mt * 16 + g, r1 = r0 + 8;
    float* o = out + n0 + 2 * t;
    if (r0 < M) *reinterpret_cast<float2*>(o + (long long)r0 * N) = make_float2(sum[mt][0], sum[mt][1]);
    if (r1 < M) *reinterpret_cast<float2*>(o + (long long)r1 * N) = make_float2(sum[mt][2], sum[mt][3]);
  }
}

template <int MT>
int launch_w4a8(const void* xq, const void* q4, const void* s4, void* out, int M,
                int N, int K, int gsz, cudaStream_t s) {
  const dim3 grid((N / 8 + W8_WARPS - 1) / W8_WARPS, (M + 16 * MT - 1) / (16 * MT));
  w4a8_kernel<MT><<<grid, W8_THREADS, 0, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const uint8_t*>(q4),
      static_cast<const float*>(s4), static_cast<float*>(out), M, N, K, gsz);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// stream floor
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(W8_THREADS)
stream_floor_kernel(const void* __restrict__ x, int x_f32,
                    const uint8_t* __restrict__ q4, float* __restrict__ value,
                    int* __restrict__ fold, int N, int KP) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = (blockIdx.x * W8_WARPS + warp) * 8;
  if (n0 >= N) return;
  const uint8_t* wrow = q4 + (long long)(n0 + g) * KP + 16 * t;
  uint32_t acc = 0;
  for (int c = 0; c < KP / 128; ++c) {
    const uint4 a = ldg16(wrow + 128 * c), b = ldg16(wrow + 128 * c + 64);
    acc ^= a.x ^ a.y ^ a.z ^ a.w ^ b.x ^ b.y ^ b.z ^ b.w;
  }
  acc ^= __shfl_xor_sync(0xffffffffu, acc, 1);  // the row's four threads
  acc ^= __shfl_xor_sync(0xffffffffu, acc, 2);
  if (t == 0) {
    fold[n0 + g] = static_cast<int>(acc);
    const float x00 = x_f32 ? static_cast<const float*>(x)[0]
                            : __bfloat162float(static_cast<const __nv_bfloat16*>(x)[0]);
    value[n0 + g] = __fmul_rn(static_cast<float>(q4[(long long)(n0 + g) * KP]), x00);
  }
}

// ---------------------------------------------------------------------------
// w4a16
// ---------------------------------------------------------------------------

constexpr int BM = 64;         // rows of x per block
constexpr int BN = 32;         // output channels per block
constexpr int BK = 64;         // contraction tile: half of a 128-element half
constexpr int A16_THREADS = 128;
constexpr int SP = BK + 8;     // shared row stride, bf16: conflict-free reads
constexpr int FP = BK + 4;     // shared row stride, f32

// The 16 weights of this thread for the tile at k0: channel row `wrow`
// (packed) and `srow` (scales), tile columns wc .. wc + 15.
struct WeightWord {
  uint4 w;
  float s;
  bool hi;
};

__device__ __forceinline__ WeightWord load_weights(const uint8_t* wrow,
                                                   const float* srow, int k0,
                                                   int wc, int gsz) {
  const int c = k0 >> 8, r = k0 & 255;  // pair block, and the offset in it
  WeightWord out;
  out.hi = r >= 128;
  out.w = ldg16(wrow + 128 * c + (r & 127) + wc);
  out.s = srow[k0 / gsz];
  return out;
}

// float(v) * s for the 16 weights, the product rounded on its own
__device__ __forceinline__ void dequant16(const WeightWord& ww, float (&v)[16]) {
  const uint32_t w[4] = {ww.w.x, ww.w.y, ww.w.z, ww.w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t d = decode4(w[j], ww.hi);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      v[4 * j + b] = __fmul_rn(static_cast<float>(static_cast<int8_t>(d >> (8 * b))), ww.s);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(A16_THREADS)
w4a16_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ q4, const float* __restrict__ s4,
                  float* __restrict__ out, int M, int N, int K, int gsz) {
  __shared__ __align__(16) __nv_bfloat16 Xs[BM][SP];
  __shared__ __align__(16) __nv_bfloat16 Ws[BN][SP];
  constexpr int XV = BM * BK / 8 / A16_THREADS;  // 16-byte x loads per thread: 4

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wn = tid >> 2, wc = (tid & 3) * 16;  // this thread's channel and columns
  const uint8_t* wrow = q4 + (long long)(n0 + wn) * (K >> 1);
  const float* srow = s4 + (long long)(n0 + wn) * (K / gsz);

  uint4 xr[XV];
  WeightWord wr;
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int v = tid + i * A16_THREADS, r = v >> 3, c = (v & 7) * 8;
      xr[i] = make_uint4(0, 0, 0, 0);
      if (m0 + r < M) xr[i] = ldg16(x + (long long)(m0 + r) * K + k0 + c);
    }
    wr = load_weights(wrow, srow, k0, wc, gsz);
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int v = tid + i * A16_THREADS, r = v >> 3, c = (v & 7) * 8;
      *reinterpret_cast<uint4*>(&Xs[r][c]) = xr[i];
    }
    float wf[16];
    dequant16(wr, wf);
    __align__(16) __nv_bfloat16 w16[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w16[i] = __float2bfloat16_rn(wf[i]);
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
    float* o = out + n0 + j * 8 + 2 * t;
    if (r0 < M) *reinterpret_cast<float2*>(o + (long long)r0 * N) = make_float2(acc[j][0], acc[j][1]);
    if (r1 < M) *reinterpret_cast<float2*>(o + (long long)r1 * N) = make_float2(acc[j][2], acc[j][3]);
  }
}

__global__ void __launch_bounds__(A16_THREADS)
w4a16_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q4,
                 const float* __restrict__ s4, float* __restrict__ out, int M,
                 int N, int K, int gsz) {
  __shared__ __align__(16) float Xs[BM][FP];
  __shared__ __align__(16) float Ws[BN][FP];
  constexpr int XV = BM * BK / 4 / A16_THREADS;  // 16-byte x loads per thread: 8

  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;  // channels tx + 8j, rows ty + 16i
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wn = tid >> 2, wc = (tid & 3) * 16;
  const uint8_t* wrow = q4 + (long long)(n0 + wn) * (K >> 1);
  const float* srow = s4 + (long long)(n0 + wn) * (K / gsz);

  uint4 xr[XV];
  WeightWord wr;
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int v = tid + i * A16_THREADS, r = v >> 4, c = (v & 15) * 4;
      xr[i] = make_uint4(0, 0, 0, 0);
      if (m0 + r < M) xr[i] = ldg16(x + (long long)(m0 + r) * K + k0 + c);
    }
    wr = load_weights(wrow, srow, k0, wc, gsz);
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < XV; ++i) {
      const int v = tid + i * A16_THREADS, r = v >> 4, c = (v & 15) * 4;
      *reinterpret_cast<uint4*>(&Xs[r][c]) = xr[i];
    }
    float wf[16];
    dequant16(wr, wf);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&Ws[wn][wc + 4 * i]) =
          make_float4(wf[4 * i], wf[4 * i + 1], wf[4 * i + 2], wf[4 * i + 3]);
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    store_tile();
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float4 xa[4], wb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xa[i] = *reinterpret_cast<const float4*>(&Xs[ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) wb[j] = *reinterpret_cast<const float4*>(&Ws[tx + 8 * j][kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // ascending k
          acc[i][j] = __fmaf_rn(xa[i].x, wb[j].x, acc[i][j]);
          acc[i][j] = __fmaf_rn(xa[i].y, wb[j].y, acc[i][j]);
          acc[i][j] = __fmaf_rn(xa[i].z, wb[j].z, acc[i][j]);
          acc[i][j] = __fmaf_rn(xa[i].w, wb[j].w, acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(long long)r * N + n0 + tx + 8 * j] = acc[i][j];
  }
}

bool int4_shape_ok(int M, int N, int K, int gsz) {
  return M > 0 && M <= 256 && N > 0 && K > 0 && gsz > 0 && K % 256 == 0 &&
         gsz % 128 == 0 && K % gsz == 0 && N % 128 == 0;
}

}  // namespace

// xq: [M, K] int8; q4: [N, K/2] uint8; s4: [N, K/gsz] f32; out: [M, N] f32,
// all contiguous and 16-byte aligned. 1 <= M <= 256, K % 256 == 0,
// gsz % 128 == 0, N % 128 == 0. Launches on `stream`; allocates nothing.
// Returns 0 or the CUDA error code.
extern "C" int int4_w4a8_launch(const void* xq, const void* q4, const void* s4,
                                void* out, int M, int N, int K, int gsz,
                                void* stream) {
  if (!int4_shape_ok(M, N, K, gsz)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) return launch_w4a8<1>(xq, q4, s4, out, M, N, K, gsz, s);
  if (M <= 32) return launch_w4a8<2>(xq, q4, s4, out, M, N, K, gsz, s);
  return launch_w4a8<4>(xq, q4, s4, out, M, N, K, gsz, s);
}

// x: [M, K] bf16 (x_f32 == 0) or f32 (x_f32 == 1), which is also the type
// the weights are decoded to; the other operands and the limits as above.
extern "C" int int4_w4a16_launch(const void* x, const void* q4, const void* s4,
                                 void* out, int M, int N, int K, int gsz,
                                 int x_f32, void* stream) {
  if (!int4_shape_ok(M, N, K, gsz) || (x_f32 != 0 && x_f32 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  if (x_f32)
    w4a16_f32_kernel<<<grid, A16_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(q4),
        static_cast<const float*>(s4), static_cast<float*>(out), M, N, K, gsz);
  else
    w4a16_bf16_kernel<<<grid, A16_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q4),
        static_cast<const float*>(s4), static_cast<float*>(out), M, N, K, gsz);
  return static_cast<int>(cudaGetLastError());
}

// x: the activations, bf16 (x_f32 == 0) or f32 (x_f32 == 1), of which only
// x[0, 0] is read; q4: [N, KP] uint8, KP % 128 == 0, N % 8 == 0; value: [N]
// f32; fold: [N] int32.
extern "C" int int4_stream_floor_launch(const void* x, int x_f32, const void* q4,
                                        void* value, void* fold, int N, int KP,
                                        void* stream) {
  if (N <= 0 || KP <= 0 || KP % 128 || N % 8 || (x_f32 != 0 && x_f32 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N / 8 + W8_WARPS - 1) / W8_WARPS);
  stream_floor_kernel<<<grid, W8_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_f32, static_cast<const uint8_t*>(q4), static_cast<float*>(value),
      static_cast<int*>(fold), N, KP);
  return static_cast<int>(cudaGetLastError());
}
