// int4_linear.cu — linears over nibble-packed int4 weights that are decoded
// on the chip, for NVIDIA Hopper (built for sm_90a by
// outline_rag_tpu_torch/ops/_build.py, bound with ctypes by
// outline_rag_tpu_torch/ops/int4_linear.py). Three kernels over one storage
// format, and the row quantizer that feeds the first:
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
// quant_rows: xq[m, k] = int8(clamp(rint(x[m, k] / xs[m]), -127, 127)) with
//   xs[m] = max(max_k |x[m, k]| / 127, 1e-12), for x bf16 or f32: the per-row
//   activation quantization of w4a8 (outline_rag_tpu/ops/int4_linear.py:190-193,
//   the recipe of w8a8_matmul), in one launch. True divisions and round half
//   to even, so codes and scale bits equal the plain version's. One block a
//   row: a maximum by warp shuffles and one shared-memory step, then the row
//   again (from L1) in 16-element pieces, 16-byte loads and stores. Bound:
//   the launch; a decode step's rows are a few KB each.
//
// w4a8:   out[m, n] = xs[m] * sum_g s4[n, g] * float(sum_{k in g} xq[m, k] * v[n, k])
//   for xq [M, K] int8 and xs [M] f32 from quant_rows, written as f32 or
//   rounded once to bf16. The integer sums are exact in int32 (at most
//   gsz * 127 * 8); the f32 sum over groups runs in ascending g, one thread
//   an output, each product and each sum rounded on its own: two runs are
//   bit-equal and a row's result depends on neither M nor its neighbours.
//   Bound on the card: bytes. At decode M <= 32, so a weight byte is read once
//   for 4 * M int8 operations, far below the card's ~590 int8 operations a
//   byte; the packed N * K / 2 bytes at the memory rate are the floor, and a
//   projection is 2.6-33 MB: a few microseconds, of which the launch and one
//   round trip to device memory are a large part. A grid of short blocks runs
//   in waves that each first load and then compute, and the memory idles in
//   between; so the blocks stay and the loads run ahead of the products.
//   Design: one block an SM (16 warps) walks its share of the items: an item
//   is 32 output channels over one slab of K (8 pair blocks, 2,048 elements),
//   every gridDim.x-th channel tile, a slab after the other. An item's 32 KB of
//   packed weights and its group scales are requested by cp.async into a ring
//   in shared memory one item (M <= 16: three items) before they are used, so
//   the stream from device memory does not stop for the products; the block's
//   rows of xq are staged once (K <= 2,048; else a slab an item) and reused by
//   every item, so xq is read from L2 once a block, not once a warp. Within an
//   item warp w takes pair block w % 8 and two of the four channel tiles:
//   nibbles are decoded in registers (decode4) into the B operand of
//   mma.sync.m16n8k32 (s8 x s8 -> s32); the contraction index inside one
//   instruction is permuted the same way for A and B (thread t's four
//   registers hold 16 consecutive elements), which an exact integer sum
//   allows. Each warp leaves the exact int32 sums of its two 128-element
//   halves in shared memory; after one barrier one thread an output adds the
//   slab's halves in ascending k into the group's integer sum and, where a
//   group ends, into the f32 sum (__fmul_rn, __fadd_rn). Integer sums are
//   exact, so which warp computed a half cannot change a bit. The epilogue
//   multiplies by xs[m]. What holds it at about twice its stream floor: the
//   int8 mma.sync instruction itself (the products of an item take longer than
//   its bytes take to arrive), and two barriers an item.
//
// w4a16:  out[m, n] = sum_k x[m, k] * dt(float(v[n, k]) * s4[n, g(k)]), f32
//   accumulation, for x in dt (bf16 or f32): the unbiased decode, the product
//   v * s formed in f32 (__fmul_rn, so that it cannot be fused into the sum)
//   and rounded once to dt. Bound: the packed bytes, as above (bf16: 2 * M
//   flops a weight element against ~295 a byte).
//   bf16: w4a8's blocks, items and ring (request_weights), written as f32 or
//   rounded once to bf16 by its epilogue, so that the decoder's projection is
//   one launch. Within an item warp w takes a 64-byte span of pair block w / 2
//   (64 low and 64 high elements) for all the item's channels and rows:
//   nibbles are decoded in registers (decode_bf16x4) straight into the B
//   operand of mma.sync.m16n8k16 (bf16 -> f32), and the A operand, the
//   block's rows of x for the warp's 128 elements (64 registers at 32 rows),
//   stays in registers for every item of a slab, so x is read from L2 once a
//   block and a slab. Each warp leaves its f32 sums in shared memory; after
//   one barrier one thread an output adds the 16 warps' sums in a fixed
//   order. The split of K (slabs, pair blocks, spans, k-steps) and the order
//   of every sum depend on K alone, so two runs are bit-equal and a row's
//   result depends on neither M nor its neighbours. What holds it: no one
//   part (tools/ablate_w4a16.py times copies with one taken out): an item's
//   chain of wait, barrier, decode (a byte permute, a subtraction, a product
//   and half a conversion a weight, 4,096 weights a warp), mma, barrier and
//   fold takes longer than its bytes take to arrive, and every block reads
//   all of x from L2 (32 rows x K x 2 bytes: more than its weights at
//   K = 2,048). Items are 16 channels where N / 32 tiles would leave SMs idle
//   (N <= 4,096 on 132 SMs).
//   f32 (no served configuration runs it): a 64-element K tile of 32
//   channels decoded into shared memory, 64 rows a block, a 4 x 4 register
//   tile of fused multiply-adds in ascending k: true f32, no TF32.
//
// stream_floor: the w4a8 kernel's blocks and loads (one block an SM walking
//   items of 32 channels x 2,048 elements through a cp.async ring, here four
//   deep since nothing else needs the shared memory) with the products taken
//   out: every word of q4 is XOR-folded into one int32 a row (on a GPU
//   a load that nothing uses is not issued), and value[n] = float(q4[n, 0]) *
//   x[0, 0] is what the JAX tool's floor returns. Its time is the packed-byte
//   stream as the card delivers it to this load shape.

#include "hopper_tma.cuh"

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
// row quantizer
// ---------------------------------------------------------------------------

constexpr int QR_THREADS = 256;

__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
    v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 w = ldg16(reinterpret_cast<const uint4*>(p) + i);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a bf16 is the high half of its f32
      v[8 * i + 2 * j] = __uint_as_float(u[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(QR_THREADS)
quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                  float* __restrict__ xs, int K) {
  __shared__ float red[QR_THREADS / 32];
  const T* row = x + (long long)blockIdx.x * K;
  float v[16];
  float amax = 0.f;  // a maximum: its order does not matter
  for (int e = threadIdx.x * 16; e < K; e += QR_THREADS * 16) {
    load16(row + e, v);
#pragma unroll
    for (int i = 0; i < 16; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < QR_THREADS / 32; ++i) amax = fmaxf(amax, red[i]);
  const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
  if (threadIdx.x == 0) xs[blockIdx.x] = s;
  int8_t* qrow = xq + (long long)blockIdx.x * K;
  for (int e = threadIdx.x * 16; e < K; e += QR_THREADS * 16) {
    load16(row + e, v);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float q = fminf(fmaxf(rintf(__fdiv_rn(v[4 * i + b], s)), -127.f), 127.f);
        w[i] |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xffu) << (8 * b);
      }
    }
    *reinterpret_cast<uint4*>(qrow + e) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---------------------------------------------------------------------------
// w4a8
// ---------------------------------------------------------------------------

constexpr int W8_WARPS = 16;
constexpr int W8_THREADS = W8_WARPS * 32;
constexpr int W8_CHUNKS = 8;               // pair blocks in a slab of K (2,048 elements)
constexpr int W8_HALVES = 2 * W8_CHUNKS;   // 128-element halves in a slab
constexpr int W8_CB = 32;                  // channels in an item
constexpr int W8_WROW = 1024 + 64;         // staged bytes between two channels' rows
constexpr int W8_ITEM = W8_CB * W8_WROW + W8_HALVES * W8_CB * 4;  // weights, group scales

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One item of the w4a8 and w4a16 kernels requested into its ring slot: the
// packed bytes of channels [n0, n0 + CB) over one slab of K (a channel's row
// W8_WROW bytes after the one before; a partial last slab only its pair
// blocks), then the group scale of each of the slab's 128-element halves,
// [half][channel]. One cp.async group is committed by the caller.
template <int CB>
__device__ __forceinline__ void request_weights(uint8_t* slot, const uint8_t* __restrict__ q4,
                                                const float* __restrict__ s4, int n0, int slab,
                                                int chunks, int G, int gsz, int tid) {
  const int KP = chunks * 128;
  const int slab_bytes = min(chunks - slab * W8_CHUNKS, W8_CHUNKS) * 128;
#pragma unroll
  for (int j = 0; j < CB * 64 / W8_THREADS; ++j) {  // 64 pieces of 16 bytes a channel
    const int piece = tid + W8_THREADS * j, ch = piece >> 6, col = (piece & 63) * 16;
    if (col < slab_bytes)
      cp_async16(slot + ch * W8_WROW + col,
                 q4 + (long long)(n0 + ch) * KP + slab * (W8_CHUNKS * 128) + col, true);
  }
  if (tid < W8_HALVES * CB) {  // one scale a thread
    const int hh = tid & (W8_HALVES - 1), ch = tid >> 4;
    const int grp = min((slab * W8_HALVES + hh) * 128 / gsz, G - 1);
    cp_async4(slot + CB * W8_WROW + (hh * CB + ch) * 4, s4 + (long long)(n0 + ch) * G + grp);
  }
}

// Raises a kernel's limit of dynamic shared memory on the current device:
// once a device, not at every launch.
template <typename Kernel>
int allow_smem(Kernel* kernel, int bytes, int& allowed_on) {
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess && device != allowed_on) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc == cudaSuccess) allowed_on = device;
  }
  return static_cast<int>(rc);
}

// Shared memory of the w4a8 kernel, for 16 * MT rows a block:
//   rows   the block's rows of xq for one slab, [pair block][row][256 bytes],
//          the 16-byte pieces of a row swapped in fours on odd rows so that a
//          quarter warp's reads (rows g, g + 1; four pieces) are conflict-free;
//   sums   the exact int32 sums of a slab's halves, [half][row][channel], the
//          row stride padded so that a warp's 8-byte stores (rows g, channels
//          2t) and the fold's 4-byte loads (consecutive channels) are too;
//   ring   STAGES items: 32 channels' packed bytes of one slab (rows W8_WROW
//          apart: conflict-free again) and the group scale of each half;
//   and the rows' scales.
template <int MT>
struct W8Smem {
  static constexpr int ROWS = 16 * MT, PS = W8_CB + 8;
  static constexpr int STAGES = MT == 1 ? 4 : 2;  // what fits beside rows and sums
  static constexpr int XQ = W8_CHUNKS * ROWS * 256;
  static constexpr int SUMS = W8_HALVES * ROWS * PS * 4;
  static constexpr int BYTES = XQ + SUMS + STAGES * W8_ITEM + ROWS * 4;
};

template <int MT>
__global__ void __launch_bounds__(W8_THREADS, 1)
w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
            const uint8_t* __restrict__ q4, const float* __restrict__ s4,
            void* __restrict__ out, int out_bf16, int M, int N, int K, int gsz) {
  using L = W8Smem<MT>;
  constexpr int ROWS = L::ROWS, PS = L::PS, STAGES = L::STAGES;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* rows = smem;
  int* sums = reinterpret_cast<int*>(smem + L::XQ);
  uint8_t* ring = smem + L::XQ + L::SUMS;
  float* rscale = reinterpret_cast<float*>(ring + STAGES * W8_ITEM);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wc = warp & 7;   // this warp's pair block of the slab
  const int wh = warp >> 3;  // and its two of the item's four channel tiles
  const int m0 = blockIdx.y * ROWS;
  const int G = K / gsz, chunks = K >> 8;
  const int slabs = (chunks + W8_CHUNKS - 1) / W8_CHUNKS;
  // items of this block: its channel tiles (every gridDim.x-th), a slab each
  const int tiles = N / W8_CB;
  const int n_items = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * slabs;

  // The packed weights and group scales of item `it`, requested into its slot
  // of the ring STAGES - 1 items before they are used: the stream from device
  // memory never waits for the products.
  auto request_item = [&](int it) {
    if (it < n_items)
      request_weights<W8_CB>(ring + it % STAGES * W8_ITEM, q4, s4,
                             (blockIdx.x + it / slabs * gridDim.x) * W8_CB, it % slabs, chunks, G,
                             gsz, tid);
    cp_async_commit();
  };
  // The block's rows of xq, the columns of one slab.
  auto request_rows = [&](int slab) {
#pragma unroll
    for (int j = 0; j < W8_CHUNKS * ROWS * 16 / W8_THREADS; ++j) {
      const int piece = tid + W8_THREADS * j;
      const int p16 = piece & 15, r = (piece >> 4) % ROWS, c = piece / (16 * ROWS);
      const bool live = m0 + r < M && slab * W8_CHUNKS + c < chunks;
      const long long at = (long long)(m0 + r) * K + (slab * W8_CHUNKS + c) * 256 + p16 * 16;
      cp_async16(rows + (c * ROWS + r) * 256 + ((p16 ^ ((r & 1) << 2)) << 4), xq + (live ? at : 0),
                 live);
    }
    cp_async_commit();
  };

  if (tid < ROWS) rscale[tid] = m0 + tid < M ? __ldg(xs + m0 + tid) : 0.f;
  if (slabs == 1) request_rows(0);  // one slab: the rows stay for every item
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) request_item(it);

  // the fold: this thread's channel and first row, and its sums
  const int fc = tid % W8_CB, fr = tid / W8_CB;
  const int group_halves = gsz >> 7;  // 128-element halves in a scale group
  int gacc[MT], in_group = 0;
  float fsum[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) { gacc[i] = 0; fsum[i] = 0.f; }

  for (int it = 0; it < n_items; ++it) {
    const int n0 = (blockIdx.x + it / slabs * gridDim.x) * W8_CB, slab = it % slabs;
    const uint8_t* slot = ring + it % STAGES * W8_ITEM;
    cp_async_wait<STAGES - 2>();  // this thread's pieces of item `it` are there
    __syncthreads();              // everyone's; and the item before is folded
    if (slabs > 1) request_rows(slab);
    request_item(it + STAGES - 1);  // into the slot of the item before
    if (slabs > 1) {
      cp_async_wait<1>();  // the rows; the item just requested may be in flight
      __syncthreads();
    }

    if (slab * W8_CHUNKS + wc < chunks) {
      const uint8_t* wsm = slot + (wh * 16 + g) * W8_WROW + 128 * wc + 16 * t;
      const uint8_t* xsm = rows + wc * ROWS * 256;
      int acc[2][MT][2][4];  // [half][row tile][channel tile]
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2)
            acc[half][mt][c2][0] = acc[half][mt][c2][1] = acc[half][mt][c2][2] =
                acc[half][mt][c2][3] = 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // the two 64-byte spans of the pair block
        uint4 ww[2];
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2)
          ww[c2] = *reinterpret_cast<const uint4*>(wsm + c2 * 8 * W8_WROW + 64 * i);
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // the low, then the high nibbles
          uint4 x0[MT], x1[MT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int r = mt * 16 + g, p16 = 8 * half + 4 * i + t;
            const uint8_t* px = xsm + r * 256 + ((p16 ^ ((r & 1) << 2)) << 4);
            x0[mt] = *reinterpret_cast<const uint4*>(px);
            x1[mt] = *reinterpret_cast<const uint4*>(px + 8 * 256);
          }
          uint32_t b[2][4];
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            b[c2][0] = decode4(ww[c2].x, half);
            b[c2][1] = decode4(ww[c2].y, half);
            b[c2][2] = decode4(ww[c2].z, half);
            b[c2][3] = decode4(ww[c2].w, half);
          }
          // consecutive instructions go to different accumulators
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_s8(acc[half][mt][c2], x0[mt].x, x1[mt].x, x0[mt].y, x1[mt].y, b[c2][0],
                     b[c2][1]);
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_s8(acc[half][mt][c2], x0[mt].z, x1[mt].z, x0[mt].w, x1[mt].w, b[c2][2],
                     b[c2][3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            int* p = sums + ((2 * wc + half) * ROWS + mt * 16 + g) * PS + (2 * wh + c2) * 8 + 2 * t;
            const int(&a)[4] = acc[half][mt][c2];
            *reinterpret_cast<int2*>(p) = make_int2(a[0], a[1]);
            *reinterpret_cast<int2*>(p + 8 * PS) = make_int2(a[2], a[3]);
          }
    }
    __syncthreads();

    // the slab's halves join the sums in ascending k: integers inside a
    // group, and a finished group's sum joins the f32 sum, ascending g
    const float* gscale = reinterpret_cast<const float*>(slot + W8_CB * W8_WROW);
    const int hn = min(2 * (chunks - slab * W8_CHUNKS), W8_HALVES);
    auto fold = [&](int hh) {
#pragma unroll
      for (int i = 0; i < MT; ++i) gacc[i] += sums[(hh * ROWS + fr + 16 * i) * PS + fc];
      if (++in_group == group_halves) {  // the group ends with this half
        in_group = 0;
        const float sc = gscale[hh * W8_CB + fc];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          fsum[i] = __fadd_rn(fsum[i], __fmul_rn(sc, __int2float_rn(gacc[i])));
          gacc[i] = 0;
        }
      }
    };
    if (hn == W8_HALVES) {  // a whole slab: unrolled, its loads issued together
#pragma unroll
      for (int hh = 0; hh < W8_HALVES; ++hh) fold(hh);
    } else {
      for (int hh = 0; hh < hn; ++hh) fold(hh);
    }

    if (slab == slabs - 1) {  // the channel tile is complete: the row scale, out[m, n]
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = fr + 16 * i;
        if (m0 + r < M) {
          const float val = __fmul_rn(fsum[i], rscale[r]);
          const long long at = (long long)(m0 + r) * N + n0 + fc;
          if (out_bf16)
            static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(val);
          else
            static_cast<float*>(out)[at] = val;
        }
        gacc[i] = 0;
        fsum[i] = 0.f;
      }
      in_group = 0;
    }
  }
  cp_async_wait<0>();
}

// The SMs of the current device: a block a SM walks the channel tiles.
int sm_count() {
  static int count[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return 1;
  if (count[device] == 0 &&
      cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    count[device] = 1;
  return count[device];
}

template <int MT>
int launch_w4a8(const void* xq, const void* xs, const void* q4, const void* s4, void* out,
                int out_bf16, int M, int N, int K, int gsz, cudaStream_t s) {
  constexpr int smem = W8Smem<MT>::BYTES;
  static int allowed_on = -1;
  if (const int rc = allow_smem(w4a8_kernel<MT>, smem, allowed_on)) return rc;
  const dim3 grid(min(N / W8_CB, sm_count()), (M + 16 * MT - 1) / (16 * MT));
  w4a8_kernel<MT><<<grid, W8_THREADS, smem, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(q4), static_cast<const float*>(s4), out, out_bf16, M, N, K,
      gsz);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// stream floor
// ---------------------------------------------------------------------------

constexpr int FLOOR_STAGES = 4;
constexpr int FLOOR_SMEM = FLOOR_STAGES * W8_CB * W8_WROW + W8_CHUNKS * W8_CB * 4;

__global__ void __launch_bounds__(W8_THREADS, 1)
stream_floor_kernel(const void* __restrict__ x, int x_f32,
                    const uint8_t* __restrict__ q4, float* __restrict__ value,
                    int* __restrict__ fold, int N, int KP) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;  // FLOOR_STAGES items of packed bytes, as in the w4a8 kernel
  uint32_t* part = reinterpret_cast<uint32_t*>(smem + FLOOR_STAGES * W8_CB * W8_WROW);  // [8][32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wc = warp & 7, wh = warp >> 3;
  const int chunks = KP / 128, slabs = (chunks + W8_CHUNKS - 1) / W8_CHUNKS;
  const int tiles = (N + W8_CB - 1) / W8_CB;
  const int n_items = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * slabs;
  auto request_item = [&](int it) {
    if (it < n_items) {
      const int n0 = (blockIdx.x + it / slabs * gridDim.x) * W8_CB, slab = it % slabs;
      uint8_t* slot = ring + it % FLOOR_STAGES * (W8_CB * W8_WROW);
      const int slab_bytes = min(chunks - slab * W8_CHUNKS, W8_CHUNKS) * 128;
#pragma unroll
      for (int j = 0; j < W8_CB * 64 / W8_THREADS; ++j) {
        const int piece = tid + W8_THREADS * j, ch = piece >> 6, col = (piece & 63) * 16;
        const bool live = n0 + ch < N;
        if (col < slab_bytes)
          cp_async16(slot + ch * W8_WROW + col,
                     q4 + (live ? (long long)(n0 + ch) * KP + slab * (W8_CHUNKS * 128) + col : 0),
                     live);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < FLOOR_STAGES - 1; ++it) request_item(it);
  uint32_t acc[2] = {0, 0};  // this warp's pair blocks of its two channel tiles, row g
  for (int it = 0; it < n_items; ++it) {
    const int n0 = (blockIdx.x + it / slabs * gridDim.x) * W8_CB, slab = it % slabs;
    const uint8_t* slot = ring + it % FLOOR_STAGES * (W8_CB * W8_WROW);
    cp_async_wait<FLOOR_STAGES - 2>();
    __syncthreads();
    request_item(it + FLOOR_STAGES - 1);
    if (slab * W8_CHUNKS + wc < chunks) {
      const uint8_t* wsm = slot + (wh * 16 + g) * W8_WROW + 128 * wc + 16 * t;
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint4 w = *reinterpret_cast<const uint4*>(wsm + c2 * 8 * W8_WROW + 64 * i);
          acc[c2] ^= w.x ^ w.y ^ w.z ^ w.w;
        }
    }
    if (slab == slabs - 1) {  // the tile's rows are complete
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        acc[c2] ^= __shfl_xor_sync(0xffffffffu, acc[c2], 1);  // the row's four threads
        acc[c2] ^= __shfl_xor_sync(0xffffffffu, acc[c2], 2);
        if (t == 0) part[wc * W8_CB + (2 * wh + c2) * 8 + g] = acc[c2];
        acc[c2] = 0;
      }
      __syncthreads();
      const int n = n0 + tid;
      if (tid < W8_CB && n < N) {
        uint32_t r = 0;
#pragma unroll
        for (int i = 0; i < W8_CHUNKS; ++i) r ^= part[i * W8_CB + tid];
        fold[n] = static_cast<int>(r);
        const float x00 = x_f32 ? static_cast<const float*>(x)[0]
                                : __bfloat162float(static_cast<const __nv_bfloat16*>(x)[0]);
        value[n] = __fmul_rn(static_cast<float>(q4[(long long)n * KP]), x00);
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// w4a16, bf16
// ---------------------------------------------------------------------------

constexpr int A16_STAGES = 4;  // ring slots: three items in flight while one is used

// Shared memory of the bf16 w4a16 kernel for 16 * MT rows and items of CB
// channels: the f32 partial sums of the slab's 16 warps, [warp][row][channel]
// (row stride padded: a warp's 8-byte stores, rows g and channels 2t, are
// conflict-free), and the ring: A16_STAGES items in w4a8's layout.
template <int MT, int CB>
struct A16Smem {
  static constexpr int ROWS = 16 * MT, PS = CB + 8;
  static constexpr int SLOT = CB * W8_WROW + W8_HALVES * CB * 4;
  static constexpr int SUMS = W8_WARPS * ROWS * PS * 4;
  static constexpr int BYTES = SUMS + A16_STAGES * SLOT;
  static_assert(BYTES <= 232448, "a block's shared memory on Hopper");
};

// bf16(float(v) * s) for the four low (hi == 0) or high nibbles of a packed
// word, as two bf16x2 words: elements 0, 1 and 2, 3. The biased nibble u = v
// + 8 is put under the exponent of 2^23 (one byte permute), so that
// subtracting 2^23 + 8 gives float(v) exactly; the product with the scale
// is rounded on its own, then to bf16.
__device__ __forceinline__ void decode_bf16x4(uint32_t w, int hi, float s, uint32_t& b0,
                                              uint32_t& b1) {
  const uint32_t u = hi ? ((w >> 4) & 0x0f0f0f0fu) ^ 0x08080808u : w & 0x0f0f0f0fu;
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __fmul_rn(__fsub_rn(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440 + b)),
                               8388616.f),
                     s);
  b0 = pack_bf16(f[0], f[1]);
  b1 = pack_bf16(f[2], f[3]);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warp w of an item takes pair block w / 2 of the slab and, of its 128
// packed bytes, the 64-byte span w % 2: thread t the 16 bytes 16t of the
// span, which are 16 low and 16 high elements; for CB / 8 channel tiles and
// every row. The contraction index inside an instruction is permuted alike
// for A and B (k-step s of the low or high elements takes the thread's
// elements 4s .. 4s + 3 where the instruction numbers them 2t, 2t + 1, 2t + 8,
// 2t + 9), so that its weights are one 16-byte load from the ring and its
// activations 16-byte loads of x. A warp's sum over its 128 elements is one
// mma chain in a fixed order; the fold adds the 16 warps' sums in ascending
// warp order: a function of K alone, never of M, the grid or the row.
template <int MT, int CB>
__global__ void __launch_bounds__(W8_THREADS, 1)
w4a16_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q4,
                  const float* __restrict__ s4, void* __restrict__ out, int out_bf16, int M,
                  int N, int K, int gsz) {
  using L = A16Smem<MT, CB>;
  constexpr int ROWS = L::ROWS, PS = L::PS, STAGES = A16_STAGES;
  constexpr int FR = W8_THREADS / CB;                               // fold: rows apart
  constexpr int FOLDS = (ROWS * CB + W8_THREADS - 1) / W8_THREADS;  // outputs a thread
  extern __shared__ __align__(16) uint8_t smem[];
  float* sums = reinterpret_cast<float*>(smem);
  uint8_t* ring = smem + L::SUMS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wc = warp >> 1;  // this warp's pair block of the slab
  const int ws = warp & 1;   // and its 64-byte span of the pair block
  const int m0 = blockIdx.y * ROWS;
  const int G = K / gsz, chunks = K >> 8;
  const int slabs = (chunks + W8_CHUNKS - 1) / W8_CHUNKS;
  // items of this block: its channel tiles (every gridDim.x-th), a slab each
  const int n_items = (N / CB - blockIdx.x + gridDim.x - 1) / gridDim.x * slabs;

  auto request_item = [&](int it) {
    if (it < n_items)
      request_weights<CB>(ring + it % STAGES * L::SLOT, q4, s4,
                          (blockIdx.x + it / slabs * gridDim.x) * CB, it % slabs, chunks, G, gsz,
                          tid);
    cp_async_commit();
  };
  // This thread's activations for one slab, kept in registers across the
  // items of that slab: [row tile][row g, g + 8][low, high elements][the
  // 8 words of its 16 elements]; zero past M.
  uint32_t xa[MT][2][2][8];
  auto load_x = [&](int slab) {
    const bool live_c = slab * W8_CHUNKS + wc < chunks;
    const int col = slab * (W8_CHUNKS * 256) + 256 * wc + 64 * ws + 16 * t;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int r = m0 + mt * 16 + 8 * r2 + g;
        const bool live = live_c && r < M;
#pragma unroll
        for (int nib = 0; nib < 2; ++nib)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint4 v = live ? ldg16(x + (long long)r * K + col + 128 * nib + 8 * h)
                                 : make_uint4(0, 0, 0, 0);
            xa[mt][r2][nib][4 * h] = v.x;
            xa[mt][r2][nib][4 * h + 1] = v.y;
            xa[mt][r2][nib][4 * h + 2] = v.z;
            xa[mt][r2][nib][4 * h + 3] = v.w;
          }
      }
  };

#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) request_item(it);
  load_x(0);

  const int fc = tid % CB, fr = tid / CB;  // the fold: this thread's channel and first row
  float fsum[FOLDS];
#pragma unroll
  for (int i = 0; i < FOLDS; ++i) fsum[i] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    const int n0 = (blockIdx.x + it / slabs * gridDim.x) * CB, slab = it % slabs;
    const uint8_t* slot = ring + it % STAGES * L::SLOT;
    const int cs = min(chunks - slab * W8_CHUNKS, W8_CHUNKS);  // pair blocks in this slab
    cp_async_wait<STAGES - 2>();  // this thread's pieces of item `it` are there
    __syncthreads();              // everyone's; and the item before is folded
    request_item(it + STAGES - 1);  // into the slot of the item before

    if (wc < cs) {
      const float* gscale = reinterpret_cast<const float*>(slot + CB * W8_WROW);
#pragma unroll
      for (int nt = 0; nt < CB / 8; ++nt) {
        const int ch = nt * 8 + g;
        const uint4 w4 = *reinterpret_cast<const uint4*>(slot + ch * W8_WROW + 128 * wc +
                                                         64 * ws + 16 * t);
        const uint32_t ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float sc[2] = {gscale[2 * wc * CB + ch], gscale[(2 * wc + 1) * CB + ch]};
        float acc[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
#pragma unroll
        for (int nib = 0; nib < 2; ++nib)
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            uint32_t b0, b1;
            decode_bf16x4(ww[s], nib, sc[nib], b0, b1);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const uint32_t a[4] = {xa[mt][0][nib][2 * s], xa[mt][1][nib][2 * s],
                                     xa[mt][0][nib][2 * s + 1], xa[mt][1][nib][2 * s + 1]};
              mma_bf16(acc[mt], a, b0, b1);
            }
          }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float* p = sums + (warp * ROWS + mt * 16 + g) * PS + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(p) = make_float2(acc[mt][0], acc[mt][1]);
          *reinterpret_cast<float2*>(p + 8 * PS) = make_float2(acc[mt][2], acc[mt][3]);
        }
      }
    }
    // the next slab's activations, in flight during the fold and the wait
    if (slabs > 1 && it + 1 < n_items) load_x((it + 1) % slabs);
    __syncthreads();

    // the warps' sums join each output's sum in ascending warp order
    const int parts = 2 * cs;
#pragma unroll
    for (int i = 0; i < FOLDS; ++i) {
      const int r = fr + FR * i;
      if (r < ROWS) {
        const float* p = sums + r * PS + fc;
        if (parts == 2 * W8_CHUNKS) {  // a whole slab: unrolled, its loads issued together
#pragma unroll
          for (int w = 0; w < 2 * W8_CHUNKS; ++w) fsum[i] = __fadd_rn(fsum[i], p[w * ROWS * PS]);
        } else {
          for (int w = 0; w < parts; ++w) fsum[i] = __fadd_rn(fsum[i], p[w * ROWS * PS]);
        }
      }
    }

    if (slab == slabs - 1) {  // the channel tile is complete: out[m, n]
#pragma unroll
      for (int i = 0; i < FOLDS; ++i) {
        const int r = fr + FR * i;
        if (r < ROWS && m0 + r < M) {
          const long long at = (long long)(m0 + r) * N + n0 + fc;
          if (out_bf16)
            static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(fsum[i]);
          else
            static_cast<float*>(out)[at] = fsum[i];
        }
        fsum[i] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
}

template <int MT, int CB>
int launch_w4a16(const void* x, const void* q4, const void* s4, void* out, int out_bf16, int M,
                 int N, int K, int gsz, cudaStream_t s) {
  constexpr int smem = A16Smem<MT, CB>::BYTES;
  static int allowed_on = -1;
  if (const int rc = allow_smem(w4a16_bf16_kernel<MT, CB>, smem, allowed_on)) return rc;
  const dim3 grid(min(N / CB, sm_count()), (M + 16 * MT - 1) / (16 * MT));
  w4a16_bf16_kernel<MT, CB><<<grid, W8_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q4),
      static_cast<const float*>(s4), out, out_bf16, M, N, K, gsz);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// w4a16, f32
// ---------------------------------------------------------------------------

constexpr int BM = 64;         // rows of x per block
constexpr int BN = 32;         // output channels per block
constexpr int BK = 64;         // contraction tile: half of a 128-element half
constexpr int A16_THREADS = 128;
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

// x: [M, K] bf16 (x_f32 == 0) or f32 (x_f32 == 1); xq: [M, K] int8; xs: [M]
// f32; all contiguous and 16-byte aligned, K % 16 == 0. Launches on
// `stream`; allocates nothing. Returns 0 or the CUDA error code.
extern "C" int int4_quant_rows_launch(const void* x, int x_f32, void* xq, void* xs,
                                      int M, int K, void* stream) {
  if (M <= 0 || K <= 0 || K % 16 || (x_f32 != 0 && x_f32 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    quant_rows_kernel<float><<<M, QR_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs), K);
  else
    quant_rows_kernel<__nv_bfloat16><<<M, QR_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(xs), K);
  return static_cast<int>(cudaGetLastError());
}

// xq: [M, K] int8; xs: [M] f32 row scales; q4: [N, K/2] uint8; s4: [N, K/gsz]
// f32; out: [M, N] f32 (out_bf16 == 0) or bf16 (out_bf16 == 1), all
// contiguous and 16-byte aligned. 1 <= M <= 256, K % 256 == 0,
// gsz % 128 == 0, N % 128 == 0. Launches on `stream`; allocates nothing.
// Returns 0 or the CUDA error code.
extern "C" int int4_w4a8_launch(const void* xq, const void* xs, const void* q4,
                                const void* s4, void* out, int out_bf16, int M, int N,
                                int K, int gsz, void* stream) {
  if (!int4_shape_ok(M, N, K, gsz) || (out_bf16 != 0 && out_bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16 or 32 rows a block; more rows are more blocks over the same channels
  if (M <= 16) return launch_w4a8<1>(xq, xs, q4, s4, out, out_bf16, M, N, K, gsz, s);
  return launch_w4a8<2>(xq, xs, q4, s4, out, out_bf16, M, N, K, gsz, s);
}

// x: [M, K] bf16 (x_f32 == 0) or f32 (x_f32 == 1), which is also the type
// the weights are decoded to; out: [M, N] f32 (out_bf16 == 0) or, for bf16
// x, bf16 (out_bf16 == 1); the other operands and the limits as above.
extern "C" int int4_w4a16_launch(const void* x, const void* q4, const void* s4, void* out,
                                 int out_bf16, int M, int N, int K, int gsz, int x_f32,
                                 void* stream) {
  if (!int4_shape_ok(M, N, K, gsz) || (x_f32 != 0 && x_f32 != 1) ||
      (out_bf16 != 0 && out_bf16 != 1) || (x_f32 && out_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32) {
    const dim3 grid(N / BN, (M + BM - 1) / BM);
    w4a16_f32_kernel<<<grid, A16_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(q4),
        static_cast<const float*>(s4), static_cast<float*>(out), M, N, K, gsz);
    return static_cast<int>(cudaGetLastError());
  }
  // 16 or 32 rows a block, more rows more blocks over the same channels; items
  // of 16 channels where those of 32 would leave SMs without one. Neither
  // choice moves a bit: a k-step of an output is the same instruction in
  // every tile, and the fold's order depends on K alone.
  const bool narrow = N / 32 < sm_count();
  if (M <= 16)
    return narrow ? launch_w4a16<1, 16>(x, q4, s4, out, out_bf16, M, N, K, gsz, s)
                  : launch_w4a16<1, 32>(x, q4, s4, out, out_bf16, M, N, K, gsz, s);
  return narrow ? launch_w4a16<2, 16>(x, q4, s4, out, out_bf16, M, N, K, gsz, s)
                : launch_w4a16<2, 32>(x, q4, s4, out, out_bf16, M, N, K, gsz, s);
}

// x: the activations, bf16 (x_f32 == 0) or f32 (x_f32 == 1), of which only
// x[0, 0] is read; q4: [N, KP] uint8, KP % 128 == 0, N % 8 == 0; value: [N]
// f32; fold: [N] int32.
extern "C" int int4_stream_floor_launch(const void* x, int x_f32, const void* q4,
                                        void* value, void* fold, int N, int KP,
                                        void* stream) {
  if (N <= 0 || KP <= 0 || KP % 128 || N % 8 || (x_f32 != 0 && x_f32 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  static int allowed_on = -1;
  if (const int rc = allow_smem(stream_floor_kernel, FLOOR_SMEM, allowed_on)) return rc;
  const dim3 grid(min((N + W8_CB - 1) / W8_CB, sm_count()));
  stream_floor_kernel<<<grid, W8_THREADS, FLOOR_SMEM, static_cast<cudaStream_t>(stream)>>>(
      x, x_f32, static_cast<const uint8_t*>(q4), static_cast<float*>(value),
      static_cast<int*>(fold), N, KP);
  return static_cast<int>(cudaGetLastError());
}
