// int8_linear.cu — w8a16 linear: bf16 activations times int8 weights that
// are decoded on the chip, for NVIDIA Hopper (built for sm_90a by
// outline_rag_tpu_torch/ops/_build.py, bound with ctypes by
// outline_rag_tpu_torch/ops/int8_linear.py::int8_linear).
//
// Replaces the Pallas TPU kernel outline_rag_tpu/ops/int8_linear.py::_kernel
// (launched by int8_linear). For x [M, K] bf16, w_q [N, K] int8 and
// per-output-channel scales s [N] f32 it computes
//
//     w[n, k]   = bf16(float(w_q[n, k]) * bf16(s[n]))    (the product rounded
//                                                         once, then to bf16)
//     out[m, n] = sum_k x[m, k] * w[n, k]                 (f32 accumulate)
//
// written as bf16 or f32. The decoded weight never reaches device memory.
//
// What bounds it on the card. The decoder calls it for every projection of a
// TinyLlama-width model at M = 64 (a decode step) and M = 256 (a prefill
// chunk). At M = 64 a weight byte is read once for 128 operations, below the
// card's ~295 a byte in bf16: the N * K weight bytes at the memory rate are
// the floor (23 MB and 7 us for the 2,048 x 11,264 gate/up projection). At
// M = 256 it is 512 operations a byte: the bf16 tensor cores are the floor
// (12 us at gate/up), and only wgmma reaches their full rate.
//
// It replaces a kernel of blocks of 32 channels x 64 rows, each walking all
// of K with one 16-byte weight load a thread in flight and two barriers a
// tile, and each reading its rows of x again from L2: at the narrow
// projections (N = 2,048: 64 blocks on 132 SMs) far too few bytes were in
// flight for the memory rate, and mma.sync from shared memory held M = 256.
//
// Design:
//   - The products are wgmma.mma_async m64n64k16 with the operands swapped:
//     64 decoded weight channels are the A operand, from registers, and 64
//     rows of x the B operand, from shared memory as the TMA leaves it
//     (K-major, 128-byte swizzle). A warpgroup's decoded weights serve every
//     row tile of its block (up to four: 256 rows), so a weight is decoded
//     once a block, and no thread spends an instruction on x.
//   - A block is two warpgroups, 128 channels, which share each x tile.
//     Thread 0 walks the block's 64-element chunks of K through a ring:
//     per chunk two TMA copies, the x tile [rows][64] and the weight tile
//     [channels][64] (64-byte swizzle, so that the 4-byte reads of the decode
//     are conflict-free), refilled as soon as every warp has let a slot go.
//     Rows past M, channels past N and columns past K read 0.
//   - A thread decodes its A fragment of a k-step (two channels, four k each)
//     from two 32-bit words: a byte permute under 2^23 and an exact
//     subtraction give float(q), __fmul_rn by the bf16-rounded scale, then
//     cvt.rn.bf16x2. It decodes the next chunk while the tensor cores work on
//     this one (one wgmma group in flight, two sets of A fragments).
//   - K is split four ways across a cluster of four blocks (a fixed share of
//     the chunks each, a function of K alone): the narrow projections get
//     64-80 blocks, and every block a quarter of x. Once its last chunk is
//     consumed, a block leaves its partial sums where the ring was; the four
//     partials of an output are added in ascending split order through
//     distributed shared memory, by one thread of the cluster.
//   - Every output goes through the same instruction shape in every row tile
//     (rows are padded to 64, never a narrower wgmma), its k-steps in
//     ascending order inside a split and its splits in a fixed order: two
//     runs are bit-equal and a row's result depends on neither M nor its
//     neighbours. A partial chunk at the end of K issues only its whole
//     k-steps; a split without a chunk is not folded.
//
// What still holds it (tools/ablate_int8_linear.py times copies with one part
// taken out): at M = 64 a block lives for eight chunks (K = 2,048), so its
// chain of wgmma groups, its decode and the cluster's fold are not hidden
// behind other work. Tried on copies and not kept (each slower): persistent
// clusters walking the channel tiles, deeper rings, x multicast to two
// neighbouring channel tiles, blocks of 64 or 128 rows at M = 256, and two
// accumulator chains a split (a little faster at M = 64, but at more rows
// their sums must wait in shared memory that the ring then lacks).

#include "hopper_tma.cuh"

namespace {

constexpr int KC = 64;      // elements of K a chunk (one ring slot)
constexpr int CH = 64;      // output channels a consumer warpgroup: wgmma's M
constexpr int ROWS = 64;    // rows of x a row tile: wgmma's N, for every M
constexpr int WGS = 2;      // consumer warpgroups a block: 128 channels
constexpr int TILE = WGS * CH;
constexpr int SPLITS = 4;   // blocks of a cluster; K's chunks are split among them
constexpr int MAX_RT = 4;   // row tiles a block: 256 rows

// Shared memory of a block with RT row tiles: the ring (STAGES slots, each
// the x tile then the weight tile; multiples of 1,024 bytes, the 128-byte
// swizzle's period), which the partial sums of the tile [row][channel] take
// over after the last chunk, then the ring's mbarriers. Stages: six at one
// row tile (two blocks an SM), as many as fit at four.
template <int RT>
struct Smem {
  static constexpr int STAGES = RT == MAX_RT ? 5 : 6;
  static constexpr int X_BYTES = RT * ROWS * KC * 2;
  static constexpr int W_BYTES = WGS * CH * KC;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int PS = TILE + 4;  // partial row stride (floats): conflict-free stores
  static constexpr int PART = RT * ROWS * PS * 4;
  static constexpr int MAIN = RING > PART ? RING : PART;
  static constexpr int BYTES = MAIN + 2 * STAGES * 8 + 1024;  // and room to align
  static_assert(BYTES <= 232448, "a block's shared memory on Hopper");
};

// bf16(float(q) * sc) for the two int8 codes of `w` that sel0 and sel1 pick
// (0x7440 + byte index), as one bf16x2 word. q + 128 is put under the
// exponent of 2^23 (one byte permute), so that subtracting 2^23 + 128 gives
// float(q) exactly; the product with the scale is rounded on its own, then
// to bf16.
__device__ __forceinline__ uint32_t decode2(uint32_t w, uint32_t sel0, uint32_t sel1, float sc) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b000000u, sel0)), 8388736.f);
  const float f1 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b000000u, sel1)), 8388736.f);
  return pack_bf16(__fmul_rn(f0, sc), __fmul_rn(f1, sc));
}

// ---- wgmma -----------------------------------------------------------------

// d[64 channels x 64 rows] += W[64 x 16] . X[64 x 16]^T: W from registers
// (the A fragment), the x tile from shared memory, K-major.
__device__ __forceinline__ void wgmma_wx(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

// The A fragments of one chunk's four k-steps for this thread: channels
// `row` and `row + 8` of its warpgroup's weight tile (64-byte rows, 64-byte
// swizzle: piece p of row r lies at piece p ^ ((r >> 1) & 3)); k-step s
// takes k 2t, 2t + 1 from word t / 2 of piece s and k 2t + 8, 2t + 9 from
// word 2 + t / 2, the pair at byte 2 (t % 2) of each.
__device__ __forceinline__ void decode_chunk(uint32_t (&a)[4][4], const uint8_t* wtile, int row,
                                             int t, const float (&sc)[2]) {
  const uint32_t sel0 = 0x7440u + 2 * (t & 1), sel1 = sel0 + 1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ch = row + 8 * r;
    const uint8_t* base = wtile + ch * KC + 4 * (t >> 1);
    const int sw = (ch >> 1) & 3;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint8_t* piece = base + ((s ^ sw) << 4);
      a[s][r] = decode2(*reinterpret_cast<const uint32_t*>(piece), sel0, sel1, sc[r]);
      a[s][2 + r] = decode2(*reinterpret_cast<const uint32_t*>(piece + 8), sel0, sel1, sc[r]);
    }
  }
}

template <int RT>
__global__ void __cluster_dims__(1, SPLITS, 1) __launch_bounds__(128 * WGS, 1)
int8_linear_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map, const float* __restrict__ s,
                   void* __restrict__ out, int M, int N, int K, int out_f32) {
  using L = Smem<RT>;
  constexpr int STAGES = L::STAGES, PS = L::PS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* part = reinterpret_cast<float*>(smem);  // after the last chunk
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::MAIN);
  uint64_t* empty = full + STAGES;

  // warp and split are what the compiler can see to be uniform (a shuffle,
  // a block index): a wgmma under a branch it cannot is serialized. The
  // cluster is the four blocks of one blockIdx.x and z, its rank blockIdx.y.
  const int tid = threadIdx.x, lane = tid & 31, warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int split = blockIdx.y;
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.z * (MAX_RT * ROWS);
  // this block's chunks of K, c0 .. c0 + nc - 1: a share that depends on K alone
  const int chunks = (K + KC - 1) / KC, per = (chunks + SPLITS - 1) / SPLITS;
  const int c0 = min(split * per, chunks), nc = min(c0 + per, chunks) - c0;
  const int live_splits = (chunks + per - 1) / per;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);         // the request's one arrival
      mbar_init(&empty[i], 4 * WGS);  // one a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Chunk c0 + p into its ring slot: two TMA copies, issued by thread 0 (no
  // thread spends an instruction on a byte of them).
  auto request = [&](int p) {
    const int st = p % STAGES, c = c0 + p;
    uint8_t* slot = smem + st * L::STAGE;
    mbar_arrive_expect_tx(&full[st], L::STAGE);
    tma_load(slot, &x_map, &full[st], c * KC, m0);
    tma_load(slot + L::X_BYTES, &w_map, &full[st], c * KC, n0);
  };
  if (tid == 0)
    for (int p = 0; p < min(STAGES, nc); ++p) request(p);

  // ---- warpgroup wg: 64 channels of the tile, every row tile ----
  const int wg = warp >> 2, t = lane & 3;
  const int row = (warp & 3) * 16 + (lane >> 2);  // its channels: row, row + 8 of the 64
  float sc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n0 + wg * CH + row + 8 * r;
    sc[r] = n < N ? __bfloat162float(__float2bfloat16_rn(s[n])) : 0.f;
  }
  float acc[RT][32];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[rt][i] = 0.f;

  // chunk c0 + p's A fragments, once its slot is full
  auto decode = [&](uint32_t(&frag)[4][4], int p) {
    mbar_wait(&full[p % STAGES], (p / STAGES) & 1);
    decode_chunk(frag, smem + (p % STAGES) * L::STAGE + L::X_BYTES + wg * CH * KC, row, t, sc);
  };
  // its products, one wgmma group: its whole k-steps, every row tile
  auto issue = [&](const uint32_t(&frag)[4][4], int p) {
    const uint8_t* xtile = smem + (p % STAGES) * L::STAGE;
    const int steps = min(KC, K - (c0 + p) * KC) / 16;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (s < steps) {
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
          wgmma_wx(acc[rt], frag[s], tile_desc(xtile + rt * (ROWS * KC * 2)) + 2 * s);
      }
    wgmma_commit();
  };
  // its group is done: the slot goes back, and thread 0 refills it with the
  // chunk STAGES places later once every warp has let it go
  auto release = [&](int p) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[p % STAGES]);
    if (tid == 0 && p + STAGES < nc) {
      mbar_wait(&empty[p % STAGES], (p / STAGES) & 1);
      request(p + STAGES);
    }
    __syncwarp();
  };

  // One group in flight while the next chunk is decoded: the A fragments
  // alternate between two sets, and a set is written again only after the
  // group that reads it is complete.
  if (nc > 0) {
    uint32_t a0[4][4], a1[4][4];
    decode(a0, 0);
    for (int p = 0; p < nc; p += 2) {
      issue(a0, p);
      if (p > 0) {
        wgmma_wait<1>();
        release(p - 1);
      }
      if (p + 1 == nc) break;
      decode(a1, p + 1);
      issue(a1, p + 1);
      wgmma_wait<1>();
      release(p);
      if (p + 2 < nc) decode(a0, p + 2);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) pin(acc[rt]);
    release(nc - 1);
  }

  // the split's partial sums, [row][channel], where the ring was
  __syncthreads();  // every warp is past its last chunk
  const int ch = wg * CH + row;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* p = part + (rt * ROWS + 8 * j + 2 * t) * PS + ch;
      p[0] = acc[rt][4 * j];
      p[PS] = acc[rt][4 * j + 1];
      p[8] = acc[rt][4 * j + 2];
      p[PS + 8] = acc[rt][4 * j + 3];
    }
  cluster_sync();

  // the fold: this block adds the four splits' partials of a quarter of the
  // rows, in ascending split order, and writes them
  constexpr int C4 = TILE / 4, QROWS = RT * ROWS / SPLITS;
  for (int i = tid; i < QROWS * C4; i += blockDim.x) {
    const int r = split * QROWS + i / C4, c = 4 * (i % C4);
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;  // N % 8 == 0: four channels are in or out together
    const uint32_t local = smem_u32(part + r * PS + c);
    float4 v = ld_cluster(local, 0);
    for (int p = 1; p < live_splits; ++p) {
      const float4 u = ld_cluster(local, p);
      v.x = __fadd_rn(v.x, u.x);
      v.y = __fadd_rn(v.y, u.y);
      v.z = __fadd_rn(v.z, u.z);
      v.w = __fadd_rn(v.w, u.w);
    }
    const long long at = (long long)m * N + n;
    if (out_f32) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + at) = v;
    } else {
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + at) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
  }
  cluster_sync();  // no block leaves while another reads its partials
}

// A row-major [rows][cols] matrix as a 2-d map whose box is [box_rows][64]
// elements; what lies past the matrix reads 0.
bool matrix_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* base,
                int rows, int cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {KC, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int RT>
int launch(const void* x, const void* wq, const void* s, void* out, int M, int N, int K,
           int out_f32, cudaStream_t stream) {
  using L = Smem<RT>;
  CUtensorMap x_map, w_map;
  if (!matrix_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, RT * ROWS,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !matrix_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, N, K, TILE,
                  CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorNotSupported);
  static int allowed_on = -1;  // the device whose limit was raised: once, not a launch
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess && device != allowed_on) {
    rc = cudaFuncSetAttribute(int8_linear_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              L::BYTES);
    if (rc == cudaSuccess) allowed_on = device;
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((N + TILE - 1) / TILE, SPLITS, (M + MAX_RT * ROWS - 1) / (MAX_RT * ROWS));
  int8_linear_kernel<RT><<<grid, 128 * WGS, L::BYTES, stream>>>(
      x_map, w_map, static_cast<const float*>(s), out, M, N, K, out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [M, K] bf16; wq: [N, K] int8; s: [N] f32; out: [M, N] bf16 (out_f32 ==
// 0) or f32 (out_f32 == 1); all contiguous, x, wq and out 16-byte aligned.
// K is a multiple of 16 and N of 8; M at most 65535 * 256. Launches on
// `stream`; allocates nothing. Returns 0 or the CUDA error code
// (cudaErrorNotSupported when the driver gives no tensor map).
extern "C" int int8_linear_launch(const void* x, const void* wq, const void* s,
                                  void* out, int M, int N, int K, int out_f32,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 8 ||
      (M + MAX_RT * ROWS - 1) / (MAX_RT * ROWS) > 65535 || (out_f32 != 0 && out_f32 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // row tiles a block: as many as M needs, up to four; no choice moves a
  // bit, since an output's k-steps and its fold are the same at every M
  if (M <= ROWS) return launch<1>(x, wq, s, out, M, N, K, out_f32, st);
  if (M <= 2 * ROWS) return launch<2>(x, wq, s, out, M, N, K, out_f32, st);
  return launch<4>(x, wq, s, out, M, N, K, out_f32, st);
}
