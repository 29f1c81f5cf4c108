// topk_floor.cu — the float scan with its selection taken out: the score
// pass of topk_float.cu followed by nothing but a running maximum per query,
// for NVIDIA Hopper (built for sm_90a by outline_rag_tpu_torch/ops/_build.py,
// bound with ctypes by outline_rag_tpu_torch/ops/topk.py::topk_floor).
//
// Replaces the Pallas TPU kernels of the JAX package's dissection tool,
// tools/bench_topk_kernel.py::_mk_kernel (launched by run_variant) and
// ::_mk_kernel_x2_nomerge (run_x2_nomerge). For each query b it returns
//
//     nomerge:  max over all rows n of score[b, n]
//     matmul:   max over the rows n with n % tile_rows == 0 (a tile's first
//               row: the cheapest consumption of a tile that still needs
//               every score of it computed)
//
// with score as in topk_float.cu (fp32, bf16, or the compensated f32x2 dot;
// no penalty operand), starting from -1e30. The time of the full scan minus
// the time of `nomerge` is what the top-K selection costs; `matmul` against
// `nomerge` is what the per-row maximum costs.
//
// What bounds it on the card: what bounds topk_float.cu's score pass (its
// header says: the corpus bytes for bf16 and f32x2 on the tensor cores, the
// bytes or the FMA rate for fp32), since this kernel is that pass.
//
// Design: pass 1 is scan_kernel's walk over a chunk with score_rows() from
// topk_float_tile.cuh (the same cp.async ring, tensor-core products and
// fp32 tile), so the scores are bit-equal to the full kernel's; each
// thread keeps the maximum of each of its outputs over its tiles in
// registers, and at the end folds them into one maximum per query in shared
// memory (atomicMax on an order-preserving integer image of the float), and
// the block writes [chunks, B] partial maxima. `tile_rows` is a run-time
// argument, so the compiler cannot drop the products of rows that `matmul`
// does not read. Pass 2 takes the maximum over chunks, one thread a query.
// A maximum does not depend on order: two runs are bit-equal.

#include "topk_float_tile.cuh"

namespace {

constexpr float FLOOR_INIT = -1e30f;

// an integer whose order is the float's (for finite values and infinities)
__device__ __forceinline__ int ordered(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float from_ordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

template <int MODE>
__host__ __device__ constexpr int floor_smem() { return ring_bytes<MODE>() + TB * 4; }

template <int MODE>
__global__ void __launch_bounds__(THREADS, Shape<MODE>::MIN_BLOCKS)
floor_kernel(const typename Shape<MODE>::T* __restrict__ q,
             const typename Shape<MODE>::T* __restrict__ corpus, int B, long long N, int D,
             long long rows_per_chunk, int first_row_only, int tile_rows,
             float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* best_q = reinterpret_cast<int*>(smem + ring_bytes<MODE>());  // [TB]
  if (threadIdx.x < TB) best_q[threadIdx.x] = ordered(FLOOR_INIT);

  Scan<MODE> sc{q, corpus, B, D, static_cast<int>(blockIdx.x) * TB, 0, 0};
  const long long chunk = blockIdx.y;
  chunk_rows(chunk, rows_per_chunk, N, sc.row_begin, sc.row_end);
  const long long row_end = sc.row_end;

  using A = Acc<MODE>;
  float best[A::OUTPUTS];  // per output of this thread
#pragma unroll
  for (int i = 0; i < A::OUTPUTS; ++i) best[i] = FLOOR_INIT;
  score_rows<MODE>(sc, smem, [&](long long tile, const auto& acc) {
    acc.visit([&](int i, int r, int, float dot) {
      const long long row = tile + r;
      if (row < row_end && (!first_row_only || row % tile_rows == 0))
        best[i] = fmaxf(best[i], dot);
    });
  });

  __syncthreads();  // best_q's first values are written
  A::place([&](int i, int, int qq) {
    if (best[i] > FLOOR_INIT) atomicMax(best_q + qq, ordered(best[i]));
  });
  __syncthreads();
  const int qq = sc.q0 + threadIdx.x;
  if (threadIdx.x < TB && qq < B) part[chunk * B + qq] = from_ordered(best_q[threadIdx.x]);
}

__global__ void floor_max_kernel(const float* __restrict__ part, int B,
                                 int n_chunks, float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float v = FLOOR_INIT;
  for (int c = 0; c < n_chunks; ++c) v = fmaxf(v, part[(long long)c * B + b]);
  out[b] = v;
}

template <int MODE>
int launch_floor(const void* q, const void* corpus, int B, long long N, int D,
                 int n_chunks, long long rows_per_chunk, int first_row_only,
                 int tile_rows, void* part, cudaStream_t s) {
  using T = typename Shape<MODE>::T;
  cudaError_t err = cudaFuncSetAttribute(
      floor_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, floor_smem<MODE>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + TB - 1) / TB, n_chunks);
  floor_kernel<MODE><<<grid, THREADS, floor_smem<MODE>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(corpus), B, N, D,
      rows_per_chunk, first_row_only, tile_rows, static_cast<float*>(part));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 fp32, 1 bf16, 2 f32x2, with q and corpus as topk_float_launch takes
// them. first_row_only: 0 for `nomerge`, 1 for `matmul` (then only rows that
// are multiples of tile_rows count). part: [n_chunks, B] f32 scratch; out:
// [B] f32. Launches both passes on `stream`; allocates nothing. Returns 0 or
// the CUDA error code of the failed call.
extern "C" int topk_floor_launch(int mode, const void* q, const void* corpus,
                                 int B, long long N, int D, int n_chunks,
                                 long long rows_per_chunk, int first_row_only,
                                 int tile_rows, void* part, void* out,
                                 void* stream) {
  if (mode < FP32 || mode > F32X2 || B <= 0 || N <= 0 || N > 0x7fffffffLL ||
      D <= 0 || D % DSTEP || n_chunks <= 0 || n_chunks > 65535 ||
      rows_per_chunk <= 0 || rows_per_chunk % CHUNK_ROWS ||
      (long long)n_chunks * rows_per_chunk < N || tile_rows <= 0 ||
      (first_row_only != 0 && first_row_only != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (mode == FP32)
    rc = launch_floor<FP32>(q, corpus, B, N, D, n_chunks, rows_per_chunk, first_row_only,
                            tile_rows, part, s);
  else if (mode == BF16)
    rc = launch_floor<BF16>(q, corpus, B, N, D, n_chunks, rows_per_chunk, first_row_only,
                            tile_rows, part, s);
  else
    rc = launch_floor<F32X2>(q, corpus, B, N, D, n_chunks, rows_per_chunk, first_row_only,
                             tile_rows, part, s);
  if (rc != 0) return rc;
  floor_max_kernel<<<(B + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(part), B, n_chunks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
