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
// header says: the corpus bytes, or the FMA rate; as written, shared-memory
// reads of the 4 x 4 register tile), since this kernel is that pass.
//
// Design: pass 1 is scan_kernel's loop over a chunk's tiles with
// score_tile() from topk_float_tile.cuh, so the scores are bit-equal to the
// full kernel's; each thread keeps the maximum of its 4 queries over its
// rows in registers, a warp shuffle folds the 32 lanes, and lane 0 writes
// [chunks, B] partial maxima. `tile_rows` is a run-time argument, so the
// compiler cannot drop the products of rows that `matmul` does not read.
// Pass 2 takes the maximum over chunks, one thread a query. A maximum does
// not depend on order: two runs are bit-equal.

#include "topk_float_tile.cuh"

namespace {

constexpr float FLOOR_INIT = -1e30f;

template <typename T, bool COMP>
__global__ void __launch_bounds__(THREADS)
floor_kernel(const T* __restrict__ q, const T* __restrict__ corpus, int B,
             long long N, int D, long long rows_per_chunk, int first_row_only,
             int tile_rows, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  constexpr int PLANES = COMP ? 2 : 1;
  float* cs = smem;                   // [PLANES][TN][CW] corpus slabs
  float* qs = cs + PLANES * TN * CW;  // [PLANES][TB][CW] query slabs

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * TB;
  const long long chunk = blockIdx.y;
  const long long row_begin = chunk * rows_per_chunk;
  const long long row_end =
      row_begin + rows_per_chunk < N ? row_begin + rows_per_chunk : N;
  const long long W = COMP ? 2LL * D : D;  // stored row width

  float best[4] = {FLOOR_INIT, FLOOR_INIT, FLOOR_INIT, FLOOR_INIT};
  for (long long tile = row_begin; tile < row_end; tile += TN) {
    float acc[4][4], acc_hl[4][4], acc_lh[4][4];
    score_tile<T, COMP>(q, corpus, W, tile, row_end, q0, B, D, cs, qs, acc,
                        acc_hl, acc_lh);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const long long row = tile + lane + 32 * a;
      const bool take =
          row < row_end && (!first_row_only || row % tile_rows == 0);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float dot = tile_dot<COMP>(acc[a][b], acc_hl[a][b], acc_lh[a][b]);
        if (take) best[b] = fmaxf(best[b], dot);
      }
    }
  }

#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float v = best[b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    const int qq = q0 + warp * 4 + b;
    if (lane == 0 && qq < B) part[chunk * B + qq] = v;
  }
}

__global__ void floor_max_kernel(const float* __restrict__ part, int B,
                                 int n_chunks, float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float v = FLOOR_INIT;
  for (int c = 0; c < n_chunks; ++c) v = fmaxf(v, part[(long long)c * B + b]);
  out[b] = v;
}

template <typename T, bool COMP>
int launch_floor(const void* q, const void* corpus, int B, long long N, int D,
                 int n_chunks, long long rows_per_chunk, int first_row_only,
                 int tile_rows, void* part, cudaStream_t s) {
  const size_t smem = (size_t)tile_floats<COMP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      floor_kernel<T, COMP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + TB - 1) / TB, n_chunks);
  floor_kernel<T, COMP><<<grid, THREADS, smem, s>>>(
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
      D <= 0 || D % DC || n_chunks <= 0 || n_chunks > 65535 ||
      rows_per_chunk <= 0 || rows_per_chunk % TN ||
      (long long)n_chunks * rows_per_chunk < N || tile_rows <= 0 ||
      (first_row_only != 0 && first_row_only != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (mode == FP32)
    rc = launch_floor<float, false>(q, corpus, B, N, D, n_chunks, rows_per_chunk,
                                    first_row_only, tile_rows, part, s);
  else if (mode == BF16)
    rc = launch_floor<__nv_bfloat16, false>(q, corpus, B, N, D, n_chunks,
                                            rows_per_chunk, first_row_only,
                                            tile_rows, part, s);
  else
    rc = launch_floor<__nv_bfloat16, true>(q, corpus, B, N, D, n_chunks,
                                           rows_per_chunk, first_row_only,
                                           tile_rows, part, s);
  if (rc != 0) return rc;
  floor_max_kernel<<<(B + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(part), B, n_chunks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
