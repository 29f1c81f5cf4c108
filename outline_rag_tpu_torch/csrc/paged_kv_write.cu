// paged_kv_write.cu — scatter T new K/V entries per batch row into the pages
// of a paged KV pool, in place, for NVIDIA Hopper (built for sm_90a by
// outline_rag_tpu_torch/ops/_build.py, bound with ctypes by
// outline_rag_tpu_torch/ops/paged_attention.py::paged_kv_write).
//
// Replaces the Pallas TPU kernel outline_rag_tpu/ops/paged_attention.py::
// _kv_write_kernel (launched by paged_kv_write). That kernel read-modify-
// writes a whole page slab through a one-hot matrix product, because the
// TPU's position-minor pool puts a token's values in one lane of 128. This
// pool is [P, KvH, page, Dh], a token's Dh values contiguous, so the same
// function is a scatter of whole rows:
//
//     slot = pos[b] + t,  pi = slot / page
//     pg   = pi < MAXP ? table[b, pi] : 0        (past capacity: scratch page 0,
//                                                 never the row's last page)
//     pool_k[pg, n, slot % page, :] = k_new[b, t, n, :]     (and pool_v)
//     k_scale[pg, n, slot % page]   = ks_new[b, t, n]       (int8 pools)
//
// Rows own disjoint live pages, so only page 0 is ever written by several
// blocks at once; its content is garbage by contract.
//
// What bounds it on the card: bytes, 2 * B * T * KvH * Dh elements read and
// written once (45 KB a 64-row decode step a layer in bf16), so at decode
// shapes it is one launch's latency. The copy is type-blind: 16-byte words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

// One block per (b, t): vec16 = KvH * row16 16-byte words of K and of V,
// row16 words per head.
__global__ void __launch_bounds__(THREADS)
kv_write_kernel(uint4* __restrict__ pool_k, uint4* __restrict__ pool_v,
                const int* __restrict__ table, const int* __restrict__ pos,
                const uint4* __restrict__ k_new, const uint4* __restrict__ v_new,
                float* __restrict__ k_scale, float* __restrict__ v_scale,
                const float* __restrict__ ks_new, const float* __restrict__ vs_new,
                int T, int KvH, int row16, int page, int maxp) {
  const int b = blockIdx.y, t = blockIdx.x;
  const long long slot = (long long)pos[b] + t;
  const long long pi = slot / page;
  const int off = static_cast<int>(slot % page);
  const int pg = pi < maxp ? table[(long long)b * maxp + pi] : 0;
  const long long src0 = ((long long)b * T + t) * KvH;  // in heads
  for (int i = threadIdx.x; i < KvH * row16; i += THREADS) {
    const int n = i / row16, w = i % row16;
    const long long dst = (((long long)pg * KvH + n) * page + off) * row16 + w;
    pool_k[dst] = k_new[src0 * row16 + i];
    pool_v[dst] = v_new[src0 * row16 + i];
  }
  if (k_scale != nullptr) {
    for (int n = threadIdx.x; n < KvH; n += THREADS) {
      const long long dst = ((long long)pg * KvH + n) * page + off;
      k_scale[dst] = ks_new[src0 + n];
      v_scale[dst] = vs_new[src0 + n];
    }
  }
}

}  // namespace

// pool_k, pool_v: [P, KvH, page, Dh] contiguous; k_new, v_new: [B, T, KvH, Dh]
// contiguous of the same element type, row_bytes = Dh * its size, a multiple
// of 16. table: [B, maxp] i32; pos: [B] i32. For int8 pools k_scale, v_scale
// [P, KvH, page] f32 and ks_new, vs_new [B, T, KvH] f32; else all four null.
// Launches on `stream`; allocates nothing. Returns 0 or the CUDA error code.
extern "C" int paged_kv_write_launch(void* pool_k, void* pool_v,
                                     const void* table, const void* pos,
                                     const void* k_new, const void* v_new,
                                     void* k_scale, void* v_scale,
                                     const void* ks_new, const void* vs_new,
                                     int B, int T, int KvH, int row_bytes,
                                     int page, int maxp, void* stream) {
  const bool scales = k_scale != nullptr;
  if (B <= 0 || T <= 0 || KvH <= 0 || row_bytes <= 0 || row_bytes % 16 ||
      page <= 0 || maxp <= 0 || B > 65535 ||
      scales != (v_scale != nullptr) || scales != (ks_new != nullptr) ||
      scales != (vs_new != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(T, B);
  kv_write_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(pool_k), static_cast<uint4*>(pool_v),
      static_cast<const int*>(table), static_cast<const int*>(pos),
      static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
      static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const float*>(ks_new), static_cast<const float*>(vs_new), T,
      KvH, row_bytes / 16, page, maxp);
  return static_cast<int>(cudaGetLastError());
}
