// hostmem.cu — rows of an index plane kept in page-locked host memory,
// read and written by the card over PCIe, for NVIDIA Hopper (built for sm_90a
// by outline_rag_tpu_torch/ops/_build.py, bound with ctypes by
// outline_rag_tpu_torch/ops/hostmem.py::host_gather_rows / host_scatter_rows).
//
// Replaces no Pallas kernel: outline_rag_tpu/ops/hostmem.py is XLA host
// offload. Its gather_rows (:72) runs a lax.gather inside
// compute_on("device_host") and its make_host_append (:101) a donated
// host-space scatter. On the TPU runtime the gather's cost grew with the
// plane's size, not with the rows it read. Here page-locked host memory is
// mapped into the card's address space (unified addressing), so a kernel
// reads and writes the rows it needs straight over PCIe: only those rows
// cross the bus, and the host does not take part.
//
//     gather:  out[r, :]      = 0 <= idx[r] < N ? plane[idx[r], :] : 0
//     scatter: plane[idx[r], :] = rows[r, :]     where 0 <= idx[r] < N
//
// An index out of range never touches the plane: its gathered row is zero
// and its written row is dropped (the JAX gather promises in-range indices
// and leaves the rest undefined; its scatter drops them).
//
// What bounds it on the card: the PCIe link, the gathered (or written) bytes
// over its rate, some 1,000 times slower than device memory. So the design
// is about keeping enough reads in flight: one warp a row, 16-byte words,
// every word of a lane's share loaded before any is stored, and row offsets
// in 64 bits (10M rows of 1,024 bytes are 10 GB). The copy is type-blind.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // 16-byte words a lane has in flight

// Copy one row of `bytes` from src to dst, a warp's lanes together: 16-byte
// words where both ends are 16-byte aligned, then the tail byte by byte
// (or the whole row byte by byte where they are not). src null: zeros.
__device__ __forceinline__ void copy_row(char* __restrict__ dst,
                                         const char* __restrict__ src,
                                         long long bytes, int lane) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0;
  const long long words = aligned ? bytes / 16 : 0;
  uint4* d16 = reinterpret_cast<uint4*>(dst);
  const uint4* s16 = reinterpret_cast<const uint4*>(src);
  for (long long w0 = 0; w0 < words; w0 += 32 * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long w = w0 + u * 32 + lane;
      v[u] = src != nullptr && w < words ? s16[w] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long w = w0 + u * 32 + lane;
      if (w < words) d16[w] = v[u];
    }
  }
  for (long long i = words * 16 + lane; i < bytes; i += 32)
    dst[i] = src != nullptr ? src[i] : 0;
}

__global__ void __launch_bounds__(THREADS)
gather_kernel(const char* __restrict__ plane, const int* __restrict__ idx,
              char* __restrict__ out, long long R, long long N, long long row_bytes) {
  const long long r = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (r >= R) return;
  const long long i = idx[r];
  const char* src = i >= 0 && i < N ? plane + i * row_bytes : nullptr;
  copy_row(out + r * row_bytes, src, row_bytes, threadIdx.x % 32);
}

__global__ void __launch_bounds__(THREADS)
scatter_kernel(char* __restrict__ plane, const char* __restrict__ rows,
               const int* __restrict__ idx, long long R, long long N, long long row_bytes) {
  const long long r = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (r >= R) return;
  const long long i = idx[r];
  if (i < 0 || i >= N) return;  // dropped
  copy_row(plane + i * row_bytes, rows + r * row_bytes, row_bytes, threadIdx.x % 32);
}

// The address through which kernels reach the page-locked host memory at
// `host`, or null where it is not page-locked and mapped.
void* mapped(void* host) {
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, host) != cudaSuccess) {
    cudaGetLastError();  // clear the sticky query error
    return nullptr;
  }
  return attr.type == cudaMemoryTypeHost ? attr.devicePointer : nullptr;
}

int check(long long R, long long N, long long row_bytes) {
  if (R <= 0 || N <= 0 || row_bytes <= 0 || (R + WARPS - 1) / WARPS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// plane: [N, row_bytes] page-locked host memory (its host address); idx: [R]
// i32 on the card; out: [R, row_bytes] on the card. Launches on `stream`;
// allocates nothing, never synchronises. Returns 0, cudaErrorInvalidValue for
// a bad shape or a plane that is not page-locked and mapped, or the launch's
// CUDA error.
extern "C" int host_gather_rows_launch(void* plane, const void* idx, void* out,
                                       long long R, long long N,
                                       long long row_bytes, void* stream) {
  if (int rc = check(R, N, row_bytes)) return rc;
  const char* dplane = static_cast<const char*>(mapped(plane));
  if (dplane == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((R + WARPS - 1) / WARPS);
  gather_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      dplane, static_cast<const int*>(idx), static_cast<char*>(out), R, N, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// plane: [N, row_bytes] page-locked host memory, written in place; rows:
// [R, row_bytes] on the card; idx: [R] i32 on the card. Rows whose index is
// out of range are dropped. In-range indices must be distinct (two rows
// written to one index race). Launches on `stream`; the host sees the rows
// once the stream has passed the kernel. Returns as host_gather_rows_launch.
extern "C" int host_scatter_rows_launch(void* plane, const void* rows, const void* idx,
                                        long long R, long long N,
                                        long long row_bytes, void* stream) {
  if (int rc = check(R, N, row_bytes)) return rc;
  char* dplane = static_cast<char*>(mapped(plane));
  if (dplane == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((R + WARPS - 1) / WARPS);
  scatter_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      dplane, static_cast<const char*>(rows), static_cast<const int*>(idx), R, N, row_bytes);
  return static_cast<int>(cudaGetLastError());
}
