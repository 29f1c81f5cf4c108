// paged_kv_write.cu — the paged decoder layer's attention prologue in one
// launch, for NVIDIA Hopper (built for sm_90a by
// outline_rag_tpu_torch/ops/_build.py, bound with ctypes by
// outline_rag_tpu_torch/ops/paged_attention.py::paged_kv_write_rope and
// ::paged_kv_write): rotate q and k (RoPE), quantize k and v for an int8
// pool, and scatter the new K/V rows into the pages of the pool, in place.
//
// Replaces the Pallas TPU kernel outline_rag_tpu/ops/paged_attention.py::
// _kv_write_kernel (launched by paged_kv_write) and the arithmetic that XLA
// fuses around it inside one compiled decoder layer:
// outline_rag_tpu/models/decoder.py:570-571 (the rotation of q and k) and
// :742-749 (_quantize_kv). The TPU kernel read-modify-writes a whole page
// slab through a one-hot matrix product, because its position-minor pool
// puts a token's values in one lane of 128. This pool is [P, KvH, page, Dh],
// a token's Dh values contiguous, so the write is a scatter of whole rows.
// For token t of row b (one block each):
//
//     slot = pos[b] + t,  pi = slot / page
//     pg   = pi < MAXP ? table[b, pi] : 0        (past capacity: scratch page 0,
//                                                 never the row's last page)
//     q_out[b, t, h] = rope(q[b, t, h])                              (ROTATE)
//     kr = ROTATE ? dtype(rope(k[b, t, n])) : k[b, t, n]
//     int8 pool:  s = amax|kr| * f32(1/127) + 1e-12,  codes = clamp(rint(kr / s))
//     pool_k[pg, n, slot % page, :] = codes or kr,   k_scale[pg, n, slot % page] = s
//     (v alike, never rotated; pre-quantized int8 entries copy their scales)
//
// rope(x)[i] = x[i] c[i] - x[i + Dh/2] s[i],  rope(x)[i + Dh/2] = x[i + Dh/2] c[i] + x[i] s[i]
// with c, s the forward's f32 cos and sin tables (never recomputed here).
//
// Bit for bit with the plain twin (paged_kv_write_rope_plain) on the card:
// every product and sum is rounded on its own (__fmul_rn, __fsub_rn,
// __fadd_rn: no FMA contraction), q and k are rounded to the model's dtype
// before k is quantized, the scale is the amax times the f32 reciprocal of
// 127 (ATen's true division of a CUDA tensor by a Python scalar), the codes
// an IEEE division (__fdiv_rn) rounded half to even (rintf). A max is exact
// in any order, so codes and scale bits are byte-equal too.
//
// Rows own disjoint live pages, so only page 0 is ever written by several
// blocks at once; its content is garbage by contract.
//
// What bounds it on the card: bytes (q read and written, k and v read, the
// pool rows and scales written: ~0.4 MB a 64-row decode step a layer in
// bf16), so at decode shapes it is one launch's latency. What it is for: it
// takes the place of the ~20-40 elementwise launches a layer that an eager
// rotation and quantization cost. Each thread takes VEC pairs (i, i + Dh/2)
// of one head through two 16-byte loads; the threads of a head sit in one
// warp and reduce its absmax with shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
// element kinds, as ops/paged_attention.py::_KINDS numbers them
constexpr int KIND_BF16 = 0, KIND_F32 = 1, KIND_INT8 = 2;

struct Args {
  void* pool_k;
  void* pool_v;
  const int* table;
  const int* pos;
  const void* q;
  const void* k;
  const void* v;
  void* q_out;
  const float* cos;
  const float* sin;
  float* k_scale;
  float* v_scale;
  const float* ks_new;
  const float* vs_new;
  long long q_row, k_row, v_row;  // elements from one token row (b, t) to the next
  int T, H, KvH, Dh, page, maxp;
};

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
};
template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

template <int N>
__device__ __forceinline__ void store_codes(int8_t* dst, const int8_t* src);
template <>
__device__ __forceinline__ void store_codes<8>(int8_t* dst, const int8_t* src) {
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
}
template <>
__device__ __forceinline__ void store_codes<4>(int8_t* dst, const int8_t* src) {
  *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
}

// T: the entries' type (the model's dtype, or int8 for pre-quantized
// entries); QUANT: an int8 pool fed T = bf16 / f32 entries; ROTATE: q and k
// arrive unrotated and q_out is written.
template <typename T, bool QUANT, bool ROTATE>
__global__ void __launch_bounds__(THREADS) kv_write_kernel(const Args a) {
  constexpr int VEC = 16 / sizeof(T);  // elements of one 16-byte vector
  const int b = blockIdx.y, t = blockIdx.x;
  const long long row = (long long)b * a.T + t;
  const long long slot = (long long)a.pos[b] + t;
  const long long pi = slot / a.page;
  const int off = static_cast<int>(slot % a.page);
  const int pg = pi < a.maxp ? a.table[(long long)b * a.maxp + pi] : 0;
  const int half = a.Dh / 2;
  const int tph = half / VEC;  // threads a head: a power of two that divides 32
  const int qh = ROTATE ? a.H : 0;
  const int units = (qh + 2 * a.KvH) * tph;  // q heads, then k heads, then v heads
  // every thread runs the same number of rounds, so a warp's shuffles see all its lanes
  for (int u0 = 0; u0 < units; u0 += THREADS) {
    const int u = u0 + threadIdx.x;
    const bool live = u < units;
    const int job = live ? u / tph : 0, e0 = (u % tph) * VEC;
    const bool is_q = job < qh, is_k = !is_q && job < qh + a.KvH;
    const int n = is_q ? job : is_k ? job - qh : job - qh - a.KvH;
    const long long dst = ((long long)pg * a.KvH + n) * a.page + off;  // the pool row
    const T* src = static_cast<const T*>(is_q ? a.q : is_k ? a.k : a.v) +
                   row * (is_q ? a.q_row : is_k ? a.k_row : a.v_row) + (long long)n * a.Dh;
    alignas(16) T lo[VEC], hi[VEC];  // elements e0.. and half + e0..
    if (live) {
      *reinterpret_cast<uint4*>(lo) = *reinterpret_cast<const uint4*>(src + e0);
      *reinterpret_cast<uint4*>(hi) = *reinterpret_cast<const uint4*>(src + half + e0);
    }
    if constexpr (!QUANT && !ROTATE) {
      if (live) {
        T* pool = static_cast<T*>(is_k ? a.pool_k : a.pool_v) + dst * a.Dh;
        *reinterpret_cast<uint4*>(pool + e0) = *reinterpret_cast<const uint4*>(lo);
        *reinterpret_cast<uint4*>(pool + half + e0) = *reinterpret_cast<const uint4*>(hi);
        if (a.k_scale != nullptr && e0 == 0)
          (is_k ? a.k_scale : a.v_scale)[dst] = (is_k ? a.ks_new : a.vs_new)[row * a.KvH + n];
      }
    } else {
      float x[2 * VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        x[e] = live ? Elem<T>::load(lo[e]) : 0.f;
        x[VEC + e] = live ? Elem<T>::load(hi[e]) : 0.f;
      }
      if (ROTATE && live && (is_q || is_k)) {
        const float* c = a.cos + row * half + e0;
        const float* s = a.sin + row * half + e0;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float x1 = x[e], x2 = x[VEC + e], cv = c[e], sv = s[e];
          x[e] = __fsub_rn(__fmul_rn(x1, cv), __fmul_rn(x2, sv));
          x[VEC + e] = __fadd_rn(__fmul_rn(x2, cv), __fmul_rn(x1, sv));
        }
        // q and k leave in the model's dtype, and k is quantized as rounded
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          lo[e] = Elem<T>::store(x[e]);
          hi[e] = Elem<T>::store(x[VEC + e]);
          x[e] = Elem<T>::load(lo[e]);
          x[VEC + e] = Elem<T>::load(hi[e]);
        }
      }
      if (is_q) {
        if (live) {
          T* out = static_cast<T*>(a.q_out) + (row * a.H + n) * a.Dh;
          *reinterpret_cast<uint4*>(out + e0) = *reinterpret_cast<const uint4*>(lo);
          *reinterpret_cast<uint4*>(out + half + e0) = *reinterpret_cast<const uint4*>(hi);
        }
      }
      if constexpr (QUANT) {
        float m = 0.f;
#pragma unroll
        for (int e = 0; e < 2 * VEC; ++e) m = fmaxf(m, fabsf(x[e]));
        for (int o = 1; o < tph; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        const float sc = __fadd_rn(__fmul_rn(m, 1.0f / 127.0f), 1e-12f);
        if (live && !is_q) {
          alignas(8) int8_t cl[VEC], ch[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            cl[e] = static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(x[e], sc)), -127.f), 127.f));
            ch[e] = static_cast<int8_t>(
                fminf(fmaxf(rintf(__fdiv_rn(x[VEC + e], sc)), -127.f), 127.f));
          }
          int8_t* pool = static_cast<int8_t*>(is_k ? a.pool_k : a.pool_v) + dst * a.Dh;
          store_codes<VEC>(pool + e0, cl);
          store_codes<VEC>(pool + half + e0, ch);
          if (e0 == 0) (is_k ? a.k_scale : a.v_scale)[dst] = sc;
        }
      } else {
        if (live && !is_q) {
          T* pool = static_cast<T*>(is_k ? a.pool_k : a.pool_v) + dst * a.Dh;
          *reinterpret_cast<uint4*>(pool + e0) = *reinterpret_cast<const uint4*>(lo);
          *reinterpret_cast<uint4*>(pool + half + e0) = *reinterpret_cast<const uint4*>(hi);
        }
      }
    }
  }
}

template <typename T, bool QUANT, bool ROTATE>
int launch(const Args& a, int B, cudaStream_t stream) {
  kv_write_kernel<T, QUANT, ROTATE><<<dim3(a.T, B), THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int elem_bytes(int kind) { return kind == KIND_F32 ? 4 : kind == KIND_BF16 ? 2 : 1; }

}  // namespace

// Pools [P, KvH, page, Dh] contiguous of kind `pool` (bf16, f32 or int8);
// k_new, v_new [B, T, KvH, Dh] of kind `act`, each token row's KvH * Dh
// values contiguous, k_row / v_row elements apart (a view of a fused qkv
// product needs no copy); table [B, maxp] i32; pos [B] i32. int8 pools take
// k_scale, v_scale [P, KvH, page] f32, and for int8 entries (act == int8,
// already quantized) ks_new, vs_new [B, T, KvH] f32; bf16 / f32 entries into
// an int8 pool are quantized here (ks_new, vs_new null). rotate = 1 (act
// bf16 or f32): q [B, T, H, Dh] with rows q_row apart, cos and sin [B, T,
// Dh/2] f32 contiguous, q_out [B, T, H, Dh] contiguous. Every pointer and
// row is 16-byte aligned; Dh * size of act a multiple of 32 bytes. Launches
// on `stream`; allocates nothing. Returns 0 or the CUDA error code.
extern "C" int paged_kv_write_launch(
    void* pool_k, void* pool_v, const void* table, const void* pos, const void* q,
    const void* k_new, const void* v_new, void* q_out, const void* cos, const void* sin,
    void* k_scale, void* v_scale, const void* ks_new, const void* vs_new, long long q_row,
    long long k_row, long long v_row, int B, int T, int H, int KvH, int Dh, int page, int maxp,
    int act, int pool, int rotate, void* stream) {
  const bool floats = act == KIND_BF16 || act == KIND_F32;
  const bool quant = pool == KIND_INT8 && floats;
  const bool scales = pool == KIND_INT8;
  const int vec = 16 / elem_bytes(act);
  if (B <= 0 || T <= 0 || KvH <= 0 || Dh <= 0 || page <= 0 || maxp <= 0 || B > 65535 ||
      (!floats && act != KIND_INT8) || (pool != act && !quant) || Dh % (2 * vec) ||
      (quant && Dh / (2 * vec) > 32) || (rotate && !floats) || (quant && !rotate) ||
      scales != (k_scale != nullptr) || scales != (v_scale != nullptr) ||
      (scales && !quant) != (ks_new != nullptr) || (scales && !quant) != (vs_new != nullptr) ||
      (rotate && (H <= 0 || q == nullptr || q_out == nullptr || cos == nullptr || sin == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{pool_k, pool_v, static_cast<const int*>(table), static_cast<const int*>(pos),
         q, k_new, v_new, q_out, static_cast<const float*>(cos), static_cast<const float*>(sin),
         static_cast<float*>(k_scale), static_cast<float*>(v_scale),
         static_cast<const float*>(ks_new), static_cast<const float*>(vs_new),
         q_row, k_row, v_row, T, rotate ? H : 0, KvH, Dh, page, maxp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act == KIND_INT8) return launch<int8_t, false, false>(a, B, s);
  if (act == KIND_BF16) {
    if (!rotate) return launch<__nv_bfloat16, false, false>(a, B, s);
    return quant ? launch<__nv_bfloat16, true, true>(a, B, s)
                 : launch<__nv_bfloat16, false, true>(a, B, s);
  }
  if (!rotate) return launch<float, false, false>(a, B, s);
  return quant ? launch<float, true, true>(a, B, s) : launch<float, false, true>(a, B, s);
}
