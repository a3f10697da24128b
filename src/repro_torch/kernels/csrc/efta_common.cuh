// Device helpers shared by the fused EFTA kernels of this directory
// (efta_paged.cu, efta_attention.cu). Header-only; each kernel source is
// its own library, so everything here has internal linkage.
//
// Numerics both kernels keep (they are built with -fmad=false):
//   * storage type T is float or __nv_bfloat16; arithmetic is f32;
//   * maximum / minimum propagate NaN as jnp.maximum / torch.maximum do;
//   * shadow computations read their inputs through opaque(), an empty
//     asm volatile the optimizer cannot see through, so nvcc cannot merge
//     a shadow with its primary;
//   * reductions combine lanes and warps in a fixed order, so results are
//     deterministic from launch to launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Phase clocks, a build option for measurement only (-DEFTA_PHASE_CLOCKS;
// the libraries that chip_smoke.py and the wrappers build never set it):
// thread 0 of every thread block adds the clock64() cycles between a
// kernel's PHASE_MARKs to efta_phase_clk[k]; each library has its own
// copy, read and zeroed by efta_read_phase_clocks behind its C entry point.
// tools/b1_phase_split.py and tools/b2_phase_split.py build them.
#ifdef EFTA_PHASE_CLOCKS
__device__ unsigned long long efta_phase_clk[16];
#define PHASE_INIT                 \
  long long ph_t = clock64();      \
  long long ph_acc[16] = {};
#define PHASE_MARK(k)                    \
  if (threadIdx.x == 0) {                \
    const long long ph_n = clock64();    \
    ph_acc[k] += ph_n - ph_t;            \
    ph_t = ph_n;                         \
  }
#define PHASE_FLUSH                                                  \
  if (threadIdx.x == 0)                                              \
    for (int ph_k = 0; ph_k < 16; ++ph_k)                            \
      atomicAdd(&efta_phase_clk[ph_k], (unsigned long long)ph_acc[ph_k]);

// the phase clocks' 16 sums (cycles) into out, then zeroed
static inline int efta_read_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, efta_phase_clk,
                                         16 * sizeof(unsigned long long));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(efta_phase_clk, zero, sizeof(zero));
}
#else
#define PHASE_INIT
#define PHASE_MARK(k)
#define PHASE_FLUSH
#endif

namespace {

// fault sites (repro_torch.core.fault.Site)
constexpr int S_GEMM1 = 0, S_ROWMAX = 1, S_EXP = 2, S_ROWSUM = 3,
              S_GEMM2 = 4;
// MASK_VALUE = -0.7 * finfo(f32).max, formed in double as Python does
constexpr double MASK_D = -0.7 * 3.4028234663852886e+38;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float flip_bit(float x, int bit) {
  if (bit < 0 || bit > 31) return x;
  return __int_as_float(__float_as_int(x) ^ (int)(1u << bit));
}

// maximum / minimum that propagate NaN, as jnp.maximum / torch.maximum
// do (fmaxf / fminf return the other operand instead)
__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
  return fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
  return fminf(a, b);
}

__device__ __forceinline__ float opaque(float x) {
  asm volatile("" : "+f"(x));
  return x;
}

// x / d and x % d (x >= 0) for a divisor fixed per launch: a shift and a
// mask where d is a power of two (head dims, strides and block sizes
// usually are), else the division
struct Div {
  int d, s;
  __device__ explicit Div(int d_) : d(d_), s(-1) {
    if (d_ > 0 && (d_ & (d_ - 1)) == 0)
      for (s = 0; (1 << s) < d_; ++s) {
      }
  }
  __device__ __forceinline__ int q(int x) const {
    return s >= 0 ? x >> s : x / d;
  }
  __device__ __forceinline__ int r(int x) const {
    return s >= 0 ? x & (d - 1) : x - (x / d) * d;
  }
};

// ---- Hopper building blocks: asynchronous copies, ldmatrix, mma.sync ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// global -> shared without passing through registers; 16 bytes (bf16 rows)
// or 4 bytes (f32 rows with an odd, bank-spreading stride)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most `pending` (0 or 1: rings of 2 or 3 stages) of this
// thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// D (16x8 f32) += A (16x16 bf16, row) * B (16x8 bf16, col). Fragments, with
// g = lane / 4 and t = lane % 4: a = {(g, 2t..), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..)}; b = {(k 2t.., n g), (k 2t+8.., n g)}; d = {(g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two f32 rounded to bf16 (nearest even), low half = x
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// V consecutive elements of T from shared memory as f32: one 16-byte load
// for 8 bf16 (16-byte aligned), else V scalar loads
template <typename T, int V>
__device__ __forceinline__ void load_row(float* out, const T* p) {
  if constexpr (sizeof(T) == 2 && V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = to_f(p[k]);
  }
}

// the two checksum products of one row: a1 = q . kf1, a2 = q . kf2 over D,
// sequential f32 FMAs in d order; q in T (rows 16-byte aligned in bf16),
// kf1 / kf2 f32 rows 16-byte aligned
template <typename T>
__device__ __forceinline__ void qk_fold(const T* q, const float* kf1,
                                        const float* kf2, int D, float* a1,
                                        float* a2) {
  float s1 = 0.f, s2 = 0.f;
  if constexpr (sizeof(T) == 2) {
    for (int d = 0; d < D; d += 8) {
      float x[8];
      load_row<T, 8>(x, q + d);
      const float4 u0 = *reinterpret_cast<const float4*>(kf1 + d);
      const float4 u1 = *reinterpret_cast<const float4*>(kf1 + d + 4);
      const float4 v0 = *reinterpret_cast<const float4*>(kf2 + d);
      const float4 v1 = *reinterpret_cast<const float4*>(kf2 + d + 4);
      const float k1[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
      const float k2[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s1 = fmaf(x[k], k1[k], s1);
        s2 = fmaf(x[k], k2[k], s2);
      }
    }
  } else {
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float x = to_f(q[d]);
      s1 = fmaf(x, kf1[d], s1);
      s2 = fmaf(x, kf2[d], s2);
    }
  }
  *a1 = s1;
  *a2 = s2;
}

__device__ __forceinline__ int seg_of(float d1, float d2, int g) {
  // _correct_strided: l* = clip(round(d2 / d1) - 1, 0, g - 1)
  float t = rintf(d2 / d1) - 1.f;
  t = fminf(fmaxf(t, 0.f), (float)(g - 1));
  return (int)t;
}

}  // namespace
