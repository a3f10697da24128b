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
//   * block reductions combine warp partials in a fixed order, so results
//     are deterministic from launch to launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Block-wide reductions in a fixed order (deterministic). Every thread of
// the block must call them; `red` holds NT / 32 values.
template <int NT>
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < NT / 32; ++i) t += red[i];
  return t;
}

template <int NT>
__device__ float block_max_nan(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < NT / 32; ++i) t = nan_max(t, red[i]);
  return t;
}

template <int NT>
__device__ int block_sum_int(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  int t = 0;
  for (int i = 0; i < NT / 32; ++i) t += red[i];
  return t;
}

__device__ __forceinline__ int seg_of(float d1, float d2, int g) {
  // _correct_strided: l* = clip(round(d2 / d1) - 1, 0, g - 1)
  float t = rintf(d2 / d1) - 1.f;
  t = fminf(fmaxf(t, 0.f), (float)(g - 1));
  return (int)t;
}

}  // namespace
