// Shared device helpers for the paged-attention kernels (paged_decode.cu,
// paged_prefill.cu): dtype conversion, 16-byte vector loads, the reference's
// rounding of softmax probabilities to the input dtype, and fp32 pairs
// packed as bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

// The JAX kernels mask with a large finite negative, not -inf: a row with
// no valid position keeps finite statistics, and the l == 0 guard then
// writes zeros instead of NaN.
constexpr float NEG_INF = -1e30f;

// dtype codes shared with ray_tpu_torch/ops/paged_attention.py.
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// The reference casts probabilities to the input dtype before the PV
// product (p.astype(v.dtype)); the softmax denominator sums them unrounded.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// One 16-byte load of 16 / sizeof(T) consecutive elements, widened to fp32.
// `p` must be 16-byte aligned (the wrappers check the base pointers; every
// offset used is a multiple of that many elements).
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 f2 = __bfloat1622float2(h);
    f[2 * i] = f2.x;
    f[2 * i + 1] = f2.y;
  }
}

// N consecutive elements (16-byte aligned, N a multiple of one 16-byte
// load) widened to fp32.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    float v[4];
    load16(p + 4 * i, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) f[4 * i + e] = v[e];
  }
}

template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    float v[8];
    load16(p + 8 * i, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[8 * i + e] = v[e];
  }
}

// Two fp32 values rounded to bf16 and packed, the first in the low half (the
// lower-indexed element of a wgmma fragment pair).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace rtt
