// Shared device helpers for the paged-attention kernels (paged_decode.cu,
// paged_prefill.cu): dtype conversion, 16-byte vector loads, the reference's
// rounding of softmax probabilities to the input dtype, int8 codes widened
// to bf16 (the prefill's int8 programs), and the bf16 tensor-core
// instructions (mma.sync, ldmatrix).
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

// ---------------------------------------------------------------------------
// int8 pools (the int8 programs): codes in [-127, 127], one scale per page,
// read from the layer's bf16 scale vector as it is (to_f widens exactly).

// Two fp32 values rounded to bf16 and packed, the first in the low half (the
// lower-indexed element of an mma fragment pair).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two int8 codes (the low byte first) as a packed bf16 pair: |code| <= 127
// is exact in bf16, so an mma fragment of codes loses nothing.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t w) {
  return pack_bf16x2(static_cast<float>(static_cast<int8_t>(w & 0xff)),
                     static_cast<float>(static_cast<int8_t>((w >> 8) & 0xff)));
}

// Sixteen int8 codes of one 16-byte load as sixteen bf16 values (exact) at
// `dst` (16-byte aligned), in order: two 16-byte stores.
__device__ __forceinline__ void store_i8x16_as_bf16(__nv_bfloat16* dst,
                                                    const uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t b[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b[2 * i] = i8x2_to_bf16x2(w[i]);
    b[2 * i + 1] = i8x2_to_bf16x2(w[i] >> 16);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(b[0], b[1], b[2], b[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(b[4], b[5], b[6], b[7]);
}

// d += a · b on the tensor cores: one m16n8k16 bf16 product with fp32
// accumulators. Fragments as the PTX ISA lays them out for this shape, with
// g = lane / 4 and t = lane % 4:
//   a[0] (row g,   k 2t..2t+1)  a[1] (row g+8, k 2t..2t+1)
//   a[2] (row g,   k 2t+8..+9)  a[3] (row g+8, k 2t+8..+9)
//   b0   (k 2t..2t+1, col g)    b1   (k 2t+8..+9, col g)
//   d[0..1] (row g, cols 2t, 2t+1)   d[2..3] (row g+8, cols 2t, 2t+1)
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed: lanes 8i..8i+7 give
// the row addresses of matrix i, and lane (g, t) receives elements
// [rows 2t, 2t+1][col g] of each, the layout of an mma b fragment taken from
// a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem_row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

}  // namespace rtt
