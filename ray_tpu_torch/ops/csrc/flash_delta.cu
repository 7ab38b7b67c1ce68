// The flash backward's row term as one kernel:
//   delta[b, s, h] = sum_k float(dO[b, s, h, k]) * float(O[b, s, h, k])
//                    - dlse[b, s, h]   (dlse optional),
// fp32, written as the contiguous [B, S, H] rows that the dq and dkv
// kernels (flash_bwd.cu) read.
//
// Replaces no Pallas kernel: the JAX package computes delta with jnp ops in
// `_bwd_impl` (ray_tpu/ops/attention.py:277-280), which XLA fuses into one
// pass. The port ran them as three eager passes (a product, a sum, a
// subtraction), 6.7-12.6x the bytes bound on the H100 (PERF.md), the
// largest part of the backward's gap to the library call at every head
// dim.
//
// What bounds it on the H100: bytes. Each input element is read once and
// used once (one FMA): dO and O in, one fp32 value per row out. At the
// training shapes, [8, 1024, 12, 64] bf16 O: 25 MB, 0.0076 ms over 3.35
// TB/s; [8, 1024, 32, 80] bf16: 84 MB, 0.025 ms; [8, 1024, 16, 256] with
// the forward's fp32 O (`O32_HEAD_DIMS`): 201 MB, 0.060 ms.
//
// What the design does about it: G lanes of a warp share a row (G = 8, 16
// or 32: the power of two at or above K / 8, at most a warp), each lane
// reading 8 consecutive elements of dO and of O per step with 16-byte
// loads (an fp32 row: two), rows read with their own (b, s, h) strides, so
// neither a strided dO nor the fp32 O is copied first. The lane's FMAs run
// in fp32, then the G partial sums meet by shuffles. 256 threads a block,
// 256 / G rows; every warp keeps 32 x 16 or 32 x 48 bytes in flight.
// Inputs: dO bf16 or fp32, O bf16 or fp32 (bf16 dO with fp32 O is the
// head-dim-256 training path), any head dim that is a multiple of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "flash.cuh"

namespace rtt {
namespace {

constexpr int DELTA_THREADS = 256;
constexpr int DELTA_CHUNK = 8;  // elements per lane and step

template <typename TD, typename TO, int G>
__global__ void __launch_bounds__(DELTA_THREADS)
    flash_delta_kernel(const TD* __restrict__ dout, const TO* __restrict__ o,
                       const float* __restrict__ dlse,
                       float* __restrict__ delta, long long rows, int S, int H,
                       int K, Rows ds, Rows os, Rows ls) {
  const long long row =
      (long long)blockIdx.x * (DELTA_THREADS / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  // A whole group shares its row, and the shuffles below take every lane
  // of the warp: no lane leaves early.
  const bool valid = row < rows;
  const int h = (int)(row % H);
  const long long bs = row / H;
  const int s = (int)(bs % S);
  const long long b = bs / S;
  float acc = 0.f;
  if (valid) {
    const TD* dp = dout + b * ds.b + s * ds.s + h * ds.h;
    const TO* op = o + b * os.b + s * os.s + h * os.h;
    for (int c = lane * DELTA_CHUNK; c < K; c += G * DELTA_CHUNK) {
      float fd[DELTA_CHUNK], fo[DELTA_CHUNK];
      load_n<DELTA_CHUNK>(dp + c, fd);
      load_n<DELTA_CHUNK>(op + c, fo);
#pragma unroll
      for (int e = 0; e < DELTA_CHUNK; ++e) acc = fmaf(fd[e], fo[e], acc);
    }
  }
#pragma unroll
  for (int m = G / 2; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (valid && lane == 0) {
    if (dlse != nullptr) acc -= dlse[b * ls.b + s * ls.s + h * ls.h];
    delta[row] = acc;
  }
}

template <typename TD, typename TO>
cudaError_t launch_delta(const void* dout, const void* o, const float* dlse,
                         float* delta, long long rows, int S, int H, int K,
                         const Rows& ds, const Rows& os, const Rows& ls,
                         cudaStream_t stream) {
  const int chunks = K / DELTA_CHUNK;
  const int G = chunks <= 8 ? 8 : chunks <= 16 ? 16 : 32;
  const long long per_block = DELTA_THREADS / G;
  const long long grid = (rows + per_block - 1) / per_block;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const TD* d = static_cast<const TD*>(dout);
  const TO* p = static_cast<const TO*>(o);
  if (G == 8)
    flash_delta_kernel<TD, TO, 8><<<(unsigned)grid, DELTA_THREADS, 0, stream>>>(
        d, p, dlse, delta, rows, S, H, K, ds, os, ls);
  else if (G == 16)
    flash_delta_kernel<TD, TO, 16><<<(unsigned)grid, DELTA_THREADS, 0,
                                     stream>>>(d, p, dlse, delta, rows, S, H,
                                               K, ds, os, ls);
  else
    flash_delta_kernel<TD, TO, 32><<<(unsigned)grid, DELTA_THREADS, 0,
                                     stream>>>(d, p, dlse, delta, rows, S, H,
                                               K, ds, os, ls);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rtt

// dtype_do, dtype_o: DTYPE_F32 or DTYPE_BF16 each (fp32 dO takes fp32 O).
// strides: 9 element strides, (b, s, h) of dO, O and dlse in order (dlse's
// ignored when it is NULL). Rows of dO and O 16-byte aligned, K a multiple
// of 8: the wrapper (ops/attention.py `flash_delta`) checks both.
extern "C" int rtt_flash_delta(int dtype_do, int dtype_o, const void* dout,
                               const void* o, const void* dlse, void* delta,
                               int B, int S, int H, int K,
                               const long long* strides, void* stream) {
  const long long rows = (long long)B * S * H;
  if (rows == 0) return (int)cudaSuccess;
  if (K <= 0 || K % rtt::DELTA_CHUNK != 0) return (int)cudaErrorInvalidValue;
  rtt::Rows ds, os, ls;
  rtt::Rows* r[3] = {&ds, &os, &ls};
  rtt::unpack_rows(r, 3, strides);
  const float* l = static_cast<const float*>(dlse);
  float* out = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype_do == rtt::DTYPE_BF16 && dtype_o == rtt::DTYPE_BF16)
    return (int)rtt::launch_delta<bf16, bf16>(dout, o, l, out, rows, S, H, K,
                                              ds, os, ls, s);
  if (dtype_do == rtt::DTYPE_BF16 && dtype_o == rtt::DTYPE_F32)
    return (int)rtt::launch_delta<bf16, float>(dout, o, l, out, rows, S, H, K,
                                               ds, os, ls, s);
  if (dtype_do == rtt::DTYPE_F32 && dtype_o == rtt::DTYPE_F32)
    return (int)rtt::launch_delta<float, float>(dout, o, l, out, rows, S, H,
                                                K, ds, os, ls, s);
  return (int)cudaErrorInvalidValue;
}
