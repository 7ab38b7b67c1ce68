// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the operand layout, the fp32 kernels' tile shape and tile loads, and the
// dynamic shared-memory limit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace rtt {

// Element strides of one [B, S, H, K] operand (the K stride is 1). Row s of
// head h of batch b starts at base + b * b_ + s * s_ + h * h_.
struct Rows {
  long long b, s, h;
};

// Fill n Rows from 3n element strides, (b, s, h) of each operand in turn.
inline void unpack_rows(Rows* const* dst, int n, const long long* strides) {
  for (int i = 0; i < n; ++i)
    *dst[i] = Rows{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

// Launch shape of the fp32 kernels: a block owns 64 rows of its axis (query
// rows for the forward and dq, key rows for dkv), walks the other axis in
// tiles of 64, and runs 256 threads.
constexpr int FL_TILE = 64;
constexpr int FL_F32_THREADS = 256;

// Their accumulating loops give thread tid the output column tid % KD of
// the tile rows tid / KD + i · FL_RG (i < FL_RPT): FL_RG = 256 / KD row
// groups, 3 at head dim 80, where the last 16 threads take no row.
template <int KD>
constexpr int FL_RG = FL_F32_THREADS / KD;
template <int KD>
constexpr int FL_RPT = (FL_TILE + FL_RG<KD> - 1) / FL_RG<KD>;
template <int KD>
__device__ __forceinline__ bool fl_pv_row(int rgrp, int r) {
  return rgrp < FL_RG<KD> && r < FL_TILE;
}

// Copy ROWS rows of one head of an fp32 operand into a shared tile of pitch
// KP (scalar loads: a pitch of KD + 1 floats breaks 16-byte alignment and
// keeps the dot products' column walks free of bank conflicts).
template <int KD, int KP, int ROWS = FL_TILE>
__device__ __forceinline__ void load_tile_f32(float* tile, const float* base,
                                              long long row_stride, int row0,
                                              int end, int tid) {
  for (int i = tid; i < ROWS * KD; i += FL_F32_THREADS) {
    const int r = i / KD;
    const int c = i - r * KD;
    const int pos = row0 + r;
    tile[r * KP + c] = pos < end ? base[pos * row_stride + c] : 0.f;
  }
}

// Set a kernel's dynamic shared memory limit when it needs more than the
// default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace rtt
