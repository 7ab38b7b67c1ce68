// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the operand layout, the tile shape, cp.async tile loads, and the
// warp-level bf16 tensor-core products on tiles held in shared memory.
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

// Launch shape shared by the kernels: a block owns 64 rows of its axis (query
// rows for the forward and dq, key rows for dkv) and walks the other axis in
// tiles of 64. The tensor-core kernels run four warps, 16 rows each; the fp32
// kernels 256 threads.
constexpr int FL_TILE = 64;
constexpr int FL_WARPS = 4;
constexpr int FL_THREADS = 32 * FL_WARPS;
constexpr int FL_F32_THREADS = 256;

// cp.async: 16 (or 4) bytes from device to shared memory without a trip
// through registers, completing in the background. With pred false the
// destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory, not transposed: lanes 8i ..
// 8i + 7 give the row addresses of matrix i, and lane (g, t) receives
// elements [row g][cols 2t, 2t + 1] of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem_row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Start copying rows row0 .. row0 + 63 of one head of an operand into a
// shared tile with row pitch KD + 8 elements (16 bytes of padding keep the
// ldmatrix reads free of bank conflicts). Rows at or past `end` are
// zero-filled, so no value read past the operand's edge can reach a
// product. The wrappers check that every row start is 16-byte aligned.
// The caller commits the group and waits for it.
template <int KD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* tile,
                                                const __nv_bfloat16* base,
                                                long long row_stride,
                                                int row0, int end, int tid,
                                                int nthreads) {
  constexpr int KP = KD + 8;
  constexpr int CPR = KD / 8;  // 16-byte chunks per row
  for (int i = tid; i < FL_TILE * CPR; i += nthreads) {
    const int r = i / CPR;
    const int cc = (i - r * CPR) * 8;
    const int pos = row0 + r;
    const bool ok = pos < end;
    cp_async16(&tile[r * KP + cc], base + (ok ? pos * row_stride + cc : 0),
               ok);
  }
}

// The m16n8k16 A fragment of rows row0 .. row0 + 15, columns k0 .. k0 + 15
// of a row-major shared tile (layout in common.cuh): ldmatrix matrices
// (rows +0, cols +0), (rows +8, cols +0), (rows +0, cols +8), (+8, +8).
template <int KP>
__device__ __forceinline__ void lds_a(uint32_t (&a)[4],
                                      const __nv_bfloat16* tile, int row0,
                                      int k0, int lane) {
  const int mi = lane >> 3;
  ldmatrix_x4(a, tile + (row0 + (mi & 1) * 8 + (lane & 7)) * KP + k0 +
                     (mi >> 1) * 8);
}

// The b fragments of n-tiles n0 / 8 and n0 / 8 + 1 at k-step k0 of
// B = tile^T (the tile's row n is column n of B): ldmatrix matrices (rows
// +0, cols +0), (rows +0, cols +8), (rows +8, cols +0), (+8, +8), so r[0],
// r[1] are the b0, b1 of the first n-tile and r[2], r[3] of the second.
template <int KP>
__device__ __forceinline__ void lds_bt2(uint32_t (&r)[4],
                                        const __nv_bfloat16* tile, int n0,
                                        int k0, int lane) {
  const int mi = lane >> 3;
  ldmatrix_x4(r, tile + (n0 + (mi >> 1) * 8 + (lane & 7)) * KP + k0 +
                     (mi & 1) * 8);
}

// acc[n] += A · B^T for the 16 rows of A at a_row0 and the 64 rows of B (a
// shared tile whose row n is column n of the product), over KD columns:
// S = Q K^T, dP = dO V^T, and their transposes in the dkv kernel.
template <int KD>
__device__ __forceinline__ void warp_abt(float (&acc)[FL_TILE / 8][4],
                                         const __nv_bfloat16* a_tile,
                                         int a_row0,
                                         const __nv_bfloat16* b_tile,
                                         int lane) {
  constexpr int KP = KD + 8;
#pragma unroll
  for (int ks = 0; ks < KD / 16; ++ks) {
    uint32_t a[4];
    lds_a<KP>(a, a_tile, a_row0, ks * 16, lane);
#pragma unroll
    for (int n = 0; n < FL_TILE / 8; n += 2) {
      uint32_t b[4];
      lds_bt2<KP>(b, b_tile, n * 8, ks * 16, lane);
      mma_bf16_16816(acc[n], a, b[0], b[1]);
      mma_bf16_16816(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// The same product with A's fragments already in registers.
template <int KD>
__device__ __forceinline__ void warp_abt_reg(float (&acc)[FL_TILE / 8][4],
                                             const uint32_t (&a)[KD / 16][4],
                                             const __nv_bfloat16* b_tile,
                                             int lane) {
  constexpr int KP = KD + 8;
#pragma unroll
  for (int ks = 0; ks < KD / 16; ++ks) {
#pragma unroll
    for (int n = 0; n < FL_TILE / 8; n += 2) {
      uint32_t b[4];
      lds_bt2<KP>(b, b_tile, n * 8, ks * 16, lane);
      mma_bf16_16816(acc[n], a[ks], b[0], b[1]);
      mma_bf16_16816(acc[n + 1], a[ks], b[2], b[3]);
    }
  }
}

// Round a 16 x 64 fp32 tile in accumulator layout to bf16 A fragments of the
// four 16-column k-steps: k-step j covers accumulator n-tiles 2j and 2j + 1.
__device__ __forceinline__ void pack_a(uint32_t (&pa)[FL_TILE / 16][4],
                                       const float (&x)[FL_TILE / 8][4]) {
#pragma unroll
  for (int n = 0; n < FL_TILE / 8; ++n) {
    pa[n / 2][(n & 1) * 2 + 0] = pack_bf16x2(x[n][0], x[n][1]);
    pa[n / 2][(n & 1) * 2 + 1] = pack_bf16x2(x[n][2], x[n][3]);
  }
}

// acc += P · V for a 16 x 64 P in A fragments and a row-major 64 x KD shared
// tile V (O += P V, dq += dS K, dv += P^T dO, dk += dS^T Q). ldmatrix.trans
// matrix i of lanes 8i .. 8i + 7: rows 16j + (i & 1) * 8 + (lane & 7),
// columns 16 np + (i >> 1) * 8 .. + 7, so r[0], r[1] are the b fragment of
// accumulator n-tile 2 np and r[2], r[3] of 2 np + 1.
template <int KD>
__device__ __forceinline__ void warp_pv(float (&acc)[KD / 8][4],
                                        const uint32_t (&pa)[FL_TILE / 16][4],
                                        const __nv_bfloat16* v_tile,
                                        int lane) {
  constexpr int KP = KD + 8;
  const int mi = lane >> 3;
  const int row_in = (lane & 7) + (mi & 1) * 8;
  const int col_in = (mi >> 1) * 8;
#pragma unroll
  for (int j = 0; j < FL_TILE / 16; ++j) {
#pragma unroll
    for (int np = 0; np < KD / 16; ++np) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, &v_tile[(16 * j + row_in) * KP + 16 * np + col_in]);
      mma_bf16_16816(acc[2 * np], pa[j], vb[0], vb[1]);
      mma_bf16_16816(acc[2 * np + 1], pa[j], vb[2], vb[3]);
    }
  }
}

// Copy rows of one head of an fp32 operand into a shared tile of pitch KP
// (scalar loads: a pitch of KD + 1 floats breaks 16-byte alignment and keeps
// the dot products' column walks free of bank conflicts).
template <int KD, int KP>
__device__ __forceinline__ void load_tile_f32(float* tile, const float* base,
                                              long long row_stride, int row0,
                                              int end, int tid) {
  for (int i = tid; i < FL_TILE * KD; i += FL_F32_THREADS) {
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
