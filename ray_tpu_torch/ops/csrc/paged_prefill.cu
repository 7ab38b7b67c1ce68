// Ragged chunked-PREFILL paged-attention kernel for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/paged_attention.py, `_prefill_kernel` (Pallas TPU
// kernel behind the wrapper `paged_prefill_attention`; also the
// speculative-verify kernel there, C = k+1). Same function: slot b's chunk
// of C query rows starts at absolute position offsets[b]; row c attends
// positions tpos with (tpos <= offsets[b] + c) && (tpos < lengths[b]),
// reading K/V in place from one layer's pool [P+1, ps, H, K] through the
// page table tables[b, :n_pg] (n_pg may be a width-sliced view). Online
// softmax (m, l, acc) in fp32, -1e30 masking, l == 0 writes zeros, so pad
// rows (c >= the chunk's valid tokens) come out finite. Output in q.dtype.
//
// What bounds it on the H100: at serving shapes (C = 256, 1-2 K contexts,
// K = 64, bf16) the live KV bytes over 3.35 TB/s and the 4·C·T·K FLOPs per
// (slot, head) over 989 TFLOP/s are of the same order, the bytes a little
// larger: a kernel that feeds the tensor cores is bound by bytes, one that
// does its FLOPs as fp32 FMAs (67 TFLOP/s class) by operations.
//
// What the design does about it. Both versions run one block per (64-row
// query tile, head, slot) and stop at the last key the tile can see,
// min(lengths[b], offsets[b] + last row + 1): the causal early exit, and no
// work at all for an inert row (lengths[b] == 0). Each key's K and V rows
// are read from device memory once per query tile, not once per query row.
//  - bf16 with K in {64, 128} (the serving path): the tensor-core kernel.
//    Four warps of 16 query rows each keep their Q fragments and the O
//    accumulator in registers; the block stages 64 keys of K and V at a
//    time in shared memory (16-byte loads through the page table, rows
//    padded by 16 bytes so the fragment reads are free of bank conflicts),
//    and each warp runs S = Q·K^T and O += P·V as mma.sync m16n8k16 bf16
//    products with fp32 accumulators, P taken straight from the S
//    registers and V's fragments by ldmatrix.trans. A warp whose rows all
//    precede a key tile skips its math for that tile.
//  - fp32 (K in {64, 128}): plain FMAs from shared memory (one float of
//    padding per row keeps the QK^T loop free of bank conflicts), so fp32
//    keeps full precision (1e-5).
// The next step is Hopper's own path: wgmma on the shared tiles, and K/V
// tiles brought in by TMA or cp.async while the previous tile is in the
// MMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace rtt {
namespace {

constexpr int PF_THREADS = 256;
constexpr int PF_TQ = 64;  // query rows per block
constexpr int PF_ROW_THREADS = PF_THREADS / PF_TQ;  // threads per row stats

__host__ __device__ constexpr size_t prefill_smem_floats(int KD, int ps) {
  // q tile [TQ][KD+1], K page [ps][KD+1], V page [ps][KD],
  // scores [TQ][ps+1], m / l / corr [TQ] each.
  return (size_t)PF_TQ * (KD + 1) + (size_t)ps * (KD + 1) + (size_t)ps * KD +
         (size_t)PF_TQ * (ps + 1) + 3 * (size_t)PF_TQ;
}

template <typename T, int KD>
__global__ void __launch_bounds__(PF_THREADS)
    paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                         const T* __restrict__ v_pool,
                         const int* __restrict__ tables,
                         const int* __restrict__ offsets,
                         const int* __restrict__ lengths, T* __restrict__ out,
                         int C, int H, int ps, int n_pg, float sm_scale) {
  static_assert(PF_THREADS % KD == 0, "head dim must divide the block");
  constexpr int KP = KD + 1;
  constexpr int ROW_GROUPS = PF_THREADS / KD;
  static_assert(PF_TQ % ROW_GROUPS == 0, "rows must split over groups");
  constexpr int RPT = PF_TQ / ROW_GROUPS;  // accumulator rows per thread

  extern __shared__ float smem[];
  const int SP = ps + 1;
  float* q_s = smem;                  // [TQ][KP]
  float* k_s = q_s + PF_TQ * KP;      // [ps][KP]
  float* v_s = k_s + (size_t)ps * KP;  // [ps][KD]
  float* s_s = v_s + (size_t)ps * KD;  // [TQ][SP]
  float* m_s = s_s + (size_t)PF_TQ * SP;
  float* l_s = m_s + PF_TQ;
  float* c_s = l_s + PF_TQ;

  const int q0 = blockIdx.x * PF_TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int len = lengths[b];
  const int off = offsets[b];
  const int rows = min(PF_TQ, C - q0);
  const size_t row_stride = (size_t)H * KD;
  const size_t page_stride = (size_t)ps * row_stride;

  for (int i = tid; i < PF_TQ * KD; i += PF_THREADS) {
    const int r = i / KD, k = i % KD;
    q_s[r * KP + k] =
        r < rows ? to_f(q[(((size_t)b * C + q0 + r) * H + h) * KD + k]) : 0.f;
  }
  for (int r = tid; r < PF_TQ; r += PF_THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  // Last position any row of this tile may attend, plus one.
  int kv_end = off + q0 + rows;
  if (kv_end > len) kv_end = len;
  int n_live = kv_end > 0 ? (kv_end + ps - 1) / ps : 0;
  if (n_live > n_pg) n_live = n_pg;

  const int kcol = tid % KD;   // PV: this thread's output column
  const int rgrp = tid / KD;   // PV: rows rgrp, rgrp + ROW_GROUPS, ...
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int j = 0; j < n_live; ++j) {
    const size_t page = (size_t)tables[(size_t)b * n_pg + j];
    const T* kp = k_pool + page * page_stride + (size_t)h * KD;
    const T* vp = v_pool + page * page_stride + (size_t)h * KD;
    for (int i = tid; i < ps * KD; i += PF_THREADS) {
      const int t = i / KD, k = i % KD;
      k_s[t * KP + k] = to_f(kp[(size_t)t * row_stride + k]);
      v_s[t * KD + k] = to_f(vp[(size_t)t * row_stride + k]);
    }
    __syncthreads();

    // Scores with the two-part mask.
    for (int i = tid; i < PF_TQ * ps; i += PF_THREADS) {
      const int r = i / ps, t = i % ps;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < KD; ++k) s += q_s[r * KP + k] * k_s[t * KP + k];
      const int tpos = j * ps + t;
      const int qpos = off + q0 + r;
      s_s[r * SP + t] = (tpos <= qpos && tpos < len) ? s * sm_scale : NEG_INF;
    }
    __syncthreads();

    // Row statistics: PF_ROW_THREADS adjacent lanes per row.
    {
      const int r = tid / PF_ROW_THREADS;
      const int sub = tid % PF_ROW_THREADS;
      float mx = NEG_INF;
      for (int t = sub; t < ps; t += PF_ROW_THREADS)
        mx = fmaxf(mx, s_s[r * SP + t]);
#pragma unroll
      for (int o = PF_ROW_THREADS / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int t = sub; t < ps; t += PF_ROW_THREADS) {
        const float p = expf(s_s[r * SP + t] - m_new);
        psum += p;
        s_s[r * SP + t] = round_to<T>(p);
      }
#pragma unroll
      for (int o = PF_ROW_THREADS / 2; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      if (sub == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r, k] = acc[r, k] * corr[r] + sum_t p[r, t] * v[t, k].
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rgrp + i * ROW_GROUPS;
      float a = 0.f;
      for (int t = 0; t < ps; ++t) a += s_s[r * SP + t] * v_s[t * KD + kcol];
      acc[i] = acc[i] * c_s[r] + a;
    }
    __syncthreads();  // k_s / v_s / s_s are rewritten by the next page
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rgrp + i * ROW_GROUPS;
    if (r < rows) {
      const float l = l_s[r];
      const float l_safe = (l == 0.f) ? 1.f : l;
      out[(((size_t)b * C + q0 + r) * H + h) * KD + kcol] =
          from_f<T>(acc[i] / l_safe);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core version.

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_TQ = 16 * MMA_WARPS;  // query rows per block
constexpr int MMA_TK = 64;              // keys per shared tile

template <int KD>
__host__ __device__ constexpr size_t prefill_mma_smem_bytes() {
  return 2 * (size_t)MMA_TK * (KD + 8) * sizeof(__nv_bfloat16);
}

template <int KD>
__global__ void __launch_bounds__(MMA_THREADS)
    paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k_pool,
                             const __nv_bfloat16* __restrict__ v_pool,
                             const int* __restrict__ tables,
                             const int* __restrict__ offsets,
                             const int* __restrict__ lengths,
                             __nv_bfloat16* __restrict__ out, int C, int H,
                             int ps, int n_pg, float sm_scale) {
  static_assert(KD % 16 == 0 && KD <= 128, "head dim for the mma path");
  constexpr int KSTEPS = KD / 16;      // k-steps of Q·K^T
  constexpr int NT_S = MMA_TK / 8;     // n-tiles of S (keys)
  constexpr int NT_O = KD / 8;         // n-tiles of O (head dims)
  constexpr int KP = KD + 8;           // padded shared row, in elements
  constexpr int CPR = KD / 8;          // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 k_s[MMA_TK * KP];
  __shared__ __align__(16) __nv_bfloat16 v_s[MMA_TK * KP];

  const int q0 = blockIdx.x * MMA_TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int len = lengths[b];
  const int off = offsets[b];
  const int rows = min(MMA_TQ, C - q0);
  const size_t row_stride = (size_t)H * KD;

  // This lane's two query rows (fragment rows g and g + 8 of its warp).
  const int r0 = warp * 16 + g;
  const int r1 = r0 + 8;
  const int qpos0 = off + q0 + r0;
  const int qpos1 = off + q0 + r1;

  // Q fragments stay in registers for the whole key walk; rows past C are 0.
  uint32_t qa[KSTEPS][4];
  {
    const __nv_bfloat16* qb = q + (((size_t)b * C + q0) * H + h) * KD;
    const uint32_t* q0p =
        reinterpret_cast<const uint32_t*>(qb + (size_t)r0 * row_stride);
    const uint32_t* q1p =
        reinterpret_cast<const uint32_t*>(qb + (size_t)r1 * row_stride);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int w = (ks * 16 + 2 * t4) / 2;  // 32-bit word of the pair
      qa[ks][0] = r0 < rows ? q0p[w] : 0u;
      qa[ks][1] = r1 < rows ? q1p[w] : 0u;
      qa[ks][2] = r0 < rows ? q0p[w + 4] : 0u;
      qa[ks][3] = r1 < rows ? q1p[w + 4] : 0u;
    }
  }

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};

  // Last position any row of this tile may attend, plus one.
  int kv_end = min(len, off + q0 + rows);
  kv_end = min(kv_end, n_pg * ps);
  const int n_kt = kv_end > 0 ? (kv_end + MMA_TK - 1) / MMA_TK : 0;
  const int warp_last_qpos = off + q0 + warp * 16 + 15;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int key0 = kt * MMA_TK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < MMA_TK * CPR; i += MMA_THREADS) {
      const int r = i / CPR;
      const int cc = (i - r * CPR) * 8;
      const int pos = key0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = kv;
      if (pos < kv_end) {  // keys past the tile's reach are zero-filled
        const size_t page = (size_t)tables[(size_t)b * n_pg + pos / ps];
        const size_t src =
            (page * ps + pos % ps) * row_stride + (size_t)h * KD + cc;
        kv = *reinterpret_cast<const uint4*>(k_pool + src);
        vv = *reinterpret_cast<const uint4*>(v_pool + src);
      }
      *reinterpret_cast<uint4*>(&k_s[r * KP + cc]) = kv;
      *reinterpret_cast<uint4*>(&v_s[r * KP + cc]) = vv;
    }
    __syncthreads();
    if (key0 > warp_last_qpos) continue;  // all keys after all of our rows

    // S = Q · K^T for this warp's 16 rows and the tile's 64 keys.
    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        const uint32_t* kr = reinterpret_cast<const uint32_t*>(
            &k_s[(n * 8 + g) * KP + ks * 16 + 2 * t4]);
        mma_bf16_16816(s[n], qa[ks], kr[0], kr[4]);
      }
    }

    // The two-part mask, then the online softmax of rows r0 and r1. A row's
    // four lanes (same g) hold its 64 scores between them.
    float mx0 = m_r[0];
    float mx1 = m_r[1];
    uint32_t valid = 0;  // bit 4n+e: entry s[n][e] is a visible key
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + n * 8 + 2 * t4 + e;
        if (key < len && key <= qpos0) {
          valid |= 1u << (4 * n + e);
          s[n][e] *= sm_scale;
          mx0 = fmaxf(mx0, s[n][e]);
        }
        if (key < len && key <= qpos1) {
          valid |= 1u << (4 * n + 2 + e);
          s[n][2 + e] *= sm_scale;
          mx1 = fmaxf(mx1, s[n][2 + e]);
        }
      }
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    const float corr0 = __expf(m_r[0] - mx0);
    const float corr1 = __expf(m_r[1] - mx1);
    m_r[0] = mx0;
    m_r[1] = mx1;

    // P in bf16 as the A fragments of O += P · V: k-step j covers keys
    // 16j..16j+15, i.e. S n-tiles 2j (a[0], a[1]) and 2j+1 (a[2], a[3]).
    uint32_t pa[NT_S / 2][4];
    float ps0 = 0.f;
    float ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = (valid >> (4 * n + e)) & 1u
                   ? __expf(s[n][e] - (e < 2 ? mx0 : mx1))
                   : 0.f;
      ps0 += p[0] + p[1];
      ps1 += p[2] + p[3];
      pa[n / 2][(n & 1) * 2 + 0] = pack_bf16x2(p[0], p[1]);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, o2);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, o2);
    }
    l_r[0] = l_r[0] * corr0 + ps0;
    l_r[1] = l_r[1] * corr1 + ps1;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= corr0;
      o[n][1] *= corr0;
      o[n][2] *= corr1;
      o[n][3] *= corr1;
    }

    // O += P · V. ldmatrix.trans matrix i of lanes 8i..8i+7: keys
    // 16j + (i & 1)·8 + (lane & 7), head dims 16·np + (i >> 1)·8 .. +7, so
    // r[0], r[1] are the b fragment of O n-tile 2np and r[2], r[3] of 2np+1.
    const int mi = lane >> 3;
    const int key_in = (lane & 7) + (mi & 1) * 8;
    const int dim_in = (mi >> 1) * 8;
#pragma unroll
    for (int j = 0; j < NT_S / 2; ++j) {
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &v_s[(16 * j + key_in) * KP + 16 * np + dim_in]);
        mma_bf16_16816(o[2 * np], pa[j], vb[0], vb[1]);
        mma_bf16_16816(o[2 * np + 1], pa[j], vb[2], vb[3]);
      }
    }
  }

  const float inv0 = 1.f / (l_r[0] == 0.f ? 1.f : l_r[0]);
  const float inv1 = 1.f / (l_r[1] == 0.f ? 1.f : l_r[1]);
  __nv_bfloat16* ob = out + (((size_t)b * C + q0) * H + h) * KD;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int col = n * 8 + 2 * t4;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * row_stride + col) =
          pack_bf16x2(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < rows)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * row_stride + col) =
          pack_bf16x2(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int KD>
cudaError_t launch_prefill_mma(const void* q, const void* k_pool,
                               const void* v_pool, const int* tables,
                               const int* offsets, const int* lengths,
                               void* out, int B, int C, int H, int ps,
                               int n_pg, float sm_scale, cudaStream_t stream) {
  dim3 grid((C + MMA_TQ - 1) / MMA_TQ, H, B);
  paged_prefill_mma_kernel<KD><<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), tables, offsets, lengths,
      static_cast<__nv_bfloat16*>(out), C, H, ps, n_pg, sm_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// FMA version (fp32).

template <typename T, int KD>
cudaError_t launch_prefill_kd(const void* q, const void* k_pool,
                              const void* v_pool, const int* tables,
                              const int* offsets, const int* lengths,
                              void* out, int B, int C, int H, int ps,
                              int n_pg, float sm_scale, cudaStream_t stream) {
  const size_t smem = prefill_smem_floats(KD, ps) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<T, KD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((C + PF_TQ - 1) / PF_TQ, H, B);
  paged_prefill_kernel<T, KD><<<grid, PF_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, offsets, lengths,
      static_cast<T*>(out), C, H, ps, n_pg, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_prefill(const void* q, const void* k_pool,
                           const void* v_pool, const int* tables,
                           const int* offsets, const int* lengths, void* out,
                           int B, int C, int H, int K, int ps, int n_pg,
                           float sm_scale, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  switch (K) {
    case 64:
      if constexpr (kBf16)
        return launch_prefill_mma<64>(q, k_pool, v_pool, tables, offsets,
                                      lengths, out, B, C, H, ps, n_pg,
                                      sm_scale, stream);
      else
        return launch_prefill_kd<T, 64>(q, k_pool, v_pool, tables, offsets,
                                        lengths, out, B, C, H, ps, n_pg,
                                        sm_scale, stream);
    case 128:
      if constexpr (kBf16)
        return launch_prefill_mma<128>(q, k_pool, v_pool, tables, offsets,
                                       lengths, out, B, C, H, ps, n_pg,
                                       sm_scale, stream);
      else
        return launch_prefill_kd<T, 128>(q, k_pool, v_pool, tables, offsets,
                                         lengths, out, B, C, H, ps, n_pg,
                                         sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace rtt

// Shared memory one block of the kernel that (dtype, K) selects needs at
// page size ps; the wrapper refuses shapes above what a block may have.
extern "C" size_t rtt_paged_prefill_smem_bytes(int dtype, int K, int ps) {
  if (dtype == rtt::DTYPE_BF16 && K == 64)
    return rtt::prefill_mma_smem_bytes<64>();
  if (dtype == rtt::DTYPE_BF16 && K == 128)
    return rtt::prefill_mma_smem_bytes<128>();
  return rtt::prefill_smem_floats(K, ps) * sizeof(float);
}

extern "C" int rtt_paged_prefill_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* offsets, const void* lengths, void* out,
    int B, int C, int H, int K, int ps, int n_pg, float sm_scale,
    void* stream) {
  if (ps < 1 || n_pg < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0 || H == 0) return (int)cudaSuccess;
  const int* tbl = static_cast<const int*>(tables);
  const int* offs = static_cast<const int*>(offsets);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == rtt::DTYPE_F32)
    e = rtt::launch_prefill<float>(q, k_pool, v_pool, tbl, offs, lens, out, B,
                                   C, H, K, ps, n_pg, sm_scale, s);
  else if (dtype == rtt::DTYPE_BF16)
    e = rtt::launch_prefill<__nv_bfloat16>(q, k_pool, v_pool, tbl, offs, lens,
                                           out, B, C, H, K, ps, n_pg,
                                           sm_scale, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
