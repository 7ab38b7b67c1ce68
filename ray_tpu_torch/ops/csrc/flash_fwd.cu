// Flash-attention FORWARD kernel for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/attention.py, `_fwd_kernel` (Pallas TPU kernel, driven
// by `_fwd` behind `flash_attention`'s custom VJP). Same function: q [B, S, H,
// K] attends over k, v [B, T, H, K]; row s sees key t when t < T and, if
// causal, s >= t (the mask aligned at the top left). Scores are fp32 products
// of input-dtype operands, times sm_scale after the product; online softmax
// (m, l, acc) in fp32; probabilities rounded to v's dtype before P·V and summed
// unrounded into l. Outputs o (q.dtype, written with o's strides) and the
// row's log-sum-exp lse = m + log(l) as fp32 [B, S, H]; a row with no visible
// key gets o = 0 and lse = -1e30.
//
// What bounds it on the H100: at the training step's shapes (B = 8, S = T =
// 1024, H = 12, K = 64, bf16, causal) the 2·2·S·T·K/2 FLOPs per (batch, head)
// over 989 TFLOP/s and the bytes of q, k, v, o over 3.35 TB/s are of the same
// order (about 0.013 ms and 0.015 ms): bytes by a little for a kernel that
// feeds the tensor cores at full rate, operations for any real one.
//
// What the design does about it: each K and V row is read from device memory
// once per 64-row query tile, never once per query row, and the [S, T] score
// matrix never leaves registers. One block of four warps per (64-row query
// tile, head, batch); each warp keeps its 16 query rows' Q fragments and O
// accumulator in registers, the block stages 64 keys of K and V at a time in
// shared memory, two tiles deep (cp.async: the next tile's loads are in
// flight while the current one is in the MMAs; rows padded by 16 bytes), and
// each warp runs S = Q K^T and O += P V as mma.sync m16n8k16 bf16 products
// with fp32 accumulators, B fragments read by ldmatrix and P taken straight
// from the S registers. Causal tiles stop at
// the tile's last row (the early exit), a warp whose rows all precede a key
// tile skips its math, and the query tiles are issued last-first so the
// longest blocks start first. fp32 inputs take a plain FMA kernel (shared
// tiles, 256 threads) so that fp32 keeps full precision.
// The next step is Hopper's own path: wgmma on the shared tiles, K/V tiles
// brought in by TMA, and 128-row query tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "flash.cuh"

namespace rtt {
namespace {

struct FwdRows {
  Rows q, k, v, o;
};

// ---------------------------------------------------------------------------
// bf16 tensor-core version.

// K and V tiles [64][KD + 8] bf16, two stages each.
template <int KD>
constexpr size_t fwd_mma_smem_bytes() {
  return 4 * (size_t)FL_TILE * (KD + 8) * sizeof(__nv_bfloat16);
}

template <int KD>
__global__ void __launch_bounds__(FL_THREADS)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int S, int T, int H,
                         FwdRows st, int causal, float sm_scale) {
  constexpr int KSTEPS = KD / 16;
  constexpr int NT_S = FL_TILE / 8;  // n-tiles of S (keys)
  constexpr int NT_O = KD / 8;       // n-tiles of O (head dims)
  constexpr int KP = KD + 8;
  constexpr int TS = FL_TILE * KP;  // elements of one tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][TS]
  __nv_bfloat16* v_s = k_s + 2 * TS;                                // [2][TS]

  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * FL_TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rows = min(FL_TILE, S - q0);
  const __nv_bfloat16* qb = q + b * st.q.b + h * st.q.h;
  const __nv_bfloat16* kb = k + b * st.k.b + h * st.k.h;
  const __nv_bfloat16* vb = v + b * st.v.b + h * st.v.h;

  // One past the last key any row of this tile may see. The first K/V tile
  // starts loading before anything else.
  const int kv_end = causal ? min(T, q0 + rows) : T;
  const int n_kt = (kv_end + FL_TILE - 1) / FL_TILE;
  if (n_kt > 0) {
    load_tile_async<KD>(k_s, kb, st.k.s, 0, kv_end, tid, FL_THREADS);
    load_tile_async<KD>(v_s, vb, st.v.s, 0, kv_end, tid, FL_THREADS);
  }
  cp_async_commit();

  // This lane's two query rows (fragment rows g and g + 8 of its warp).
  const int r0 = warp * 16 + g;
  const int r1 = r0 + 8;
  const int qpos0 = q0 + r0;
  const int qpos1 = q0 + r1;

  // Q fragments stay in registers for the whole key walk; rows past S are 0.
  uint32_t qa[KSTEPS][4];
  {
    const uint32_t* q0p = reinterpret_cast<const uint32_t*>(
        qb + (r0 < rows ? qpos0 : 0) * st.q.s);
    const uint32_t* q1p = reinterpret_cast<const uint32_t*>(
        qb + (r1 < rows ? qpos1 : 0) * st.q.s);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int w = (ks * 16 + 2 * t4) / 2;  // 32-bit word of the pair
      qa[ks][0] = r0 < rows ? q0p[w] : 0u;
      qa[ks][1] = r1 < rows ? q1p[w] : 0u;
      qa[ks][2] = r0 < rows ? q0p[w + 4] : 0u;
      qa[ks][3] = r1 < rows ? q1p[w + 4] : 0u;
    }
  }

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};
  const int warp_last_qpos = q0 + warp * 16 + 15;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int key0 = kt * FL_TILE;
    const __nv_bfloat16* kt_s = k_s + (kt & 1) * TS;
    const __nv_bfloat16* vt_s = v_s + (kt & 1) * TS;
    if (kt + 1 < n_kt) {  // the next tile into the other stage
      load_tile_async<KD>(k_s + ((kt + 1) & 1) * TS, kb, st.k.s,
                          key0 + FL_TILE, kv_end, tid, FL_THREADS);
      load_tile_async<KD>(v_s + ((kt + 1) & 1) * TS, vb, st.v.s,
                          key0 + FL_TILE, kv_end, tid, FL_THREADS);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group is complete
    __syncthreads();
    // A warp whose rows all precede this tile's keys skips its math.
    if (!causal || key0 <= warp_last_qpos) {
      float s[NT_S][4];
#pragma unroll
      for (int n = 0; n < NT_S; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      warp_abt_reg<KD>(s, qa, kt_s, lane);

      // The mask, then the online softmax of rows r0 and r1. A row's four
      // lanes (same g) hold its 64 scores between them.
      float mx0 = m_r[0];
      float mx1 = m_r[1];
      uint32_t valid = 0;  // bit 4n + e: entry s[n][e] is a visible key
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + n * 8 + 2 * t4 + e;
          if (key < T && (!causal || key <= qpos0)) {
            valid |= 1u << (4 * n + e);
            s[n][e] *= sm_scale;
            mx0 = fmaxf(mx0, s[n][e]);
          }
          if (key < T && (!causal || key <= qpos1)) {
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

      float ps0 = 0.f;
      float ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = (valid >> (4 * n + e)) & 1u
                        ? __expf(s[n][e] - (e < 2 ? mx0 : mx1))
                        : 0.f;
        }
        ps0 += s[n][0] + s[n][1];
        ps1 += s[n][2] + s[n][3];
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
        acc[n][0] *= corr0;
        acc[n][1] *= corr0;
        acc[n][2] *= corr1;
        acc[n][3] *= corr1;
      }
      uint32_t pa[FL_TILE / 16][4];
      pack_a(pa, s);  // p rounded to bf16; l summed the unrounded values
      warp_pv<KD>(acc, pa, vt_s, lane);
    }
    __syncthreads();  // every warp is done with this stage
  }

  const float inv0 = 1.f / (l_r[0] == 0.f ? 1.f : l_r[0]);
  const float inv1 = 1.f / (l_r[1] == 0.f ? 1.f : l_r[1]);
  __nv_bfloat16* ob = o + b * st.o.b + h * st.o.h;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int col = n * 8 + 2 * t4;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(ob + qpos0 * st.o.s + col) =
          pack_bf16x2(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < rows)
      *reinterpret_cast<uint32_t*>(ob + qpos1 * st.o.s + col) =
          pack_bf16x2(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (t4 == 0) {
    if (r0 < rows)
      lse[((long long)b * S + qpos0) * H + h] =
          l_r[0] == 0.f ? NEG_INF : m_r[0] + logf(l_r[0]);
    if (r1 < rows)
      lse[((long long)b * S + qpos1) * H + h] =
          l_r[1] == 0.f ? NEG_INF : m_r[1] + logf(l_r[1]);
  }
}

// ---------------------------------------------------------------------------
// fp32 FMA version.

template <int KD>
constexpr size_t fwd_f32_smem_bytes() {
  // q, k tiles [64][KD + 1], v tile [64][KD], p [64][65], m / l / corr [64].
  return sizeof(float) * ((size_t)2 * FL_TILE * (KD + 1) +
                          (size_t)FL_TILE * KD +
                          (size_t)FL_TILE * (FL_TILE + 1) + 3 * FL_TILE);
}

template <int KD>
__global__ void __launch_bounds__(FL_F32_THREADS)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, int T, int H,
                         FwdRows st, int causal, float sm_scale) {
  constexpr int KP = KD + 1;
  constexpr int SP = FL_TILE + 1;
  constexpr int RG = FL_F32_THREADS / KD;  // row groups of the PV loop
  constexpr int RPT = FL_TILE / RG;        // accumulator rows per thread
  constexpr int RT = FL_F32_THREADS / FL_TILE;  // threads per row's stats
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + FL_TILE * KP;
  float* v_s = k_s + FL_TILE * KP;
  float* p_s = v_s + FL_TILE * KD;
  float* m_s = p_s + FL_TILE * SP;
  float* l_s = m_s + FL_TILE;
  float* c_s = l_s + FL_TILE;

  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * FL_TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rows = min(FL_TILE, S - q0);
  const float* kb = k + b * st.k.b + h * st.k.h;
  const float* vb = v + b * st.v.b + h * st.v.h;

  load_tile_f32<KD, KP>(q_s, q + b * st.q.b + h * st.q.h, st.q.s, q0, S, tid);
  for (int r = tid; r < FL_TILE; r += FL_F32_THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  const int kcol = tid % KD;
  const int rgrp = tid / KD;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  const int kv_end = causal ? min(T, q0 + rows) : T;
  const int n_kt = (kv_end + FL_TILE - 1) / FL_TILE;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int key0 = kt * FL_TILE;
    __syncthreads();
    load_tile_f32<KD, KP>(k_s, kb, st.k.s, key0, kv_end, tid);
    for (int i = tid; i < FL_TILE * KD; i += FL_F32_THREADS) {
      const int r = i / KD, c = i - (i / KD) * KD;
      v_s[r * KD + c] = key0 + r < kv_end ? vb[(key0 + r) * st.v.s + c] : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < FL_TILE * FL_TILE; i += FL_F32_THREADS) {
      const int r = i / FL_TILE, t = i % FL_TILE;
      const int key = key0 + t;
      float s = 0.f;
#pragma unroll 16
      for (int c = 0; c < KD; ++c) s += q_s[r * KP + c] * k_s[t * KP + c];
      const bool ok = r < rows && key < T && (!causal || key <= q0 + r);
      p_s[r * SP + t] = ok ? s * sm_scale : NEG_INF;
    }
    __syncthreads();

    {  // row statistics: RT adjacent lanes per row
      const int r = tid / RT;
      const int sub = tid % RT;
      float mx = NEG_INF;
      for (int t = sub; t < FL_TILE; t += RT) mx = fmaxf(mx, p_s[r * SP + t]);
#pragma unroll
      for (int o2 = RT / 2; o2 > 0; o2 >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int t = sub; t < FL_TILE; t += RT) {
        const int key = key0 + t;
        const bool ok = r < rows && key < T && (!causal || key <= q0 + r);
        const float p = ok ? expf(p_s[r * SP + t] - m_new) : 0.f;
        psum += p;
        p_s[r * SP + t] = p;
      }
#pragma unroll
      for (int o2 = RT / 2; o2 > 0; o2 >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o2);
      if (sub == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rgrp + i * RG;
      float a = 0.f;
#pragma unroll 16
      for (int t = 0; t < FL_TILE; ++t)
        a += p_s[r * SP + t] * v_s[t * KD + kcol];
      acc[i] = acc[i] * c_s[r] + a;
    }
  }
  __syncthreads();

  float* ob = o + b * st.o.b + h * st.o.h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rgrp + i * RG;
    if (r < rows) {
      const float l = l_s[r];
      ob[(q0 + r) * st.o.s + kcol] = acc[i] / (l == 0.f ? 1.f : l);
    }
  }
  for (int r = tid; r < rows; r += FL_F32_THREADS) {
    const float l = l_s[r];
    lse[((long long)b * S + q0 + r) * H + h] =
        l == 0.f ? NEG_INF : m_s[r] + logf(l);
  }
}

template <int KD>
cudaError_t launch_fwd(int dtype, const void* q, const void* k, const void* v,
                       void* o, float* lse, int B, int S, int T, int H,
                       const FwdRows& st, int causal, float sm_scale,
                       cudaStream_t stream) {
  const dim3 grid((S + FL_TILE - 1) / FL_TILE, H, B);
  if (dtype == DTYPE_BF16) {
    const size_t smem = fwd_mma_smem_bytes<KD>();
    cudaError_t e = allow_smem(flash_fwd_mma_kernel<KD>, smem);
    if (e != cudaSuccess) return e;
    flash_fwd_mma_kernel<KD><<<grid, FL_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        lse, S, T, H, st, causal, sm_scale);
    return cudaGetLastError();
  }
  if (dtype != DTYPE_F32) return cudaErrorInvalidValue;
  const size_t smem = fwd_f32_smem_bytes<KD>();
  cudaError_t e = allow_smem(flash_fwd_f32_kernel<KD>, smem);
  if (e != cudaSuccess) return e;
  flash_fwd_f32_kernel<KD><<<grid, FL_F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, T, H, st,
      causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rtt

// strides: 12 element strides, (b, s, h) of q, k, v and o in that order.
extern "C" int rtt_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, void* o, void* lse, int B, int S,
                             int T, int H, int K, const long long* strides,
                             int causal, float sm_scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  rtt::FwdRows st;
  rtt::Rows* r[4] = {&st.q, &st.k, &st.v, &st.o};
  rtt::unpack_rows(r, 4, strides);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 64:
      return (int)rtt::launch_fwd<64>(dtype, q, k, v, o, l, B, S, T, H, st,
                                      causal, sm_scale, s);
    case 128:
      return (int)rtt::launch_fwd<128>(dtype, q, k, v, o, l, B, S, T, H, st,
                                       causal, sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
