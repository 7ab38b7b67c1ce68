// Flash-attention BACKWARD kernels for Hopper (sm_90a): dq, and dk with dv.
//
// Replaces: ray_tpu/ops/attention.py, `_dq_kernel` and `_dkv_kernel` (Pallas
// TPU kernels launched by `_bwd_impl` behind `flash_attention`'s custom VJP).
// Same functions, from the forward's saved lse and the row term
// delta = rowsum(dO · O) - dlse (computed by the wrapper with torch ops, as
// JAX computes it outside its kernels, so an lse cotangent is folded in):
//   p  = exp(s · sm_scale - lse) on visible keys, 0 elsewhere (the mask of
//        the forward: t < T and, if causal, s >= t),
//   ds = p · (dO V^T - delta) · sm_scale, rounded to the input dtype,
//   dq = ds K,  dk = ds^T Q,  dv = round(p)^T dO,
// with fp32 accumulators rounded to the input dtype at the end and written
// with each gradient's own strides. lse and delta are fp32 [B, S, H] rows.
// A kernel that masks by the row index needs none of the JAX version's
// +1e30 lse padding of the query rows.
//
// What bounds it on the H100: at the training step's shapes (B = 8, S = T =
// 1024, H = 12, K = 64, bf16, causal) dq does 3 and dkv 4 products of
// 2·S·T·K/2 FLOPs per (batch, head), about 0.020 ms and 0.026 ms over 989
// TFLOP/s, against about 0.019 ms and 0.023 ms for their bytes over 3.35
// TB/s: operations, by a little.
//
// What the design does about it: like the forward, operands are read from
// device memory once per 64-row tile and the [S, T] score, probability and
// ds tiles never leave registers. Two kernels, as in the JAX split, so that
// no gradient needs atomics:
//  - dq: one block of four warps per (64-row query tile, head, batch); each
//    warp keeps its 16 rows' Q and dO fragments and its dq accumulator in
//    registers and walks the key tiles (K and V staged 64 rows at a time in
//    shared memory), running S = Q K^T and dP = dO V^T, then dq += dS K, as
//    mma.sync m16n8k16 bf16 products with fp32 accumulators.
//  - dkv: one block per (64-row key tile, head, batch); K and V stay in
//    shared memory, each warp owns 16 keys and their dk and dv accumulators,
//    and the block walks the query tiles (Q, dO, lse and delta staged in
//    shared memory), running S^T = K Q^T and dP^T = V dO^T, then
//    dv += P^T dO and dk += dS^T Q.
// The walked tiles are staged two deep with cp.async, so the next tile's
// loads are in flight while the current one is in the MMAs, and the
// fragments come from shared memory by ldmatrix.
// Causal walks stop at the diagonal (dq at the tile's last row, dkv starts
// at the first query tile that can see the keys), and a warp whose rows all
// precede (or whose keys all follow) a tile skips its math. fp32 inputs take
// plain FMA kernels of the same tiling so that fp32 keeps full precision.
// The next step is wgmma on the shared tiles with TMA loads in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "flash.cuh"

namespace rtt {
namespace {

struct DqRows {
  Rows q, k, v, dout, dq;
};

struct DkvRows {
  Rows q, k, v, dout, dk, dv;
};

// ---------------------------------------------------------------------------
// dq, bf16 tensor-core version.

// K and V tiles [64][KD + 8] bf16, two stages each.
template <int KD>
constexpr size_t dq_mma_smem_bytes() {
  return 4 * (size_t)FL_TILE * (KD + 8) * sizeof(__nv_bfloat16);
}

template <int KD>
__global__ void __launch_bounds__(FL_THREADS)
    flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int S, int T, int H,
                        DqRows st, int causal, float sm_scale) {
  constexpr int KSTEPS = KD / 16;
  constexpr int NT_S = FL_TILE / 8;
  constexpr int NT_O = KD / 8;
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
  const __nv_bfloat16* kb = k + b * st.k.b + h * st.k.h;
  const __nv_bfloat16* vb = v + b * st.v.b + h * st.v.h;

  // The first K/V tile starts loading before anything else.
  const int kv_end = causal ? min(T, q0 + rows) : T;
  const int n_kt = (kv_end + FL_TILE - 1) / FL_TILE;
  if (n_kt > 0) {
    load_tile_async<KD>(k_s, kb, st.k.s, 0, kv_end, tid, FL_THREADS);
    load_tile_async<KD>(v_s, vb, st.v.s, 0, kv_end, tid, FL_THREADS);
  }
  cp_async_commit();

  const int r0 = warp * 16 + g;
  const int r1 = r0 + 8;
  const int qpos0 = q0 + r0;
  const int qpos1 = q0 + r1;
  const bool in0 = r0 < rows;
  const bool in1 = r1 < rows;

  // Q and dO fragments in registers for the whole key walk; rows past S are 0.
  uint32_t qa[KSTEPS][4];
  uint32_t da[KSTEPS][4];
  {
    const __nv_bfloat16* qb = q + b * st.q.b + h * st.q.h;
    const __nv_bfloat16* db = dout + b * st.dout.b + h * st.dout.h;
    const uint32_t* q0p =
        reinterpret_cast<const uint32_t*>(qb + (in0 ? qpos0 : 0) * st.q.s);
    const uint32_t* q1p =
        reinterpret_cast<const uint32_t*>(qb + (in1 ? qpos1 : 0) * st.q.s);
    const uint32_t* d0p = reinterpret_cast<const uint32_t*>(
        db + (in0 ? qpos0 : 0) * st.dout.s);
    const uint32_t* d1p = reinterpret_cast<const uint32_t*>(
        db + (in1 ? qpos1 : 0) * st.dout.s);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int w = (ks * 16 + 2 * t4) / 2;
      qa[ks][0] = in0 ? q0p[w] : 0u;
      qa[ks][1] = in1 ? q1p[w] : 0u;
      qa[ks][2] = in0 ? q0p[w + 4] : 0u;
      qa[ks][3] = in1 ? q1p[w + 4] : 0u;
      da[ks][0] = in0 ? d0p[w] : 0u;
      da[ks][1] = in1 ? d1p[w] : 0u;
      da[ks][2] = in0 ? d0p[w + 4] : 0u;
      da[ks][3] = in1 ? d1p[w + 4] : 0u;
    }
  }
  const long long row0_at = ((long long)b * S + qpos0) * H + h;
  const long long row1_at = ((long long)b * S + qpos1) * H + h;
  const float lse0 = in0 ? lse[row0_at] : 0.f;
  const float lse1 = in1 ? lse[row1_at] : 0.f;
  const float dl0 = in0 ? delta[row0_at] : 0.f;
  const float dl1 = in1 ? delta[row1_at] : 0.f;

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

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
      float dp[NT_S][4];
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
      warp_abt_reg<KD>(s, qa, kt_s, lane);
      warp_abt_reg<KD>(dp, da, vt_s, lane);

      // ds in place of s.
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + n * 8 + 2 * t4 + (e & 1);
          const bool upper = e < 2;
          const bool ok = (upper ? in0 : in1) && key < T &&
                          (!causal || key <= (upper ? qpos0 : qpos1));
          const float p =
              ok ? __expf(s[n][e] * sm_scale - (upper ? lse0 : lse1)) : 0.f;
          s[n][e] = p * (dp[n][e] - (upper ? dl0 : dl1)) * sm_scale;
        }
      }
      uint32_t dsa[FL_TILE / 16][4];
      pack_a(dsa, s);  // ds rounded to bf16 before ds K
      warp_pv<KD>(acc, dsa, kt_s, lane);
    }
    __syncthreads();  // every warp is done with this stage
  }

  __nv_bfloat16* out = dq + b * st.dq.b + h * st.dq.h;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int col = n * 8 + 2 * t4;
    if (in0)
      *reinterpret_cast<uint32_t*>(out + qpos0 * st.dq.s + col) =
          pack_bf16x2(acc[n][0], acc[n][1]);
    if (in1)
      *reinterpret_cast<uint32_t*>(out + qpos1 * st.dq.s + col) =
          pack_bf16x2(acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// dk and dv, bf16 tensor-core version.

template <int KD>
constexpr size_t dkv_mma_smem_bytes() {
  // k and v tiles [64][KD + 8] bf16; q and dO tiles of the same shape and
  // lse and delta [64] fp32, two stages each.
  return 6 * (size_t)FL_TILE * (KD + 8) * sizeof(__nv_bfloat16) +
         4 * FL_TILE * sizeof(float);
}

template <int KD>
__global__ void __launch_bounds__(FL_THREADS)
    flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int S, int T, int H,
                         DkvRows st, int causal, float sm_scale) {
  constexpr int NT_S = FL_TILE / 8;
  constexpr int NT_O = KD / 8;
  constexpr int KP = KD + 8;
  constexpr int TS = FL_TILE * KP;  // elements of one tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + TS;
  __nv_bfloat16* q_s = v_s + TS;      // [2][TS]
  __nv_bfloat16* d_s = q_s + 2 * TS;  // [2][TS]
  float* lse_s = reinterpret_cast<float*>(d_s + 2 * TS);  // [2][64]
  float* dl_s = lse_s + 2 * FL_TILE;                      // [2][64]

  const int key0 = blockIdx.x * FL_TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const __nv_bfloat16* qb = q + b * st.q.b + h * st.q.h;
  const __nv_bfloat16* db = dout + b * st.dout.b + h * st.dout.h;
  const float* lse_b = lse + (long long)b * S * H + h;
  const float* dl_b = delta + (long long)b * S * H + h;

  const int n_qt = (S + FL_TILE - 1) / FL_TILE;
  const int first_qt = causal ? key0 / FL_TILE : 0;
  // Start loading query tile qt (Q, dO, lse, delta) into stage `stage`.
  auto prefetch = [&](int qt, int stage) {
    const int q0 = qt * FL_TILE;
    load_tile_async<KD>(q_s + stage * TS, qb, st.q.s, q0, S, tid, FL_THREADS);
    load_tile_async<KD>(d_s + stage * TS, db, st.dout.s, q0, S, tid,
                        FL_THREADS);
    for (int r = tid; r < FL_TILE; r += FL_THREADS) {
      const bool ok = q0 + r < S;
      const long long at = ok ? (long long)(q0 + r) * H : 0;
      cp_async4(&lse_s[stage * FL_TILE + r], lse_b + at, ok);
      cp_async4(&dl_s[stage * FL_TILE + r], dl_b + at, ok);
    }
  };

  // K and V of this block's keys, and the first query tile, in one group.
  load_tile_async<KD>(k_s, k + b * st.k.b + h * st.k.h, st.k.s, key0, T, tid,
                      FL_THREADS);
  load_tile_async<KD>(v_s, v + b * st.v.b + h * st.v.h, st.v.s, key0, T, tid,
                      FL_THREADS);
  if (first_qt < n_qt) prefetch(first_qt, 0);
  cp_async_commit();

  // This lane's two keys (fragment rows g and g + 8 of its warp).
  const int key_a = key0 + warp * 16 + g;
  const int key_b = key_a + 8;
  float acc_k[NT_O][4];
  float acc_v[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
    acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
  }

  const int warp_first_key = key0 + warp * 16;
  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int stage = (qt - first_qt) & 1;
    const int q0 = qt * FL_TILE;
    const int rows = min(FL_TILE, S - q0);
    if (qt + 1 < n_qt) prefetch(qt + 1, stage ^ 1);  // the other stage
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group is complete
    __syncthreads();
    const __nv_bfloat16* qt_s = q_s + stage * TS;
    const __nv_bfloat16* dt_s = d_s + stage * TS;
    const float* lt_s = lse_s + stage * FL_TILE;
    const float* et_s = dl_s + stage * FL_TILE;
    // A warp whose keys all follow this tile's rows skips its math.
    if (!causal || warp_first_key <= q0 + rows - 1) {
      float p[NT_S][4];   // S^T, then P^T: rows = this warp's keys
      float ds[NT_S][4];  // dP^T, then dS^T
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
        ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
      }
      warp_abt<KD>(p, k_s, warp * 16, qt_s, lane);
      warp_abt<KD>(ds, v_s, warp * 16, dt_s, lane);
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = n * 8 + 2 * t4 + (e & 1);  // query row in the tile
          const int key = e < 2 ? key_a : key_b;
          const bool ok = r < rows && key < T && (!causal || key <= q0 + r);
          const float pv = ok ? __expf(p[n][e] * sm_scale - lt_s[r]) : 0.f;
          p[n][e] = pv;
          ds[n][e] = pv * (ds[n][e] - et_s[r]) * sm_scale;
        }
      }
      uint32_t fa[FL_TILE / 16][4];
      pack_a(fa, p);  // p rounded to dO's dtype for dv
      warp_pv<KD>(acc_v, fa, dt_s, lane);
      pack_a(fa, ds);  // ds rounded to the input dtype for dk
      warp_pv<KD>(acc_k, fa, qt_s, lane);
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // K/V of a block with no query tile to visit

  __nv_bfloat16* dkb = dk + b * st.dk.b + h * st.dk.h;
  __nv_bfloat16* dvb = dv + b * st.dv.b + h * st.dv.h;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int col = n * 8 + 2 * t4;
    if (key_a < T) {
      *reinterpret_cast<uint32_t*>(dkb + key_a * st.dk.s + col) =
          pack_bf16x2(acc_k[n][0], acc_k[n][1]);
      *reinterpret_cast<uint32_t*>(dvb + key_a * st.dv.s + col) =
          pack_bf16x2(acc_v[n][0], acc_v[n][1]);
    }
    if (key_b < T) {
      *reinterpret_cast<uint32_t*>(dkb + key_b * st.dk.s + col) =
          pack_bf16x2(acc_k[n][2], acc_k[n][3]);
      *reinterpret_cast<uint32_t*>(dvb + key_b * st.dv.s + col) =
          pack_bf16x2(acc_v[n][2], acc_v[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 FMA versions.

constexpr int SP = FL_TILE + 1;  // pitch of a 64 x 64 score tile

template <int KD>
constexpr size_t dq_f32_smem_bytes() {
  // q, dO, k, v tiles [64][KD + 1], ds [64][65], lse and delta [64].
  return sizeof(float) * (4 * (size_t)FL_TILE * (KD + 1) +
                          (size_t)FL_TILE * SP + 2 * FL_TILE);
}

template <int KD>
constexpr size_t dkv_f32_smem_bytes() {
  // k, v, q, dO tiles [64][KD + 1], p and ds [64][65], lse and delta [64].
  return sizeof(float) * (4 * (size_t)FL_TILE * (KD + 1) +
                          2 * (size_t)FL_TILE * SP + 2 * FL_TILE);
}

// p and ds of query row r and key t of a tile pair, from the shared tiles.
template <int KD>
__device__ __forceinline__ void p_ds_f32(const float* q_row,
                                         const float* d_row,
                                         const float* k_row,
                                         const float* v_row, bool ok,
                                         float lse_r, float dl_r,
                                         float sm_scale, float& p,
                                         float& ds) {
  float s = 0.f, dp = 0.f;
#pragma unroll 16
  for (int c = 0; c < KD; ++c) {
    s += q_row[c] * k_row[c];
    dp += d_row[c] * v_row[c];
  }
  p = ok ? expf(s * sm_scale - lse_r) : 0.f;
  ds = p * (dp - dl_r) * sm_scale;
}

template <int KD>
__global__ void __launch_bounds__(FL_F32_THREADS)
    flash_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int T, int H,
                        DqRows st, int causal, float sm_scale) {
  constexpr int KP = KD + 1;
  constexpr int RG = FL_F32_THREADS / KD;
  constexpr int RPT = FL_TILE / RG;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* d_s = q_s + FL_TILE * KP;
  float* k_s = d_s + FL_TILE * KP;
  float* v_s = k_s + FL_TILE * KP;
  float* ds_s = v_s + FL_TILE * KP;
  float* lse_s = ds_s + FL_TILE * SP;
  float* dl_s = lse_s + FL_TILE;

  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * FL_TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rows = min(FL_TILE, S - q0);
  const float* kb = k + b * st.k.b + h * st.k.h;
  const float* vb = v + b * st.v.b + h * st.v.h;

  load_tile_f32<KD, KP>(q_s, q + b * st.q.b + h * st.q.h, st.q.s, q0, S, tid);
  load_tile_f32<KD, KP>(d_s, dout + b * st.dout.b + h * st.dout.h, st.dout.s,
                        q0, S, tid);
  for (int r = tid; r < FL_TILE; r += FL_F32_THREADS) {
    const long long at = ((long long)b * S + q0 + r) * H + h;
    lse_s[r] = r < rows ? lse[at] : 0.f;
    dl_s[r] = r < rows ? delta[at] : 0.f;
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
    load_tile_f32<KD, KP>(v_s, vb, st.v.s, key0, kv_end, tid);
    __syncthreads();
    for (int i = tid; i < FL_TILE * FL_TILE; i += FL_F32_THREADS) {
      const int r = i / FL_TILE, t = i % FL_TILE;
      const int key = key0 + t;
      const bool ok = r < rows && key < T && (!causal || key <= q0 + r);
      float p, ds;
      p_ds_f32<KD>(q_s + r * KP, d_s + r * KP, k_s + t * KP, v_s + t * KP, ok,
                   lse_s[r], dl_s[r], sm_scale, p, ds);
      ds_s[r * SP + t] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rgrp + i * RG;
      float a = 0.f;
#pragma unroll 16
      for (int t = 0; t < FL_TILE; ++t)
        a += ds_s[r * SP + t] * k_s[t * KP + kcol];
      acc[i] += a;
    }
  }
  float* out = dq + b * st.dq.b + h * st.dq.h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rgrp + i * RG;
    if (r < rows) out[(q0 + r) * st.dq.s + kcol] = acc[i];
  }
}

template <int KD>
__global__ void __launch_bounds__(FL_F32_THREADS)
    flash_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int S,
                         int T, int H, DkvRows st, int causal,
                         float sm_scale) {
  constexpr int KP = KD + 1;
  constexpr int RG = FL_F32_THREADS / KD;
  constexpr int RPT = FL_TILE / RG;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + FL_TILE * KP;
  float* q_s = v_s + FL_TILE * KP;
  float* d_s = q_s + FL_TILE * KP;
  float* p_s = d_s + FL_TILE * KP;   // [key][query]
  float* ds_s = p_s + FL_TILE * SP;  // [key][query]
  float* lse_s = ds_s + FL_TILE * SP;
  float* dl_s = lse_s + FL_TILE;

  const int key0 = blockIdx.x * FL_TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* qb = q + b * st.q.b + h * st.q.h;
  const float* db = dout + b * st.dout.b + h * st.dout.h;
  load_tile_f32<KD, KP>(k_s, k + b * st.k.b + h * st.k.h, st.k.s, key0, T,
                        tid);
  load_tile_f32<KD, KP>(v_s, v + b * st.v.b + h * st.v.h, st.v.s, key0, T,
                        tid);
  const int kcol = tid % KD;
  const int rgrp = tid / KD;
  float acc_k[RPT];
  float acc_v[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc_k[i] = acc_v[i] = 0.f;

  const int n_qt = (S + FL_TILE - 1) / FL_TILE;
  const int first_qt = causal ? key0 / FL_TILE : 0;
  for (int qt = first_qt; qt < n_qt; ++qt) {
    const int q0 = qt * FL_TILE;
    const int rows = min(FL_TILE, S - q0);
    __syncthreads();
    load_tile_f32<KD, KP>(q_s, qb, st.q.s, q0, S, tid);
    load_tile_f32<KD, KP>(d_s, db, st.dout.s, q0, S, tid);
    for (int r = tid; r < FL_TILE; r += FL_F32_THREADS) {
      const long long at = ((long long)b * S + q0 + r) * H + h;
      lse_s[r] = r < rows ? lse[at] : 0.f;
      dl_s[r] = r < rows ? delta[at] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < FL_TILE * FL_TILE; i += FL_F32_THREADS) {
      const int t = i / FL_TILE, r = i % FL_TILE;
      const int key = key0 + t;
      const bool ok = r < rows && key < T && (!causal || key <= q0 + r);
      float p, ds;
      p_ds_f32<KD>(q_s + r * KP, d_s + r * KP, k_s + t * KP, v_s + t * KP, ok,
                   lse_s[r], dl_s[r], sm_scale, p, ds);
      p_s[t * SP + r] = p;
      ds_s[t * SP + r] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = rgrp + i * RG;
      float av = 0.f, ak = 0.f;
#pragma unroll 16
      for (int r = 0; r < FL_TILE; ++r) {
        av += p_s[t * SP + r] * d_s[r * KP + kcol];
        ak += ds_s[t * SP + r] * q_s[r * KP + kcol];
      }
      acc_v[i] += av;
      acc_k[i] += ak;
    }
  }
  float* dkb = dk + b * st.dk.b + h * st.dk.h;
  float* dvb = dv + b * st.dv.b + h * st.dv.h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = key0 + rgrp + i * RG;
    if (key < T) {
      dkb[key * st.dk.s + kcol] = acc_k[i];
      dvb[key * st.dv.s + kcol] = acc_v[i];
    }
  }
}

template <int KD>
cudaError_t launch_dq(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int S, int T, int H, const DqRows& st,
                      int causal, float sm_scale, cudaStream_t stream) {
  const dim3 grid((S + FL_TILE - 1) / FL_TILE, H, B);
  if (dtype == DTYPE_BF16) {
    const size_t smem = dq_mma_smem_bytes<KD>();
    cudaError_t e = allow_smem(flash_dq_mma_kernel<KD>, smem);
    if (e != cudaSuccess) return e;
    flash_dq_mma_kernel<KD><<<grid, FL_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dq), S, T, H, st, causal, sm_scale);
    return cudaGetLastError();
  }
  if (dtype != DTYPE_F32) return cudaErrorInvalidValue;
  const size_t smem = dq_f32_smem_bytes<KD>();
  cudaError_t e = allow_smem(flash_dq_f32_kernel<KD>, smem);
  if (e != cudaSuccess) return e;
  flash_dq_f32_kernel<KD><<<grid, FL_F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), S, T, H, st, causal, sm_scale);
  return cudaGetLastError();
}

template <int KD>
cudaError_t launch_dkv(int dtype, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int S, int T, int H,
                       const DkvRows& st, int causal, float sm_scale,
                       cudaStream_t stream) {
  const dim3 grid((T + FL_TILE - 1) / FL_TILE, H, B);
  if (dtype == DTYPE_BF16) {
    const size_t smem = dkv_mma_smem_bytes<KD>();
    cudaError_t e = allow_smem(flash_dkv_mma_kernel<KD>, smem);
    if (e != cudaSuccess) return e;
    flash_dkv_mma_kernel<KD><<<grid, FL_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S,
        T, H, st, causal, sm_scale);
    return cudaGetLastError();
  }
  if (dtype != DTYPE_F32) return cudaErrorInvalidValue;
  const size_t smem = dkv_f32_smem_bytes<KD>();
  cudaError_t e = allow_smem(flash_dkv_f32_kernel<KD>, smem);
  if (e != cudaSuccess) return e;
  flash_dkv_f32_kernel<KD><<<grid, FL_F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), S, T, H, st,
      causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rtt

// strides: 15 element strides, (b, s, h) of q, k, v, dO and dq in order.
extern "C" int rtt_flash_dq(int dtype, const void* q, const void* k,
                            const void* v, const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int S, int T,
                            int H, int K, const long long* strides, int causal,
                            float sm_scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  rtt::DqRows st;
  rtt::Rows* r[5] = {&st.q, &st.k, &st.v, &st.dout, &st.dq};
  rtt::unpack_rows(r, 5, strides);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 64:
      return (int)rtt::launch_dq<64>(dtype, q, k, v, dout, l, d, dq, B, S, T,
                                     H, st, causal, sm_scale, s);
    case 128:
      return (int)rtt::launch_dq<128>(dtype, q, k, v, dout, l, d, dq, B, S, T,
                                      H, st, causal, sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// strides: 18 element strides, (b, s, h) of q, k, v, dO, dk and dv in order.
extern "C" int rtt_flash_dkv(int dtype, const void* q, const void* k,
                             const void* v, const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int S, int T, int H, int K,
                             const long long* strides, int causal,
                             float sm_scale, void* stream) {
  if (B == 0 || T == 0 || H == 0) return (int)cudaSuccess;
  rtt::DkvRows st;
  rtt::Rows* r[6] = {&st.q, &st.k, &st.v, &st.dout, &st.dk, &st.dv};
  rtt::unpack_rows(r, 6, strides);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 64:
      return (int)rtt::launch_dkv<64>(dtype, q, k, v, dout, l, d, dk, dv, B,
                                      S, T, H, st, causal, sm_scale, s);
    case 128:
      return (int)rtt::launch_dkv<128>(dtype, q, k, v, dout, l, d, dk, dv, B,
                                       S, T, H, st, causal, sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
