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
// 1024, H = 12, K = 64, bf16, causal) the bytes of q, k, v, o over 3.35
// TB/s (0.015 ms) exceed the 12.9 GFLOP of visible pairs over 989 TFLOP/s
// (0.013 ms); in practice the softmax's exponentials (one per pair on 16
// SFU lanes per SM, as many cycles as the products at head dim 64) and the
// products themselves.
//
// What the design does about it (bf16, attn_wgmma.cuh): persistent blocks,
// one per SM, take (128-row query tile, head, batch) items in a snake order
// over the longest-first list. A producer warp brings each item's Q in
// (double-buffered) and its K/V tiles of BN keys (128 at head dim 64, 64 at
// 128) through a four-stage ring by TMA, from 4-D tensor maps over q, k, v
// with their own strides (views of the qkv projection are read in place;
// rows past S or T arrive as zeros). Two consumer warpgroups of 64 rows run
// S = Q·K^T and O += P·V as wgmma (P from registers, V MN-major), so each
// K/V tile is read from shared memory once per 64 rows by the tensor cores
// themselves and from device memory once per 128 rows. The softmax folds
// sm_scale · log2 e into one FMA before a bare SFU exp2, keeps m in the log2
// domain, and masks only the tiles on the causal diagonal or the T edge;
// causal items stop at the tile's last row. fp32 inputs take a plain FMA
// kernel (shared tiles, 256 threads) so that fp32 keeps full precision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_wgmma.cuh"
#include "common.cuh"
#include "flash.cuh"

namespace rtt {
namespace {

struct FwdRows {
  Rows q, k, v, o;
};

// ---------------------------------------------------------------------------
// bf16 on wgmma (attn_wgmma.cuh). Persistent: one block per SM.

template <int KD>
__global__ void __launch_bounds__(ATT_THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int B, int S, int T,
                           int H, Rows ost, int causal, float c) {
  using Cfg = AttnCfg<KD, false>;
  constexpr int BN = Cfg::BN;
  extern __shared__ unsigned char smem_raw[];
  const int n_qt = (S + ATT_BM - 1) / ATT_BM;
  const int n_items = n_qt * H * B;
  AttnBars bar;
  unsigned char* base = attn_setup<Cfg::KV_ST>(smem_raw, Cfg::OFF_BAR, 1, bar);

  if (threadIdx.x < WG_THREADS) {
    regs_dec<ATT_PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    int g = 0, jq = 0;
    for (int k = 0;; ++k) {
      const int item = attn_item(k);
      if (item >= n_items) break;
      const QueryItem it = query_item<BN>(item, n_qt, S, T, H, B, causal);
      if (it.n_kt == 0) continue;
      const int qb = jq & 1;
      mbar_wait(bar.a_empty + qb, ((jq >> 1) & 1) ^ 1);
      mbar_expect_tx(bar.full_a + qb, Cfg::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < Cfg::NBOX; ++cb)
        tma_load_4d(attn_q<KD, false>(base, qb) + cb * ATT_BM * 128, &qmap,
                    bar.full_a + qb, cb * 64, it.h, it.q0, it.b);
      ++jq;
      for (int kt = 0; kt < it.n_kt; ++kt, ++g) {
        const int st = g % Cfg::KV_ST;
        mbar_wait(bar.empty + st, ((g / Cfg::KV_ST) & 1) ^ 1);
        unsigned char* kd = base + Cfg::OFF_K + st * Cfg::KV_BYTES;
        unsigned char* vd = base + Cfg::OFF_V + st * Cfg::KV_BYTES;
        mbar_expect_tx(bar.full_k + st, Cfg::KV_BYTES);
        mbar_expect_tx(bar.full_v + st, Cfg::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < Cfg::NBOX; ++cb) {
          tma_load_4d(kd + cb * BN * 128, &kmap, bar.full_k + st, cb * 64,
                      it.h, kt * BN, it.b);
          tma_load_4d(vd + cb * BN * 128, &vmap, bar.full_v + st, cb * 64,
                      it.h, kt * BN, it.b);
        }
      }
    }
  } else {
    regs_inc<ATT_CONSUMER_REGS>();
    const int wg = threadIdx.x / WG_THREADS - 1;
    const int lane = threadIdx.x & 31;
    int g = 0, jq = 0;
    for (int k = 0;; ++k) {
      const int item = attn_item(k);
      if (item >= n_items) break;
      const QueryItem it = query_item<BN>(item, n_qt, S, T, H, B, causal);
      const int r0 = it.q0 + wg * 64;
      float acc[KD / 2], m2[2], l[2];
      if (it.n_kt == 0) {  // T = 0: no key, o = 0 and lse = -1e30
#pragma unroll
        for (int i = 0; i < KD / 2; ++i) acc[i] = 0.f;
        m2[0] = m2[1] = NEG_INF;
        l[0] = l[1] = 0.f;
      } else {
        const int qb = jq & 1;
        mbar_wait(bar.full_a + qb, (jq >> 1) & 1);
        attn_mainloop<KD, false>(base, attn_q<KD, false>(base, qb), bar, wg,
                                 g, it.n_kt, T,
                                 causal ? r0 : ATT_NO_CAUSAL, c, acc, m2, l);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar.a_empty + qb);
        ++jq;
        g += it.n_kt;
      }
      attn_store<KD>(acc, m2, l,
                     o + it.b * ost.b + r0 * ost.s + it.h * ost.h, ost.s,
                     it.rows - wg * 64,
                     lse + ((long long)it.b * S + r0) * H + it.h, H);
    }
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
                       const long long* maps, cudaStream_t stream) {
  if (dtype == DTYPE_BF16) {
    constexpr int BN = AttnCfg<KD, false>::BN;
    const int rows[3] = {ATT_BM, BN, BN};  // q, k, v
    if (maps == nullptr || !tile_boxes_are(maps, rows, 3))
      return cudaErrorInvalidValue;
    CUtensorMap qm, km, vm;
    cudaError_t e = encode_tmap(&qm, q, maps);
    // T = 0: no key tile is ever loaded, and no map of k or v is encoded.
    if (e == cudaSuccess && T > 0) e = encode_tmap(&km, k, maps + TMAP_WORDS);
    if (e == cudaSuccess && T > 0)
      e = encode_tmap(&vm, v, maps + 2 * TMAP_WORDS);
    if (e != cudaSuccess) return e;
    if (T == 0) km = vm = qm;
    const int smem = AttnCfg<KD, false>::SMEM;
    e = allow_smem(flash_fwd_wgmma_kernel<KD>, smem);
    int grid = 0;
    if (e == cudaSuccess)
      e = attn_grid((S + ATT_BM - 1) / ATT_BM * H * B, &grid);
    if (e != cudaSuccess) return e;
    flash_fwd_wgmma_kernel<KD><<<grid, ATT_THREADS, smem, stream>>>(
        qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, B, S, T, H, st.o,
        causal, sm_scale * LOG2E);
    return cudaGetLastError();
  }
  if (dtype != DTYPE_F32) return cudaErrorInvalidValue;
  const dim3 grid((S + FL_TILE - 1) / FL_TILE, H, B);
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
// maps: bf16, the tensor maps of q, k and v (3 x TMAP_WORDS numbers from
// ops/attention.py `flash_plan`); NULL for fp32.
extern "C" int rtt_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, void* o, void* lse, int B, int S,
                             int T, int H, int K, const long long* strides,
                             int causal, float sm_scale,
                             const long long* maps, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  rtt::FwdRows st;
  rtt::Rows* r[4] = {&st.q, &st.k, &st.v, &st.o};
  rtt::unpack_rows(r, 4, strides);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 64:
      return (int)rtt::launch_fwd<64>(dtype, q, k, v, o, l, B, S, T, H, st,
                                      causal, sm_scale, maps, s);
    case 128:
      return (int)rtt::launch_fwd<128>(dtype, q, k, v, o, l, B, S, T, H, st,
                                       causal, sm_scale, maps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
