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
// TB/s: operations, by a little; and one exponential per visible pair on
// the SFU (16 a clock per SM), as many cycles as a third of dq's products.
//
// What the design does about it (bf16): the structure of the forward
// (attn_wgmma.cuh). Persistent blocks, one per SM, take work items longest
// first in snake order (`attn_item`); warp 0 of the producer warpgroup
// brings tiles in by TMA from 4-D tensor maps over q, k, v and dO with
// their own strides (views of the qkv projection are read in place; rows
// past S or T arrive as zeros); two consumer warpgroups of 64 rows run
// every product as wgmma, with p = exp2(s · c - lse · log2 e) on the SFU
// (c = sm_scale · log2 e). Two kernels, as in the JAX split, so that no
// gradient needs atomics:
//  - flash_dq_wgmma_kernel, query-major: an item is 128 query rows of one
//    (head, batch). Its Q and dO are double-buffered; its rows' lse and
//    delta go to registers once per item (lse · log2 e - log2 sm_scale, so
//    that p carries sm_scale and ds = p (dP - delta) saves a multiply); a
//    ring of K/V tiles (BN = 128
//    keys at head dim 64 in four stages, 64 at 128 in three) runs on
//    across items. Per tile: S = Q·K^T and dP = dO·V^T (both operands
//    K-major, two commit groups, so p is computed from S while dP is on
//    the tensor cores), ds rounded to bf16 as register A fragments, and
//    dq += dS·K with K read MN-major from the same tile. Causal items stop
//    at their last row and are taken longest first (the last query tiles).
//  - flash_dkv_wgmma_kernel, key-major: an item is 128 keys of one (head,
//    batch), each consumer warpgroup owning 64 keys and their fp32 dk and
//    dv accumulators. The item's K and V are double-buffered and stay in
//    shared memory; a ring of 64-row Q and dO tiles (four stages at head
//    dim 64, three at 128) carries each tile's lse · log2 e and delta ·
//    sm_scale (so dS^T = P^T fma(dP^T, sm_scale, -delta · sm_scale)),
//    which warp 1 of the producer warpgroup stages with plain loads
//    (a box of one head's [B, S, H] rows is 4·H bytes apart, which TMA
//    cannot box) and marks with 32 arrivals on the tile's barrier. Per
//    tile: S^T = K·Q^T and dP^T = V·dO^T, P^T and dS^T = P^T (dP^T -
//    delta) sm_scale, then dv += round(P^T)·dO and dk += round(dS^T)·Q with
//    dO and Q read MN-major. At head dim 64 the dv product is issued
//    before dS^T is computed; at 128 both wait for dS^T, which keeps the
//    consumers' peak at 64 + 64 accumulators + 32 + 32 scores a thread.
//    Causal walks start at the first query tile that sees the item's keys;
//    the longest items are the first key tiles.
// Where trouble was expected, and what the kernels do about it:
//  1. lse and delta: registers per item in dq; staged per tile in dkv (see
//     above), in the column layout of S^T (thread t of a warp reads
//     columns 8j + 2t + e as one float2).
//  2. Registers: the walked tile stays at 64 rows in dkv, so a consumer
//     holds at most 192 fp32 values (head dim 128), under the 232 that
//     setmaxnreg grants.
//  3. Shared memory at head dim 128: dkv keeps K and V double-buffered (128
//     KB) and takes three ring stages (96 KB): 232,040 bytes with the
//     alignment slack; dq takes three K/V stages.
//  4. Ragged edges: only the tiles on the causal diagonal or past S or T
//     mask, explicitly by row and key index (a zero-filled row of dkv
//     would otherwise read lse = 0 and give p = 1; a zero-filled key of dq
//     an unbounded p for an empty row).
//  5. One tile in flight per warpgroup: S and dP are separate commit
//     groups, in dkv the dv product overlaps dS^T (head dim 64), and each
//     tile's last product is waited for only after the next tile's first
//     two are issued (dq; dkv at head dim 64), so the tensor cores do not
//     drain between tiles. Measured in turns on the H100 (PERF.md, "Tries"):
//     the deferred wait gained 2% in dkv and nothing in dq; one multiply
//     less per score (sm_scale folded into p, delta) 7% in dq; descriptors
//     as the tile's plus constants 2% in both. The two warpgroups issuing
//     in turns (one's products over the other's exponentials) lost 20-30%
//     through named barriers, which made ptxas spill, and through
//     mbarriers moved dq by -2% and dkv by +3%: not kept. Nor were
//     128-row walked tiles in dkv at head dim 64 (the same time).
// fp32 inputs take plain FMA kernels (64-row tiles, 256 threads) so that
// fp32 keeps full precision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_wgmma.cuh"
#include "common.cuh"
#include "flash.cuh"
#include "hopper.cuh"

namespace rtt {
namespace {

struct DqRows {
  Rows q, k, v, dout, dq;
};

struct DkvRows {
  Rows q, k, v, dout, dk, dv;
};

// ---------------------------------------------------------------------------
// bf16 on wgmma. Persistent: one block per SM, the forward's warp roles
// (warpgroup 0 the producer, warpgroups 1 and 2 the consumers).

// The barriers are attn_wgmma.cuh's (`attn_setup`, no staging stages):
// per item buffer (dq: Q and dO; dkv: K and V) full_a and a_empty; per
// ring stage full_k (dq: the K tile's bytes; dkv: the Q tile's bytes and
// the staging warp's 32 arrivals), full_v (dq: V; dkv: dO) and empty.

// Release ring stage st: every consumer warp arrives once, after the
// warpgroup's products that read the stage are done.
__device__ __forceinline__ void release_now(const AttnBars& bar, int st) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar.empty + st);
}

// Release the stage `pend` held back for a product in flight (none: -1);
// the caller has waited for that product.
__device__ __forceinline__ void release_stage(const AttnBars& bar, int& pend) {
  if (pend >= 0) release_now(bar, pend);
  pend = -1;
}

// A warpgroup's fp32 accumulator (the wgmma layout: thread rows r0 and
// r0 + 8, columns 8j + 2t + e) in bf16 at `out` (the warpgroup's row 0,
// rows `row_stride` elements apart); rows at or past `rows` are not
// written.
template <int KD>
__device__ __forceinline__ void store_acc(const float (&a)[KD / 2],
                                          __nv_bfloat16* out,
                                          long long row_stride, int rows) {
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < KD / 8; ++j) {
    const int col = 8 * j + t2;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(out + r0 * row_stride + col) =
          pack_bf16x2(a[4 * j], a[4 * j + 1]);
    if (r0 + 8 < rows)
      *reinterpret_cast<uint32_t*>(out + (r0 + 8) * row_stride + col) =
          pack_bf16x2(a[4 * j + 2], a[4 * j + 3]);
  }
}

// d (+)= A·B^T over KD columns, A (64 rows) and B (N rows) both K-major
// 128-byte-swizzled tiles in column boxes of 64, A_ROWS and B_ROWS rows a
// box: S = Q·K^T, dP = dO·V^T and their transposes in dkv. One commit
// group. Each k-step's descriptor is the tile's plus a constant: the
// start address is the descriptor's low field, in 16-byte units.
template <int KD, int A_ROWS, int B_ROWS, int R>
__device__ __forceinline__ void wgmma_abt(float (&d)[R], uint32_t a_addr,
                                          uint32_t b_addr) {
  const uint64_t da = sw128_desc(a_addr, 16, 1024);
  const uint64_t db = sw128_desc(b_addr, 16, 1024);
#pragma unroll
  for (int ks = 0; ks < KD / 16; ++ks)
    wgmma_ss(d, da + ((ks >> 2) * A_ROWS * 128 + (ks & 3) * 32) / 16,
             db + ((ks >> 2) * B_ROWS * 128 + (ks & 3) * 32) / 16, ks > 0);
  wgmma_commit();
}

// d += A·B for A in register fragments (N16 k-steps of 16) and B an
// MN-major tile of N16 · 16 rows (dq: K; dkv: dO and Q) at b_addr. No
// commit: the caller groups the products.
template <int N16, int R>
__device__ __forceinline__ void wgmma_ab(float (&d)[R],
                                         const uint32_t (&a)[N16][4],
                                         uint32_t b_addr) {
  const uint64_t db = sw128_desc(b_addr, N16 * 16 * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < N16; ++kk)
    wgmma_rs(d, a[kk], db + kk * 16 * 128 / 16, 1);
}

// ------------------------------------------------------------------- dq

template <int KD>
struct DqCfg {
  static_assert(KD == 64 || KD == 128, "head dim 64 or 128");
  static constexpr int BN = KD == 64 ? 128 : 64;  // keys per tile (key_tile)
  static constexpr int NBOX = KD / 64;
  static constexpr int ST = KD == 64 ? 4 : 3;     // K/V ring stages
  static constexpr int Q_BYTES = ATT_BM * KD * 2;  // Q (or dO) of one item
  static constexpr int KV_BYTES = BN * KD * 2;     // one K or V tile
  static constexpr int OFF_Q = 0;                  // [2 buffers]
  static constexpr int OFF_DO = OFF_Q + 2 * Q_BYTES;
  static constexpr int OFF_K = OFF_DO + 2 * Q_BYTES;  // [ST stages]
  static constexpr int OFF_V = OFF_K + ST * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + ST * KV_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (4 + 3 * ST) + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

// One consumer warpgroup's walk over an item's n_kt K/V tiles (the block's
// tiles g0, g0 + 1, ...), its Q and dO in buffer qb. Row r (warpgroup-
// local) sees key t when t < kv_lim and t <= qpos0 + r; l2 and dl are the
// lse · log2 e - log2 sm_scale and delta of this thread's rows r0 and
// r0 + 8.
template <int KD>
__device__ __forceinline__ void dq_mainloop(unsigned char* base, int qb,
                                            const AttnBars& bar, int wg,
                                            int g0, int n_kt, int kv_lim,
                                            int qpos0, float c,
                                            const float (&l2)[2],
                                            const float (&dl)[2],
                                            float (&acc)[KD / 2]) {
  using Cfg = DqCfg<KD>;
  constexpr int BN = Cfg::BN;
  constexpr int NS = BN / 2;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int t2 = 2 * (lane & 3);
  const uint32_t q_addr =
      smem_u32(base + Cfg::OFF_Q + qb * Cfg::Q_BYTES) + wg * 64 * 128;
  const uint32_t d_addr =
      smem_u32(base + Cfg::OFF_DO + qb * Cfg::Q_BYTES) + wg * 64 * 128;
  const int lim_base0 = min(kv_lim - 1, qpos0 + r0);
  const int lim_base1 = min(kv_lim - 1, qpos0 + r0 + 8);
  int pend = -1;  // the stage whose dq product is still in flight
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = (g0 + kt) % Cfg::ST;
    const uint32_t ph = ((g0 + kt) / Cfg::ST) & 1;
    const int key0 = kt * BN;
    const uint32_t k_addr = smem_u32(base + Cfg::OFF_K + st * Cfg::KV_BYTES);
    const uint32_t v_addr = smem_u32(base + Cfg::OFF_V + st * Cfg::KV_BYTES);
    mbar_wait(bar.full_k + st, ph);
    mbar_wait(bar.full_v + st, ph);
    if (key0 <= qpos0 + 63) {
      float s[NS], dp[NS];
      wgmma_fence();
      wgmma_abt<KD, ATT_BM, BN>(s, q_addr, k_addr);
      wgmma_abt<KD, ATT_BM, BN>(dp, d_addr, v_addr);
      wgmma_wait<1>();  // S, and the previous tile's dq product
      fence_regs(s);
      release_stage(bar, pend);
      // p while dP is on the tensor cores; masked only on edge tiles.
      const bool edge = key0 + BN > kv_lim || key0 + BN - 1 > qpos0;
      const int lim0 = lim_base0 - key0;
      const int lim1 = lim_base1 - key0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = exp2_sfu(fmaf(s[4 * j + e], c, -l2[0]));
          float p1 = exp2_sfu(fmaf(s[4 * j + 2 + e], c, -l2[1]));
          if (edge) {
            const int col = 8 * j + t2 + e;
            if (col > lim0) p0 = 0.f;
            if (col > lim1) p1 = 0.f;
          }
          s[4 * j + e] = p0;
          s[4 * j + 2 + e] = p1;
        }
      wgmma_wait<0>();
      fence_regs(dp);
      // ds = p (dp - delta) sm_scale (sm_scale is in p: l2 holds its
      // log2), rounded to bf16 as A fragments: k-step kk covers keys
      // 16kk .. 16kk + 15, fragment q the columns of j = 2kk + q / 2 in
      // row half q % 2.
      uint32_t da[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 8 * kk + 2 * q;
          const float d = dl[q & 1];
          da[kk][q] =
              pack_bf16x2(s[i] * (dp[i] - d), s[i + 1] * (dp[i + 1] - d));
        }
      fence_regs(acc);
      wgmma_fence();
      wgmma_ab(acc, da, k_addr);
      wgmma_commit();
      pend = st;  // released once the product is done, next tile or below
    } else {
      release_now(bar, st);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release_stage(bar, pend);
}

template <int KD>
__global__ void __launch_bounds__(ATT_THREADS, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap dmap,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int B, int S,
                          int T, int H, Rows dst, int causal, float c,
                          float scale) {
  using Cfg = DqCfg<KD>;
  constexpr int BN = Cfg::BN;
  extern __shared__ unsigned char smem_raw[];
  const int n_qt = (S + ATT_BM - 1) / ATT_BM;
  const int n_items = n_qt * H * B;
  AttnBars bar;
  unsigned char* base = attn_setup<Cfg::ST>(smem_raw, Cfg::OFF_BAR, 1, bar);

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
      mbar_expect_tx(bar.full_a + qb, 2 * Cfg::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < Cfg::NBOX; ++cb) {
        const int off = qb * Cfg::Q_BYTES + cb * ATT_BM * 128;
        tma_load_4d(base + Cfg::OFF_Q + off, &qmap, bar.full_a + qb, cb * 64,
                    it.h, it.q0, it.b);
        tma_load_4d(base + Cfg::OFF_DO + off, &dmap, bar.full_a + qb,
                    cb * 64, it.h, it.q0, it.b);
      }
      ++jq;
      for (int kt = 0; kt < it.n_kt; ++kt, ++g) {
        const int st = g % Cfg::ST;
        mbar_wait(bar.empty + st, ((g / Cfg::ST) & 1) ^ 1);
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
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int r0 = (tid >> 5) * 16 + (lane >> 2);
    const float log2_scale = log2f(scale);
    int g = 0, jq = 0;
    for (int k = 0;; ++k) {
      const int item = attn_item(k);
      if (item >= n_items) break;
      const QueryItem it = query_item<BN>(item, n_qt, S, T, H, B, causal);
      const int qw = it.q0 + wg * 64;  // the warpgroup's first row
      float acc[KD / 2];
#pragma unroll
      for (int i = 0; i < KD / 2; ++i) acc[i] = 0.f;
      if (it.n_kt > 0) {  // T = 0: no key, dq = 0
        float l2[2], dl[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = qw + r0 + 8 * h;
          const long long at = ((long long)it.b * S + row) * H + it.h;
          l2[h] = row < S ? lse[at] * LOG2E - log2_scale : 0.f;
          dl[h] = row < S ? delta[at] : 0.f;
        }
        const int qb = jq & 1;
        mbar_wait(bar.full_a + qb, (jq >> 1) & 1);
        dq_mainloop<KD>(base, qb, bar, wg, g, it.n_kt, T,
                        causal ? qw : ATT_NO_CAUSAL, c, l2, dl, acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar.a_empty + qb);
        ++jq;
        g += it.n_kt;
      }
      store_acc<KD>(acc, dq + it.b * dst.b + qw * dst.s + it.h * dst.h,
                    dst.s, it.rows - wg * 64);
    }
  }
}

// ------------------------------------------------------------------ dkv

// Keys per item (two warpgroups of 64) and query rows per walked tile: the
// box rows of ops/attention.py `flash_dkv_plan`, checked at launch.
constexpr int DKV_KEYS = 128;
constexpr int DKV_ROWS = 64;
constexpr int STAGE_WARP_ARRIVALS = 32;

template <int KD>
struct DkvCfg {
  static_assert(KD == 64 || KD == 128, "head dim 64 or 128");
  static constexpr int NBOX = KD / 64;
  static constexpr int ST = KD == 64 ? 4 : 3;        // Q/dO ring stages
  static constexpr int KV_BYTES = DKV_KEYS * KD * 2;  // K (or V) of one item
  static constexpr int Q_BYTES = DKV_ROWS * KD * 2;   // one Q or dO tile
  static constexpr int OFF_K = 0;                     // [2 buffers]
  static constexpr int OFF_V = OFF_K + 2 * KV_BYTES;
  static constexpr int OFF_Q = OFF_V + 2 * KV_BYTES;  // [ST stages]
  static constexpr int OFF_DO = OFF_Q + ST * Q_BYTES;
  // [ST][lse · log2 e, delta · sm_scale][DKV_ROWS] fp32
  static constexpr int OFF_ROW = OFF_DO + ST * Q_BYTES;
  static constexpr int OFF_BAR = OFF_ROW + ST * 2 * DKV_ROWS * 4;
  static constexpr int SMEM = OFF_BAR + 8 * (4 + 3 * ST) + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

// Work item `item`: a tile of DKV_KEYS keys of one (head, batch), longest
// first (the first key tiles, when causal), and its walk over the query
// tiles first_qt .. n_qt - 1.
struct DkvItem {
  int key0, h, b, first_qt, n_walk;
};

__device__ __forceinline__ DkvItem dkv_item(int item, int n_qt, int H,
                                            int B, int causal) {
  DkvItem it;
  const int rank = item / (H * B);
  const int hb = item - rank * (H * B);
  it.h = hb % H;
  it.b = hb / H;
  it.key0 = rank * DKV_KEYS;
  it.first_qt = causal ? it.key0 / DKV_ROWS : 0;
  it.n_walk = max(0, n_qt - it.first_qt);
  return it;
}

// One consumer warpgroup's walk over an item's query tiles (the block's
// ring tiles g0, g0 + 1, ...), its K and V in buffer kb; kw is the
// warpgroup's first key. Accumulates dk (ak) and dv (av) of this thread's
// keys kw + r0 and kw + r0 + 8.
template <int KD>
__device__ __forceinline__ void dkv_mainloop(unsigned char* base, int kb,
                                             const AttnBars& bar, int wg,
                                             int g0, const DkvItem& it,
                                             int kw, int S, int causal,
                                             float c, float scale,
                                             float (&ak)[KD / 2],
                                             float (&av)[KD / 2]) {
  using Cfg = DkvCfg<KD>;
  constexpr int BQ = DKV_ROWS;
  constexpr int NS = BQ / 2;
  // Registers allow overlap at head dim 64 only: P^T's fragments stay
  // live across the dv product, and the next tile's S^T and dP^T are
  // issued before this tile's dk and dv products are waited for.
  constexpr bool OVERLAP = KD == 64;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int t2 = 2 * (lane & 3);
  const int key_a = kw + r0;
  const int key_b = key_a + 8;
  const uint32_t k_addr =
      smem_u32(base + Cfg::OFF_K + kb * Cfg::KV_BYTES) + wg * 64 * 128;
  const uint32_t v_addr =
      smem_u32(base + Cfg::OFF_V + kb * Cfg::KV_BYTES) + wg * 64 * 128;
  int pend = -1;  // the stage whose dk and dv products are still in flight
  for (int i = 0; i < it.n_walk; ++i) {
    const int gi = g0 + i;
    const int st = gi % Cfg::ST;
    const uint32_t ph = (gi / Cfg::ST) & 1;
    const int q0 = (it.first_qt + i) * BQ;
    const uint32_t q_addr = smem_u32(base + Cfg::OFF_Q + st * Cfg::Q_BYTES);
    const uint32_t d_addr = smem_u32(base + Cfg::OFF_DO + st * Cfg::Q_BYTES);
    const float* rl =
        reinterpret_cast<const float*>(base + Cfg::OFF_ROW) + st * 2 * BQ;
    mbar_wait(bar.full_k + st, ph);
    mbar_wait(bar.full_v + st, ph);
    // Skip a tile whose rows all precede the warpgroup's keys.
    if (!causal || kw <= q0 + BQ - 1) {
      float s[NS], dp[NS];
      wgmma_fence();
      wgmma_abt<KD, DKV_KEYS, BQ>(s, k_addr, q_addr);
      wgmma_abt<KD, DKV_KEYS, BQ>(dp, v_addr, d_addr);
      wgmma_wait<1>();  // S^T, and the previous tile's dk and dv products
      fence_regs(s);
      release_stage(bar, pend);
      // P^T: rows are keys, columns query rows q0 + 8j + t2 + e. Masked
      // only on tiles past S or across the causal diagonal.
      const bool edge = q0 + BQ > S || (causal && q0 < kw + 63);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(rl + 8 * j + t2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[4 * j + 2 * h] = exp2_sfu(fmaf(s[4 * j + 2 * h], c, -l2.x));
          s[4 * j + 2 * h + 1] = exp2_sfu(fmaf(s[4 * j + 2 * h + 1], c, -l2.y));
        }
        if (edge) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = q0 + 8 * j + t2 + e;
            const bool in = row < S;
            if (!in || (causal && key_a > row)) s[4 * j + e] = 0.f;
            if (!in || (causal && key_b > row)) s[4 * j + 2 + e] = 0.f;
          }
        }
      }
      // round(P^T) as A fragments (the layout of dq's ds).
      uint32_t pa[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pa[kk][q] = pack_bf16x2(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
      if constexpr (OVERLAP) {  // dv += P^T·dO while dS^T is computed
        fence_regs(av);
        wgmma_fence();
        wgmma_ab(av, pa, d_addr);
        wgmma_commit();
        wgmma_wait<1>();  // dP^T
      } else {
        wgmma_wait<0>();
      }
      fence_regs(dp);
      uint32_t da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i2 = 8 * kk + 2 * q;
          const float2 d = *reinterpret_cast<const float2*>(
              rl + BQ + 16 * kk + 8 * (q >> 1) + t2);
          da[kk][q] = pack_bf16x2(s[i2] * fmaf(dp[i2], scale, -d.x),
                                  s[i2 + 1] * fmaf(dp[i2 + 1], scale, -d.y));
        }
      fence_regs(ak);
      wgmma_fence();
      if constexpr (!OVERLAP) {
        fence_regs(av);
        wgmma_ab(av, pa, d_addr);
      }
      wgmma_ab(ak, da, q_addr);
      wgmma_commit();
      pend = st;  // released once the products are done
      if constexpr (!OVERLAP) {
        wgmma_wait<0>();
        release_stage(bar, pend);
      }
    } else {
      release_now(bar, st);
    }
  }
  wgmma_wait<0>();
  fence_regs(av);
  fence_regs(ak);
  release_stage(bar, pend);
}

template <int KD>
__global__ void __launch_bounds__(ATT_THREADS, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap dmap,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int B, int S,
                           int T, int H, Rows kst, Rows vst, int causal,
                           float c, float scale) {
  using Cfg = DkvCfg<KD>;
  constexpr int BQ = DKV_ROWS;
  extern __shared__ unsigned char smem_raw[];
  const int n_qt = (S + BQ - 1) / BQ;
  const int n_items = (T + DKV_KEYS - 1) / DKV_KEYS * H * B;
  AttnBars bar;
  unsigned char* base = attn_setup<Cfg::ST>(
      smem_raw, Cfg::OFF_BAR, 1 + STAGE_WARP_ARRIVALS, bar);

  if (threadIdx.x < WG_THREADS) {
    regs_dec<ATT_PRODUCER_REGS>();
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    if (warp == 0 && lane == 0) {  // TMA: K, V per item; Q, dO per tile
      int g = 0, jk = 0;
      for (int k = 0;; ++k) {
        const int item = attn_item(k);
        if (item >= n_items) break;
        const DkvItem it = dkv_item(item, n_qt, H, B, causal);
        if (it.n_walk == 0) continue;
        const int kb = jk & 1;
        mbar_wait(bar.a_empty + kb, ((jk >> 1) & 1) ^ 1);
        mbar_expect_tx(bar.full_a + kb, 2 * Cfg::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < Cfg::NBOX; ++cb) {
          const int off = kb * Cfg::KV_BYTES + cb * DKV_KEYS * 128;
          tma_load_4d(base + Cfg::OFF_K + off, &kmap, bar.full_a + kb,
                      cb * 64, it.h, it.key0, it.b);
          tma_load_4d(base + Cfg::OFF_V + off, &vmap, bar.full_a + kb,
                      cb * 64, it.h, it.key0, it.b);
        }
        ++jk;
        for (int i = 0; i < it.n_walk; ++i, ++g) {
          const int st = g % Cfg::ST;
          const int q0 = (it.first_qt + i) * BQ;
          mbar_wait(bar.empty + st, ((g / Cfg::ST) & 1) ^ 1);
          mbar_expect_tx(bar.full_k + st, Cfg::Q_BYTES);
          mbar_expect_tx(bar.full_v + st, Cfg::Q_BYTES);
#pragma unroll
          for (int cb = 0; cb < Cfg::NBOX; ++cb) {
            const int off = st * Cfg::Q_BYTES + cb * BQ * 128;
            tma_load_4d(base + Cfg::OFF_Q + off, &qmap, bar.full_k + st,
                        cb * 64, it.h, q0, it.b);
            tma_load_4d(base + Cfg::OFF_DO + off, &dmap, bar.full_v + st,
                        cb * 64, it.h, q0, it.b);
          }
        }
      }
    } else if (warp == 1) {  // lse · log2 e, delta · sm_scale per tile
      int g = 0;
      for (int k = 0;; ++k) {
        const int item = attn_item(k);
        if (item >= n_items) break;
        const DkvItem it = dkv_item(item, n_qt, H, B, causal);
        for (int i = 0; i < it.n_walk; ++i, ++g) {
          const int st = g % Cfg::ST;
          const int q0 = (it.first_qt + i) * BQ;
          float* rl = reinterpret_cast<float*>(base + Cfg::OFF_ROW) +
                      st * 2 * BQ;
          mbar_wait(bar.empty + st, ((g / Cfg::ST) & 1) ^ 1);
          for (int r = lane; r < BQ; r += 32) {
            const int row = q0 + r;
            const long long at = ((long long)it.b * S + row) * H + it.h;
            rl[r] = row < S ? lse[at] * LOG2E : 0.f;
            rl[BQ + r] = row < S ? delta[at] * scale : 0.f;
          }
          mbar_arrive(bar.full_k + st);
        }
      }
    }
  } else {
    regs_inc<ATT_CONSUMER_REGS>();
    const int wg = threadIdx.x / WG_THREADS - 1;
    const int lane = threadIdx.x & 31;
    int g = 0, jk = 0;
    for (int k = 0;; ++k) {
      const int item = attn_item(k);
      if (item >= n_items) break;
      const DkvItem it = dkv_item(item, n_qt, H, B, causal);
      const int kw = it.key0 + wg * 64;  // the warpgroup's first key
      float ak[KD / 2], av[KD / 2];
#pragma unroll
      for (int i = 0; i < KD / 2; ++i) ak[i] = av[i] = 0.f;
      if (it.n_walk > 0) {  // no query row sees these keys: dk = dv = 0
        const int kb = jk & 1;
        mbar_wait(bar.full_a + kb, (jk >> 1) & 1);
        dkv_mainloop<KD>(base, kb, bar, wg, g, it, kw, S, causal, c, scale,
                         ak, av);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar.a_empty + kb);
        ++jk;
        g += it.n_walk;
      }
      store_acc<KD>(ak, dk + it.b * kst.b + kw * kst.s + it.h * kst.h, kst.s,
                    T - kw);
      store_acc<KD>(av, dv + it.b * vst.b + kw * vst.s + it.h * vst.h, vst.s,
                    T - kw);
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
                      int causal, float sm_scale, const long long* maps,
                      cudaStream_t stream) {
  if (dtype == DTYPE_BF16) {
    constexpr int BN = DqCfg<KD>::BN;
    const int rows[4] = {ATT_BM, BN, BN, ATT_BM};  // q, k, v, dO
    if (maps == nullptr || !tile_boxes_are(maps, rows, 4))
      return cudaErrorInvalidValue;
    CUtensorMap qm, km, vm, dm;
    cudaError_t e = encode_tmap(&qm, q, maps);
    if (e == cudaSuccess) e = encode_tmap(&dm, dout, maps + 3 * TMAP_WORDS);
    // T = 0: no key tile is ever loaded, and no map of k or v is encoded.
    if (e == cudaSuccess && T > 0) e = encode_tmap(&km, k, maps + TMAP_WORDS);
    if (e == cudaSuccess && T > 0)
      e = encode_tmap(&vm, v, maps + 2 * TMAP_WORDS);
    if (e != cudaSuccess) return e;
    if (T == 0) km = vm = qm;
    const int smem = DqCfg<KD>::SMEM;
    e = allow_smem(flash_dq_wgmma_kernel<KD>, smem);
    int grid = 0;
    if (e == cudaSuccess)
      e = attn_grid((S + ATT_BM - 1) / ATT_BM * H * B, &grid);
    if (e != cudaSuccess) return e;
    flash_dq_wgmma_kernel<KD><<<grid, ATT_THREADS, smem, stream>>>(
        qm, km, vm, dm, lse, delta, static_cast<__nv_bfloat16*>(dq), B, S, T,
        H, st.dq, causal, sm_scale * LOG2E, sm_scale);
    return cudaGetLastError();
  }
  if (dtype != DTYPE_F32) return cudaErrorInvalidValue;
  const dim3 grid((S + FL_TILE - 1) / FL_TILE, H, B);
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
                       const long long* maps, cudaStream_t stream) {
  if (dtype == DTYPE_BF16) {
    const int rows[4] = {DKV_ROWS, DKV_KEYS, DKV_KEYS, DKV_ROWS};
    if (maps == nullptr || !tile_boxes_are(maps, rows, 4))
      return cudaErrorInvalidValue;
    CUtensorMap qm, km, vm, dm;
    cudaError_t e = encode_tmap(&km, k, maps + TMAP_WORDS);
    if (e == cudaSuccess) e = encode_tmap(&vm, v, maps + 2 * TMAP_WORDS);
    // S = 0: no query tile is ever loaded, and no map of q or dO is encoded.
    if (e == cudaSuccess && S > 0) e = encode_tmap(&qm, q, maps);
    if (e == cudaSuccess && S > 0)
      e = encode_tmap(&dm, dout, maps + 3 * TMAP_WORDS);
    if (e != cudaSuccess) return e;
    if (S == 0) qm = dm = km;
    const int smem = DkvCfg<KD>::SMEM;
    e = allow_smem(flash_dkv_wgmma_kernel<KD>, smem);
    int grid = 0;
    if (e == cudaSuccess)
      e = attn_grid((T + DKV_KEYS - 1) / DKV_KEYS * H * B, &grid);
    if (e != cudaSuccess) return e;
    flash_dkv_wgmma_kernel<KD><<<grid, ATT_THREADS, smem, stream>>>(
        qm, km, vm, dm, lse, delta, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), B, S, T, H, st.dk, st.dv, causal,
        sm_scale * LOG2E, sm_scale);
    return cudaGetLastError();
  }
  if (dtype != DTYPE_F32) return cudaErrorInvalidValue;
  const dim3 grid((T + FL_TILE - 1) / FL_TILE, H, B);
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
// maps: bf16, the tensor maps of q, k, v and dO (4 x TMAP_WORDS numbers
// from ops/attention.py `flash_dq_plan`); NULL for fp32.
extern "C" int rtt_flash_dq(int dtype, const void* q, const void* k,
                            const void* v, const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int S, int T,
                            int H, int K, const long long* strides, int causal,
                            float sm_scale, const long long* maps,
                            void* stream) {
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
                                     H, st, causal, sm_scale, maps, s);
    case 128:
      return (int)rtt::launch_dq<128>(dtype, q, k, v, dout, l, d, dq, B, S, T,
                                      H, st, causal, sm_scale, maps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// strides: 18 element strides, (b, s, h) of q, k, v, dO, dk and dv in order.
// maps: bf16, the tensor maps of q, k, v and dO (4 x TMAP_WORDS numbers
// from ops/attention.py `flash_dkv_plan`); NULL for fp32.
extern "C" int rtt_flash_dkv(int dtype, const void* q, const void* k,
                             const void* v, const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int S, int T, int H, int K,
                             const long long* strides, int causal,
                             float sm_scale, const long long* maps,
                             void* stream) {
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
                                      S, T, H, st, causal, sm_scale, maps, s);
    case 128:
      return (int)rtt::launch_dkv<128>(dtype, q, k, v, dout, l, d, dk, dv, B,
                                       S, T, H, st, causal, sm_scale, maps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
