// The attention mainloop on wgmma shared by the bf16 flash forward
// (flash_fwd.cu) and the bf16-q paged prefill (paged_prefill.cu, float and
// int8 pools): a work item is 128 query rows of one (head, batch); a
// producer warp brings Q and the item's K and V tiles into shared memory by
// TMA, and two consumer warpgroups of 64 rows each walk the key tiles under
// an online softmax. The two kernels differ only in their producers: where
// a key tile comes from (a [B, T, H, K] tensor, or pages of a pool through
// a page table). The bf16 flash backward (flash_bwd.cu) takes its work-item
// order, persistent grid, warp roles and register budgets.
//
// Blocks are persistent: one per SM, each taking work items in a snake
// order over the longest-first list (`attn_item`), so the producer loads
// the next item's Q and first tiles while the consumers finish the current
// one and store it. The K/V ring and its phases run on across items (a
// block-wide tile counter g); Q is double-buffered.
//
// Block layout: warpgroup 0 is the producer (its registers given away by
// setmaxnreg), warpgroups 1 and 2 the consumers (rows 0-63 and 64-127).
// Shared memory, from a 1024-byte boundary (`AttnCfg` offsets):
//   Q       [2 buffers][KD / 64 column boxes][128 rows][128 B], 128-byte
//           swizzle
//   K, V    [KV_ST stages][KD / 64][BN keys][128 B] each, the same swizzle
//   int8 only: the staged codes [STG_ST stages][K, V][BN][KD] (plain), each
//   key's K scale · sm_scale · log2 e and V scale [KV_ST][2][BN] (fp32),
//   the page id of each TMA box [STG_ST][BN]
//   mbarriers.
// The ring is deep (four bf16 stages; for int8 four stages of codes, half
// the bytes each, ahead of two bf16 stages) so that enough bytes are in
// flight for the memory's latency: one block runs per SM.
// Per item buffer (Q here; the flash backward's: Q and dO, or K and V):
// full_a (TMA bytes) and a_empty (every consumer warp is done with the
// item). Per bf16 stage: full_k / full_v (the tile has
// landed: TMA bytes for bf16; for int8 the widening warps' arrivals, on
// full_k alone) and empty (every consumer warp is done with it); per
// staging stage (int8): stg_full / stg_empty around the codes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "flash.cuh"
#include "hopper.cuh"

namespace rtt {

constexpr int ATT_BM = 128;                  // query rows per block
constexpr int ATT_THREADS = 3 * WG_THREADS;  // producer + two consumers
constexpr int ATT_PRODUCER_REGS = 40;
constexpr int ATT_CONSUMER_REGS = 232;       // 128·40 + 256·232 <= 64 K
constexpr int ATT_WIDEN_THREADS = 96;        // int8: warps 1-3 of warpgroup 0
constexpr int ATT_CONSUMER_WARPS = 8;
constexpr int ATT_NO_CAUSAL = 1 << 30;       // a row position past every key
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int KD, bool QUANT>
struct AttnCfg {
  static_assert(KD == 64 || KD == 128, "head dim 64 or 128");
  static constexpr int BN = KD == 64 ? 128 : 64;  // keys per tile
  static constexpr int NBOX = KD / 64;            // 64-column boxes per row
  static constexpr int KV_ST = QUANT ? 2 : 4;     // bf16 K/V stages
  static constexpr int STG_ST = QUANT ? 4 : 0;    // int8 code stages
  static constexpr int Q_BYTES = ATT_BM * KD * 2;
  static constexpr int KV_BYTES = BN * KD * 2;    // one bf16 K or V tile
  static constexpr int STG_BYTES = BN * KD;       // one int8 K or V tile
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_K = OFF_Q + 2 * Q_BYTES;
  static constexpr int OFF_V = OFF_K + KV_ST * KV_BYTES;
  static constexpr int OFF_STG = OFF_V + KV_ST * KV_BYTES;
  static constexpr int OFF_SC = OFF_STG + STG_ST * 2 * STG_BYTES;
  static constexpr int OFF_PID = OFF_SC + (QUANT ? KV_ST * 2 * BN * 4 : 0);
  static constexpr int OFF_BAR = OFF_PID + STG_ST * BN * 4;
  static constexpr int N_BAR = 4 + 3 * KV_ST + 2 * STG_ST;
  // + 1024: room to align the dynamic shared memory's base.
  static constexpr int SMEM = OFF_BAR + 8 * N_BAR + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

struct AttnBars {
  uint64_t *full_a, *a_empty, *full_k, *full_v, *empty, *stg_full,
      *stg_empty;
};

// The block's k-th work item: rounds of gridDim.x items, taken left to
// right in even rounds and right to left in odd ones, so that over a
// longest-first list every block's total stays near the mean. >= the
// number of items: the block is done.
__device__ __forceinline__ int attn_item(int k) {
  return k * gridDim.x +
         ((k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// The persistent grid: one block per SM, at most one per work item.
inline cudaError_t attn_grid(int n_items, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = n_items < sms ? n_items : sms;
  return e;
}

// Work item `item` of a query-major grid (the flash forward, flash dq),
// longest first when causal: query tile, head and batch, its rows and its
// key tiles of BN keys.
struct QueryItem {
  int q0, rows, h, b, n_kt;
};

template <int BN>
__device__ __forceinline__ QueryItem query_item(int item, int n_qt, int S,
                                                int T, int H, int B,
                                                int causal) {
  QueryItem it;
  const int rank = item / (H * B);
  const int hb = item - rank * (H * B);
  it.h = hb % H;
  it.b = hb / H;
  it.q0 = (causal ? n_qt - 1 - rank : rank) * ATT_BM;
  it.rows = min(ATT_BM, S - it.q0);
  // One past the last key any row of this tile may see.
  const int kv_end = causal ? min(T, it.q0 + it.rows) : T;
  it.n_kt = (kv_end + BN - 1) / BN;
  return it;
}

// Shared-memory address of Q buffer `qb` (the consumers' A operand).
template <int KD, bool QUANT>
__device__ __forceinline__ unsigned char* attn_q(unsigned char* base,
                                                 int qb) {
  return base + AttnCfg<KD, QUANT>::OFF_Q + qb * AttnCfg<KD, QUANT>::Q_BYTES;
}

// Whether the 4-D tensor maps `maps` (TMAP_WORDS numbers each, planned by
// ops/attention.py `_maps`) box `rows[m]` rows of 64 columns for map m of
// n: the kernel's expect_tx byte counts and shared-memory offsets assume
// its own tile sizes, so a plan that disagrees is refused at launch, not
// found on the card as a trap or wrong tiles.
inline bool tile_boxes_are(const long long* maps, const int* rows, int n) {
  for (int m = 0; m < n; ++m) {
    const long long* box = maps + m * TMAP_WORDS + 11;  // innermost first
    if (box[0] != 64 || box[1] != 1 || box[2] != rows[m] || box[3] != 1)
      return false;
  }
  return true;
}

// The block's 1024-aligned shared base and its barriers (at byte offset
// off_bar: two item buffers, KV_ST ring stages whose full_k takes
// full_k_count arrivals, STG_ST int8 staging stages); thread 0 initialises
// them, and every thread returns after the block barrier. The flash
// backward takes the same protocol without staging stages.
template <int KV_ST, int STG_ST = 0>
__device__ __forceinline__ unsigned char* attn_setup(unsigned char* raw,
                                                     int off_bar,
                                                     int full_k_count,
                                                     AttnBars& bar) {
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint64_t* b = reinterpret_cast<uint64_t*>(base + off_bar);
  bar.full_a = b;
  bar.a_empty = b + 2;
  bar.full_k = b + 4;
  bar.full_v = bar.full_k + KV_ST;
  bar.empty = bar.full_v + KV_ST;
  bar.stg_full = bar.empty + KV_ST;
  bar.stg_empty = bar.stg_full + STG_ST;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar.full_a + s, 1);
      mbar_init(bar.a_empty + s, ATT_CONSUMER_WARPS);
    }
    for (int s = 0; s < KV_ST; ++s) {
      mbar_init(bar.full_k + s, full_k_count);
      mbar_init(bar.full_v + s, 1);
      mbar_init(bar.empty + s, ATT_CONSUMER_WARPS);
    }
    for (int s = 0; s < STG_ST; ++s) {
      mbar_init(bar.stg_full + s, 1);
      mbar_init(bar.stg_empty + s, ATT_WIDEN_THREADS / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();
  return base;
}

// Sixteen int8 codes as sixteen bf16 values (exact): lo holds codes 0-7,
// hi codes 8-15. A code c becomes the fp32 2^23 + (c + 128) by a byte
// permute, minus 2^23 + 128.
__device__ __forceinline__ void widen_i8x16(uint4 v, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u,
                         v.z ^ 0x80808080u, v.w ^ 0x80808080u};
  uint32_t b[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[k] = __uint_as_float(__byte_perm(w[i], 0x4Bu, 0x4550 + k)) -
             8388736.f;
    b[2 * i] = pack_bf16x2(f[0], f[1]);
    b[2 * i + 1] = pack_bf16x2(f[2], f[3]);
  }
  lo = make_uint4(b[0], b[1], b[2], b[3]);
  hi = make_uint4(b[4], b[5], b[6], b[7]);
}

// int8 programs, warps 1-3 of the producer warpgroup: for each of an
// item's n_kt key tiles (the block's tiles g0, g0 + 1, ...), widen the
// staged codes into the stage's swizzled bf16 K and V tiles and write each
// key's scales (read by the page id the producer recorded per TMA box),
// then release the staging buffer and mark the stage full.
template <int KD>
__device__ __forceinline__ void attn_widen(unsigned char* base,
                                           const AttnBars& bar, int g0,
                                           int n_kt, int box_rows,
                                           const __nv_bfloat16* k_scale,
                                           const __nv_bfloat16* v_scale,
                                           float c) {
  using Cfg = AttnCfg<KD, true>;
  constexpr int BN = Cfg::BN;
  constexpr int CH = KD / 16;  // 16-code chunks per row
  const int wt = threadIdx.x - 32;
  const int lane = threadIdx.x & 31;
  for (int g = g0; g < g0 + n_kt; ++g) {
    const int sg = g % Cfg::STG_ST;
    const int st = g % Cfg::KV_ST;
    mbar_wait(bar.stg_full + sg, (g / Cfg::STG_ST) & 1);
    mbar_wait(bar.empty + st, ((g / Cfg::KV_ST) & 1) ^ 1);
    const unsigned char* sk = base + Cfg::OFF_STG + sg * 2 * Cfg::STG_BYTES;
    const unsigned char* sv = sk + Cfg::STG_BYTES;
    unsigned char* dk = base + Cfg::OFF_K + st * Cfg::KV_BYTES;
    unsigned char* dv = base + Cfg::OFF_V + st * Cfg::KV_BYTES;
    for (int i = wt; i < BN * CH; i += ATT_WIDEN_THREADS) {
      const int r = i / CH;
      const int col = (i - r * CH) * 16;
      const int ch = (col & 63) >> 3;  // first 16-byte bf16 chunk in the box
      const int row = (col >> 6) * BN * 128 + r * 128;
      const int o0 = row + ((ch ^ (r & 7)) << 4);
      const int o1 = row + (((ch + 1) ^ (r & 7)) << 4);
      uint4 lo, hi;
      widen_i8x16(*reinterpret_cast<const uint4*>(sk + r * KD + col), lo, hi);
      *reinterpret_cast<uint4*>(dk + o0) = lo;
      *reinterpret_cast<uint4*>(dk + o1) = hi;
      widen_i8x16(*reinterpret_cast<const uint4*>(sv + r * KD + col), lo, hi);
      *reinterpret_cast<uint4*>(dv + o0) = lo;
      *reinterpret_cast<uint4*>(dv + o1) = hi;
    }
    const int* pid = reinterpret_cast<const int*>(base + Cfg::OFF_PID) + sg * BN;
    float* ksc = reinterpret_cast<float*>(base + Cfg::OFF_SC) + st * 2 * BN;
    for (int r = wt; r < BN; r += ATT_WIDEN_THREADS) {
      const int page = pid[r / box_rows];
      ksc[r] = __bfloat162float(k_scale[page]) * c;
      ksc[BN + r] = __bfloat162float(v_scale[page]);
    }
    fence_async_smem();  // the bf16 tiles are read by wgmma
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(bar.stg_empty + sg);
      mbar_arrive(bar.full_k + st);
    }
  }
}

// One consumer warpgroup's walk over an item's n_kt key tiles (the block's
// tiles g0, g0 + 1, ...), Q at `q` (its Q buffer has landed): O, the
// running maximum m2 (log2 domain, scores times c = sm_scale · log2 e) and
// this thread's share of l (summed over its 4 lanes in attn_store). Row r
// (warpgroup-local) sees key k when k < kv_lim and k <= qpos0 + r; the
// mask runs only on tiles that reach past either edge, and a tile whose
// keys all follow every row is skipped (after its barrier, so that every
// stage's phases stay in step). p = exp2(s·c - m2) is rounded to bf16 as
// P·V's A fragments, and l sums it unrounded. int8: each score times its
// key's K scale (· sm_scale · log2 e: c is 1), and p · vs split into bf16
// hi + lo, two products into O, so p keeps about 16 bits.
template <int KD, bool QUANT>
__device__ __forceinline__ void attn_mainloop(unsigned char* base,
                                              const unsigned char* q,
                                              const AttnBars& bar, int wg,
                                              int g0, int n_kt, int kv_lim,
                                              int qpos0, float c,
                                              float (&o)[KD / 2],
                                              float (&m2)[2], float (&l)[2]) {
  using Cfg = AttnCfg<KD, QUANT>;
  constexpr int BN = Cfg::BN;
  constexpr int NS = BN / 2;  // S accumulator floats per thread
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);  // rows r0 and r0 + 8
  const int t2 = 2 * (lane & 3);
  const uint32_t q_addr = smem_u32(q) + wg * 64 * 128;
#pragma unroll
  for (int i = 0; i < KD / 2; ++i) o[i] = 0.f;
  m2[0] = m2[1] = NEG_INF;
  l[0] = l[1] = 0.f;
  // Each row's last visible key, minus the tile's first key: a key at
  // column j of the tile is visible to row r0 (r0 + 8) iff j <= lim.
  const int lim_base0 = min(kv_lim - 1, qpos0 + r0);
  const int lim_base1 = min(kv_lim - 1, qpos0 + r0 + 8);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = (g0 + kt) % Cfg::KV_ST;
    const uint32_t ph = ((g0 + kt) / Cfg::KV_ST) & 1;
    const int key0 = kt * BN;
    const uint32_t k_addr = smem_u32(base + Cfg::OFF_K + st * Cfg::KV_BYTES);
    const uint32_t v_addr = smem_u32(base + Cfg::OFF_V + st * Cfg::KV_BYTES);
    mbar_wait(bar.full_k + st, ph);
    if (!QUANT) mbar_wait(bar.full_v + st, ph);
    if (key0 <= qpos0 + 63) {
      // S = Q · K^T.
      float s[NS];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KD / 16; ++ks)
        wgmma_ss(s,
                 sw128_desc(q_addr + (ks >> 2) * ATT_BM * 128 + (ks & 3) * 32,
                            16, 1024),
                 sw128_desc(k_addr + (ks >> 2) * BN * 128 + (ks & 3) * 32, 16,
                            1024),
                 ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      const float* ksc =
          reinterpret_cast<const float*>(base + Cfg::OFF_SC) + st * 2 * BN;
      if constexpr (QUANT) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 sc = *reinterpret_cast<const float2*>(ksc + 8 * j + t2);
          s[4 * j] *= sc.x;
          s[4 * j + 1] *= sc.y;
          s[4 * j + 2] *= sc.x;
          s[4 * j + 3] *= sc.y;
        }
      }
      if (key0 + BN > kv_lim || key0 + BN - 1 > qpos0) {
        const int lim0 = lim_base0 - key0;
        const int lim1 = lim_base1 - key0;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + t2 + e;
            if (col > lim0) s[4 * j + e] = -INFINITY;
            if (col > lim1) s[4 * j + 2 + e] = -INFINITY;
          }
        }
      }

      // Online softmax of rows r0 and r0 + 8; a row's four lanes (same
      // lane / 4) hold its BN scores between them. Four partial maxima and
      // sums per row keep the dependent chains short.
      float mx[2][4], sm[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mx[h][i] = -INFINITY;
          sm[h][i] = 0.f;
        }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mx[h][j & 3] =
              fmaxf(mx[h][j & 3], fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      float mn[2], corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        mn[h] = fmaxf(m2[h], m * c);
        corr[h] = exp2_sfu(m2[h] - mn[h]);
        m2[h] = mn[h];
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[4 * j + 2 * h] = exp2_sfu(fmaf(s[4 * j + 2 * h], c, -mn[h]));
          s[4 * j + 2 * h + 1] =
              exp2_sfu(fmaf(s[4 * j + 2 * h + 1], c, -mn[h]));
          sm[h][j & 3] += s[4 * j + 2 * h] + s[4 * j + 2 * h + 1];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l[h] = l[h] * corr[h] +
               ((sm[h][0] + sm[h][1]) + (sm[h][2] + sm[h][3]));
#pragma unroll
      for (int j = 0; j < KD / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }

      // P as A fragments: k-step kk covers keys 16kk .. 16kk + 15, the S
      // columns of j = 2kk (a[0], a[1]) and 2kk + 1 (a[2], a[3]). int8:
      // lo = w - hi from hi's own bits (a bf16 is the top half of an fp32).
      uint32_t pa[BN / 16][4];
      uint32_t pl[QUANT ? BN / 16 : 1][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float w0 = s[8 * kk + 2 * q];
          float w1 = s[8 * kk + 2 * q + 1];
          if constexpr (QUANT) {
            // keys 16kk + 8 (q >> 1) + t2 and + 1
            const float2 vs = *reinterpret_cast<const float2*>(
                ksc + BN + 16 * kk + 8 * (q >> 1) + t2);
            w0 *= vs.x;
            w1 *= vs.y;
          }
          pa[kk][q] = pack_bf16x2(w0, w1);
          if constexpr (QUANT)
            pl[kk][q] =
                pack_bf16x2(w0 - __uint_as_float(pa[kk][q] << 16),
                            w1 - __uint_as_float(pa[kk][q] & 0xffff0000u));
        }
      }

      // O += P · V (V MN-major: the second 64-column box, KD = 128, is
      // BN rows on).
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dv = sw128_desc(v_addr + kk * 16 * 128, BN * 128, 1024);
        wgmma_rs(o, pa[kk], dv, 1);
        if constexpr (QUANT) wgmma_rs(o, pl[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar.empty + st);
  }
}

// O / l of this thread's rows in bf16 at `ob` (the warpgroup's row 0, rows
// `row_stride` elements apart); l == 0 (no visible key) writes zeros, rows
// at or past `rows` nothing. With `lse`, also each row's natural-log
// log-sum-exp (m2 + log2 l) · ln 2, -1e30 for l == 0, rows `lse_stride`
// apart.
template <int KD>
__device__ __forceinline__ void attn_store(const float (&o)[KD / 2],
                                           const float (&m2)[2],
                                           const float (&l)[2],
                                           __nv_bfloat16* ob,
                                           long long row_stride, int rows,
                                           float* lse, long long lse_stride) {
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int t2 = 2 * (lane & 3);
  float lt[2] = {l[0], l[1]};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lt[h] += __shfl_xor_sync(0xffffffffu, lt[h], 1);
    lt[h] += __shfl_xor_sync(0xffffffffu, lt[h], 2);
  }
  const float inv0 = 1.f / (lt[0] == 0.f ? 1.f : lt[0]);
  const float inv1 = 1.f / (lt[1] == 0.f ? 1.f : lt[1]);
#pragma unroll
  for (int j = 0; j < KD / 8; ++j) {
    const int col = 8 * j + t2;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(ob + r0 * row_stride + col) =
          pack_bf16x2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r0 + 8 < rows)
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * row_stride + col) =
          pack_bf16x2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  if (lse != nullptr && (lane & 3) == 0) {
    if (r0 < rows)
      lse[r0 * lse_stride] =
          lt[0] == 0.f ? NEG_INF : (m2[0] + log2f(lt[0])) * LN2;
    if (r0 + 8 < rows)
      lse[(r0 + 8) * lse_stride] =
          lt[1] == 0.f ? NEG_INF : (m2[1] + log2f(lt[1])) * LN2;
  }
}

}  // namespace rtt
