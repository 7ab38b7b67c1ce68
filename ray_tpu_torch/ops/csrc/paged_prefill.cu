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
// What the design does about it. Every version stops at the last key a
// query tile can see, min(lengths[b], offsets[b] + last row + 1): the causal
// early exit, and no work at all for an inert row (lengths[b] == 0).
//  - bf16 q, K in {64, 80, 128, 256}, every page size (the serving path;
//    `prefill_kernel` in ops/paged_attention.py holds the same rule): the
//    wgmma kernel of attn_wgmma.cuh, the flash forward's mainloop with a
//    paged producer. Persistent blocks, one per SM, take (128-row query
//    tile, head, slot) items, a slot's query tiles next to each other so
//    the second read of its pages comes from L2. The producer brings each
//    key tile (BN = 128 keys at head dim 64, else 64) into a four-stage ring
//    (two at 256, `AttnCfg`) in the layout the consumers' wgmma descriptors
//    read (128-byte swizzle, 64-column boxes); the two consumer warpgroups
//    run S = Q·K^T and O += P·V as wgmma, masking only the tiles that reach
//    past a row's diagonal or the slot's length. How a tile comes in
//    depends on the page size (`prefill_box_rows`):
//     - ps a multiple of 8: one thread reads each page piece's id from the
//       table once and loads it by TMA from a 3-D tensor map over the
//       layer's pool viewed as [(P+1)·ps, H, K], in boxes of gcd(ps, BN)
//       rows (8 at ps 24, 16 at 48, 32 at 96): up to BN / 8 pieces a tile,
//       each 1-4 column boxes of K and of V. Sharing the pieces out over
//       the producer warp's lanes made ps 48 faster (1.34x at head dim
//       64) and ps 64 slower (up to 4% at head dim 80) in every form
//       tried, so one thread issues them. The box
//       divides both ps and BN, so no box crosses a page, and it is whole
//       8-row swizzle atoms, so every box starts on a 1024-byte boundary
//       of the tile.
//     - any other ps (4, 12, 20, 100, ...): a page piece is not whole
//       8-row swizzle atoms. The producer gathers
//       (`gather_tile`): the four warps of the producer warpgroup (the
//       first alone for int8, where warps 1-3 widen) write each key's pool
//       row into a table in shared memory, then copy every row's 16-byte
//       chunks with cp.async into the swizzled offsets TMA would have used
//       (chunk c of row r at (c % 8) ^ (r % 8)), zero-filling keys past the
//       tile's reach, and cp.async.mbarrier.arrive.noinc signals the
//       stage's full barriers as each thread's copies land. cp.async writes
//       through the generic proxy, so the consumers fence to the async
//       proxy before their wgmma reads the tile. It replaces an mma.sync
//       kernel (64-key tiles staged through registers, four warps) that
//       lost to SDPA at these page sizes. The other candidate, TMA boxes
//       of gcd(ps, BN) rows (1, 2 or 4) at 128- to 512-byte offsets of
//       the tile, came out right on the card (TMA swizzles by the shared
//       address), but slower than the gatherer at ps 20 (1.6x at head dim
//       256, 2.6x at 64; `tools/prefill_box_probe.py`): 32 to 128 TMA
//       issues a tile.
//  - fp32 (K in {64, 80, 128, 256}): plain FMAs from shared memory (one
//    float of padding per row keeps the QK^T loop free of bank conflicts),
//    so fp32 keeps full precision (1e-5).
//
// The int8 programs (replace the same Pallas kernel traced with
// quantized=True): int8 pages with one K and one V scale per page, read from
// the layer's bf16 scale vectors by the page id tables[b, pos / ps], never by
// table position. The Pallas program dequantizes each page to fp32, so both
// its products run in fp32 and p is not rounded to q's dtype; the CUDA
// programs compute the same thing:
//  - fp32 q: the FMA kernel with the page dequantized (code · scale, exact
//    in fp32) as it is staged in shared memory, p unrounded.
//  - bf16 q: the same kernel as the float program on an int8 pool. TMA (or
//    the gathering warp, in plain rows) brings the page codes into a
//    four-stage staging ring (half the bytes of bf16), and warps 1-3 of the
//    producer warpgroup widen them to bf16 (|code| <= 127 is exact) into
//    the swizzled operand tiles of a two-stage ring and write each key's
//    scales beside them. The scale is one scalar per page, so it factors
//    out of each key's dot product: S = Q · codes^T on the tensor cores,
//    then each score times its key's K scale (exact up to fp32
//    reassociation). For P · V each fp32 p is multiplied by its key's V
//    scale and split into two bf16 terms, p = hi + lo, run as two
//    register-A wgmma products into one fp32 accumulator: the product keeps
//    about 16 bits of p (relative error <= 2^-16), where one bf16 term would
//    round p to 8 bits as the gather reference does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "attn_wgmma.cuh"
#include "common.cuh"
#include "flash.cuh"

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

// TP: the pool's element type, T (the float program) or int8_t (the int8
// program: k_scale / v_scale are read, the staged page is dequantized and p
// is not rounded).
template <typename T, typename TP, int KD>
__global__ void __launch_bounds__(PF_THREADS)
    paged_prefill_kernel(const T* __restrict__ q,
                         const TP* __restrict__ k_pool,
                         const TP* __restrict__ v_pool,
                         const __nv_bfloat16* __restrict__ k_scale,
                         const __nv_bfloat16* __restrict__ v_scale,
                         const int* __restrict__ tables,
                         const int* __restrict__ offsets,
                         const int* __restrict__ lengths, T* __restrict__ out,
                         int C, int H, int ps, int n_pg, float sm_scale) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  static_assert(PF_THREADS == FL_F32_THREADS && PF_TQ == FL_TILE,
                "the flash fp32 kernels' row groups (flash.cuh)");
  constexpr int KP = KD + 1;
  constexpr int ROW_GROUPS = FL_RG<KD>;  // 3 at head dim 80 (16 idle lanes)
  constexpr int RPT = FL_RPT<KD>;        // accumulator rows per thread

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
  const int rgrp = tid / KD;   // PV: rows rgrp, rgrp + ROW_GROUPS, ... (when
                               // fl_pv_row)
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int j = 0; j < n_live; ++j) {
    const size_t page = (size_t)tables[(size_t)b * n_pg + j];
    const TP* kp = k_pool + page * page_stride + (size_t)h * KD;
    const TP* vp = v_pool + page * page_stride + (size_t)h * KD;
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {
      ksc = to_f(k_scale[page]);
      vsc = to_f(v_scale[page]);
    }
    for (int i = tid; i < ps * KD; i += PF_THREADS) {
      const int t = i / KD, k = i % KD;
      if constexpr (kQuant) {  // dequantized as staged: code · scale, exact
        k_s[t * KP + k] = to_f(kp[(size_t)t * row_stride + k]) * ksc;
        v_s[t * KD + k] = to_f(vp[(size_t)t * row_stride + k]) * vsc;
      } else {
        k_s[t * KP + k] = to_f(kp[(size_t)t * row_stride + k]);
        v_s[t * KD + k] = to_f(vp[(size_t)t * row_stride + k]);
      }
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
        s_s[r * SP + t] = kQuant ? p : round_to<T>(p);
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
      if (!fl_pv_row<KD>(rgrp, r)) continue;
      float a = 0.f;
      for (int t = 0; t < ps; ++t) a += s_s[r * SP + t] * v_s[t * KD + kcol];
      acc[i] = acc[i] * c_s[r] + a;
    }
    __syncthreads();  // k_s / v_s / s_s are rewritten by the next page
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rgrp + i * ROW_GROUPS;
    if (fl_pv_row<KD>(rgrp, r) && r < rows) {
      const float l = l_s[r];
      const float l_safe = (l == 0.f) ? 1.f : l;
      out[(((size_t)b * C + q0 + r) * H + h) * KD + kcol] =
          from_f<T>(acc[i] / l_safe);
    }
  }
}

// ---------------------------------------------------------------------------
// FMA version (fp32; float and int8 pools).

template <typename T, typename TP, int KD>
cudaError_t launch_prefill_kd(const void* q, const void* k_pool,
                              const void* v_pool, const void* k_scale,
                              const void* v_scale, const int* tables,
                              const int* offsets, const int* lengths,
                              void* out, int B, int C, int H, int ps,
                              int n_pg, float sm_scale, cudaStream_t stream) {
  const size_t smem = prefill_smem_floats(KD, ps) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<T, TP, KD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((C + PF_TQ - 1) / PF_TQ, H, B);
  paged_prefill_kernel<T, TP, KD><<<grid, PF_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), tables, offsets, lengths,
      static_cast<T*>(out), C, H, ps, n_pg, sm_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 q on wgmma (attn_wgmma.cuh).

// Rows of one TMA box of the paged producer (`prefill_box_rows` in
// ops/paged_attention.py holds the same rule): gcd(ps, BN) where ps is a
// multiple of 8, so a box is whole 8-row swizzle atoms and starts on a
// 1024-byte boundary of its tile, and no box crosses a page; 0 at any
// other page size, where the producer gathers the key rows itself.
__host__ __device__ constexpr int prefill_box_rows(int ps, int bn) {
  if (ps < 1 || ps % 8) return 0;
  int a = ps, b = bn;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Threads that gather a key tile where the page size takes no TMA box: the
// producer warpgroup's four warps for the float program, its first warp for
// the int8 one (warps 1-3 widen).
template <bool QUANT>
constexpr int PF_GATHER_THREADS = QUANT ? 32 : WG_THREADS;

// The gathering threads' barrier: the warp, or named barrier 1 over the
// producer warpgroup.
template <int N>
__device__ __forceinline__ void gather_sync() {
  if constexpr (N == 32)
    __syncwarp();
  else
    asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// Work item `item` of the grid: a slot's query tiles next to each other
// (the longer first), so that the second read of the slot's pages comes
// from L2; its rows, offset, key limit and key tiles.
struct PrefillItem {
  int q0, rows, h, b, off, kv_lim, kv_end, n_kt;
};

template <int BN>
__device__ __forceinline__ PrefillItem prefill_item(
    int item, int n_qt, int C, int H, int ps, int n_pg,
    const int* __restrict__ offsets, const int* __restrict__ lengths) {
  PrefillItem it;
  const int hb = item / n_qt;
  it.q0 = (n_qt - 1 - (item - hb * n_qt)) * ATT_BM;
  it.h = hb % H;
  it.b = hb / H;
  it.rows = min(ATT_BM, C - it.q0);
  it.off = offsets[it.b];
  it.kv_lim = min(lengths[it.b], n_pg * ps);
  // One past the last position any row of this tile may attend.
  it.kv_end = min(it.kv_lim, it.off + it.q0 + it.rows);
  it.n_kt = it.kv_end > 0 ? (it.kv_end + BN - 1) / BN : 0;
  return it;
}

// The key tile at key0 of slot row `trow`, head h, gathered by the
// PF_GATHER_THREADS threads of the producer warpgroup: each key's pool row
// into the row table (-1 past the item's reach; int8: each key's page id
// into `pid` as well, the widening warps' scales), then every row's KD
// columns by 16-byte cp.async copies from the pool (rows `row_bytes`
// apart) into dk / dv, laid out as TMA lays out its boxes: the float
// program's swizzled 64-column boxes (chunk c of row r in box c / 8 at
// chunk (c % 8) ^ (r % 8)), the int8 program's plain rows of codes. Rows
// past the reach are zero-filled. Float: each thread's arrival on full_k
// once its K copies land, on full_v once its V copies do. int8 (full_k ==
// full_v, the staging stage's barrier): one arrival once its copies land,
// one now (its page ids written).
template <int KD, bool QUANT>
__device__ __forceinline__ void gather_tile(
    unsigned char* base, unsigned char* dk, unsigned char* dv,
    uint64_t* full_k, uint64_t* full_v, int* pid,
    const unsigned char* __restrict__ k_pool,
    const unsigned char* __restrict__ v_pool, const int* trow, int key0,
    int kv_end, int ps, int h, long long row_bytes, int g) {
  using Cfg = AttnCfg<KD, QUANT>;
  constexpr int BN = Cfg::BN;
  constexpr int GT = PF_GATHER_THREADS<QUANT>;
  constexpr int ES = QUANT ? 1 : 2;       // bytes of an element
  constexpr int CPR = KD * ES / 16;       // 16-byte chunks of a row
  const int t = threadIdx.x;
  int* rows = reinterpret_cast<int*>(base + Cfg::OFF_ROW) + (g & 1) * BN;
  for (int r = t; r < BN; r += GT) {
    const int pos = key0 + r;
    const int page = pos < kv_end ? trow[pos / ps] : 0;
    rows[r] = pos < kv_end ? page * ps + pos % ps : -1;
    if constexpr (QUANT) pid[r] = page;
  }
  gather_sync<GT>();  // the table is read across threads; two alternate
  const long long col0 = (long long)h * KD * ES;
#pragma unroll 1
  for (int side = 0; side < 2; ++side) {
    const unsigned char* pool = side ? v_pool : k_pool;
    unsigned char* dst = side ? dv : dk;
    for (int i = t; i < BN * CPR; i += GT) {
      const int r = i / CPR;
      const int c = i - r * CPR;
      const int row = rows[r];
      const int at =
          QUANT ? r * KD + c * 16
                : (c >> 3) * BN * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
      cp_async_16(dst + at,
                  pool + (row < 0 ? 0 : row * row_bytes + col0 + c * 16),
                  row >= 0);
    }
    if (!QUANT) cp_async_arrive(side ? full_v : full_k);
  }
  if constexpr (QUANT) {
    cp_async_arrive(full_k);
    mbar_arrive(full_k);
  }
}

// QUANT: the int8 program (k_scale / v_scale read by page id; the codes are
// staged and widened by warps 1-3 of the producer warpgroup). GATHER: the
// producer gathers rows (`gather_tile`; kmap and vmap are not read),
// otherwise it loads TMA boxes of box_rows rows. An instance of its own
// each, so that neither producer's registers crowd the other's under the
// producer warpgroup's budget. Persistent: one block per SM.
template <int KD, bool QUANT, bool GATHER>
__global__ void __launch_bounds__(ATT_THREADS, 1)
    paged_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const unsigned char* __restrict__ k_pool,
                               const unsigned char* __restrict__ v_pool,
                               const __nv_bfloat16* __restrict__ k_scale,
                               const __nv_bfloat16* __restrict__ v_scale,
                               const int* __restrict__ tables,
                               const int* __restrict__ offsets,
                               const int* __restrict__ lengths,
                               __nv_bfloat16* __restrict__ out, int B, int C,
                               int H, int ps, int n_pg, int box_rows,
                               float c) {
  using Cfg = AttnCfg<KD, QUANT>;
  constexpr int BN = Cfg::BN;
  constexpr int GT = PF_GATHER_THREADS<QUANT>;
  extern __shared__ unsigned char smem_raw[];
  const int n_qt = (C + ATT_BM - 1) / ATT_BM;
  const int n_items = n_qt * H * B;
  const long long row_stride = (long long)H * KD;
  AttnBars bar;
  // A tile's loads arrive once (TMA bytes) or once per gathering thread
  // (int8: twice, `gather_tile`); int8: the three widening warps arrive
  // once each on full_k.
  constexpr int loads = GATHER ? (QUANT ? 2 * GT : GT) : 1;
  unsigned char* base = attn_setup<Cfg::KV_ST, Cfg::STG_ST>(
      smem_raw, Cfg::OFF_BAR, QUANT ? ATT_WIDEN_THREADS / 32 : loads, bar,
      loads);

  if (threadIdx.x < WG_THREADS) {
    regs_dec<ATT_PRODUCER_REGS>();
    // The producer: thread 0 (Q, and the TMA boxes), or the GT threads
    // that gather (thread 0 among them loads Q).
    if (GATHER ? threadIdx.x < GT : threadIdx.x == 0) {
      const int n_box = GATHER ? 0 : BN / box_rows;
      int g = 0, jq = 0;
      for (int k = 0;; ++k) {
        const int item = attn_item(k);
        if (item >= n_items) break;
        const PrefillItem it = prefill_item<BN>(item, n_qt, C, H, ps, n_pg,
                                                offsets, lengths);
        if (it.n_kt == 0) continue;
        if (threadIdx.x == 0) {
          const int qb = qbuf<Cfg::Q_BUFS>(jq);
          mbar_wait(bar.a_empty + qb, qphase<Cfg::Q_BUFS>(jq) ^ 1);
          mbar_expect_tx(bar.full_a + qb, Cfg::Q_BYTES);
#pragma unroll
          for (int cb = 0; cb < Cfg::NBOX; ++cb)
            tma_load_4d(attn_q<KD, QUANT>(base, qb) + cb * ATT_BM * 128,
                        &qmap, bar.full_a + qb, cb * 64, it.h, it.q0, it.b);
        }
        ++jq;
        const int* trow = tables + (long long)it.b * n_pg;
        for (int kt = 0; kt < it.n_kt; ++kt, ++g) {
          const int key0 = kt * BN;
          if constexpr (QUANT) {
            const int sg = g % Cfg::STG_ST;
            mbar_wait(bar.stg_empty + sg, ((g / Cfg::STG_ST) & 1) ^ 1);
            int* pid = reinterpret_cast<int*>(base + Cfg::OFF_PID) + sg * BN;
            unsigned char* sk = base + Cfg::OFF_STG + sg * 2 * Cfg::STG_BYTES;
            if constexpr (GATHER) {
              gather_tile<KD, true>(base, sk, sk + Cfg::STG_BYTES,
                                    bar.stg_full + sg, bar.stg_full + sg,
                                    pid, k_pool, v_pool, trow, key0,
                                    it.kv_end, ps, it.h, row_stride, g);
            } else {
              // Each box's page id, for the widening warps' scales, before
              // the arrival that publishes it. A box past the tile's reach
              // reads the null page 0 (finite values that the mask hides).
              for (int i = 0; i < n_box; ++i) {
                const int pos = key0 + i * box_rows;
                pid[i] = pos < it.kv_end ? trow[pos / ps] : 0;
              }
              mbar_expect_tx(bar.stg_full + sg, 2 * Cfg::STG_BYTES);
              for (int i = 0; i < n_box; ++i) {
                const int pos = key0 + i * box_rows;
                const int row =
                    pid[i] * ps + (pos < it.kv_end ? pos % ps : 0);
                tma_load_3d(sk + i * box_rows * KD, &kmap, bar.stg_full + sg,
                            0, it.h, row);
                tma_load_3d(sk + Cfg::STG_BYTES + i * box_rows * KD, &vmap,
                            bar.stg_full + sg, 0, it.h, row);
              }
            }
          } else {
            const int st = g % Cfg::KV_ST;
            mbar_wait(bar.empty + st, ((g / Cfg::KV_ST) & 1) ^ 1);
            unsigned char* kd = base + Cfg::OFF_K + st * Cfg::KV_BYTES;
            unsigned char* vd = base + Cfg::OFF_V + st * Cfg::KV_BYTES;
            if constexpr (GATHER) {
              gather_tile<KD, false>(base, kd, vd, bar.full_k + st,
                                     bar.full_v + st, nullptr, k_pool, v_pool,
                                     trow, key0, it.kv_end, ps, it.h,
                                     row_stride * 2, g);
            } else {
              mbar_expect_tx(bar.full_k + st, Cfg::KV_BYTES);
              mbar_expect_tx(bar.full_v + st, Cfg::KV_BYTES);
              for (int i = 0; i < n_box; ++i) {
                const int pos = key0 + i * box_rows;
                const int row =
                    pos < it.kv_end ? trow[pos / ps] * ps + pos % ps : 0;
#pragma unroll
                for (int cb = 0; cb < Cfg::NBOX; ++cb) {
                  const int at = cb * BN * 128 + i * box_rows * 128;
                  tma_load_3d(kd + at, &kmap, bar.full_k + st, cb * 64, it.h,
                              row);
                  tma_load_3d(vd + at, &vmap, bar.full_v + st, cb * 64, it.h,
                              row);
                }
              }
            }
          }
        }
      }
    } else if (QUANT && threadIdx.x >= 32) {
      int g = 0;
      for (int k = 0;; ++k) {
        const int item = attn_item(k);
        if (item >= n_items) break;
        const PrefillItem it = prefill_item<BN>(item, n_qt, C, H, ps, n_pg,
                                                offsets, lengths);
        attn_widen<KD>(base, bar, g, it.n_kt, GATHER ? 1 : box_rows,
                       k_scale, v_scale, c);
        g += it.n_kt;
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
      const PrefillItem it = prefill_item<BN>(item, n_qt, C, H, ps, n_pg,
                                              offsets, lengths);
      float acc[KD / 2], m2[2], l[2];
      if (it.n_kt == 0) {  // an inert row: no key, the l == 0 guard's zeros
#pragma unroll
        for (int i = 0; i < KD / 2; ++i) acc[i] = 0.f;
        m2[0] = m2[1] = NEG_INF;
        l[0] = l[1] = 0.f;
      } else {
        const int qb = qbuf<Cfg::Q_BUFS>(jq);
        mbar_wait(bar.full_a + qb, qphase<Cfg::Q_BUFS>(jq));
        // int8: c is in each key's K scale, and the widening warps fence
        // their own writes.
        attn_mainloop<KD, QUANT>(base, attn_q<KD, QUANT>(base, qb), bar, wg,
                                 g, it.n_kt, it.kv_lim,
                                 it.off + it.q0 + wg * 64, QUANT ? 1.f : c,
                                 acc, m2, l, !QUANT && GATHER);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar.a_empty + qb);
        ++jq;
        g += it.n_kt;
      }
      attn_store<KD>(acc, m2, l,
                     out + ((long long)it.b * C + it.q0 + wg * 64) *
                               row_stride + it.h * KD,
                     row_stride, it.rows - wg * 64, nullptr, 0);
    }
  }
}

template <int KD, bool QUANT>
cudaError_t launch_prefill_wgmma(const void* q, const void* k_pool,
                                 const void* v_pool, const void* k_scale,
                                 const void* v_scale, const int* tables,
                                 const int* offsets, const int* lengths,
                                 void* out, int B, int C, int H, int ps,
                                 int n_pg, float sm_scale,
                                 const long long* maps, cudaStream_t stream) {
  using Cfg = AttnCfg<KD, QUANT>;
  if (maps == nullptr) return cudaErrorInvalidValue;
  const int box_rows = prefill_box_rows(ps, Cfg::BN);
  const long long* km = maps + TMAP_WORDS;
  const long long* vm = maps + 2 * TMAP_WORDS;
  // The plan must follow the same rule: pool maps in boxes of box_rows
  // rows (box dim 2), or none (rank 0) where the producer gathers.
  if (box_rows ? (km[13] != box_rows || vm[13] != box_rows)
               : (km[1] != 0 || vm[1] != 0))
    return cudaErrorInvalidValue;
  CUtensorMap qm, km_enc{}, vm_enc{};
  cudaError_t e = encode_tmap(&qm, q, maps);
  if (e == cudaSuccess && box_rows) e = encode_tmap(&km_enc, k_pool, km);
  if (e == cudaSuccess && box_rows) e = encode_tmap(&vm_enc, v_pool, vm);
  if (e != cudaSuccess) return e;
  int grid = 0;
  e = attn_grid((C + ATT_BM - 1) / ATT_BM * H * B, &grid);
  if (e != cudaSuccess) return e;
  auto kernel = box_rows ? paged_prefill_wgmma_kernel<KD, QUANT, false>
                         : paged_prefill_wgmma_kernel<KD, QUANT, true>;
  e = allow_smem(kernel, Cfg::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<grid, ATT_THREADS, Cfg::SMEM, stream>>>(
      qm, km_enc, vm_enc, static_cast<const unsigned char*>(k_pool),
      static_cast<const unsigned char*>(v_pool),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), tables, offsets, lengths,
      static_cast<__nv_bfloat16*>(out), B, C, H, ps, n_pg, box_rows,
      sm_scale * LOG2E);
  return cudaGetLastError();
}

// The float program: bf16 q on wgmma (given the plan's tensor maps), fp32
// by FMA (given none).
template <int KD>
cudaError_t launch_prefill(int dtype, const void* q, const void* k_pool,
                           const void* v_pool, const int* tables,
                           const int* offsets, const int* lengths, void* out,
                           int B, int C, int H, int ps, int n_pg,
                           float sm_scale, const long long* maps,
                           cudaStream_t stream) {
  if (dtype == DTYPE_BF16)
    return launch_prefill_wgmma<KD, false>(
        q, k_pool, v_pool, nullptr, nullptr, tables, offsets, lengths, out, B,
        C, H, ps, n_pg, sm_scale, maps, stream);
  if (dtype == DTYPE_F32 && maps == nullptr)
    return launch_prefill_kd<float, float, KD>(
        q, k_pool, v_pool, nullptr, nullptr, tables, offsets, lengths, out, B,
        C, H, ps, n_pg, sm_scale, stream);
  return cudaErrorInvalidValue;
}

// The int8 programs: bf16 q on wgmma, fp32 q by FMA.
template <int KD>
cudaError_t launch_prefill_i8(int dtype, const void* q, const void* k_pool,
                              const void* v_pool, const void* k_scale,
                              const void* v_scale, const int* tables,
                              const int* offsets, const int* lengths,
                              void* out, int B, int C, int H, int ps,
                              int n_pg, float sm_scale, const long long* maps,
                              cudaStream_t stream) {
  if (dtype == DTYPE_BF16)
    return launch_prefill_wgmma<KD, true>(q, k_pool, v_pool, k_scale,
                                          v_scale, tables, offsets, lengths,
                                          out, B, C, H, ps, n_pg, sm_scale,
                                          maps, stream);
  if (dtype == DTYPE_F32 && maps == nullptr)
    return launch_prefill_kd<float, int8_t, KD>(
        q, k_pool, v_pool, k_scale, v_scale, tables, offsets, lengths, out,
        B, C, H, ps, n_pg, sm_scale, stream);
  return cudaErrorInvalidValue;
}

// Shared memory one block of the wgmma kernel needs at head dim KD (the
// same at every page size).
template <int KD>
size_t prefill_wgmma_smem_bytes(bool quant) {
  return quant ? AttnCfg<KD, true>::SMEM : AttnCfg<KD, false>::SMEM;
}

}  // namespace
}  // namespace rtt

// Shared memory one block of the kernel that (dtype, quant, K, ps) selects
// needs (quant = 1: the int8 program); the wrapper refuses shapes above
// what a block may have.
extern "C" size_t rtt_paged_prefill_smem_bytes(int dtype, int quant, int K,
                                               int ps) {
  if (dtype == rtt::DTYPE_BF16) {
    switch (K) {
      case 64:
        return rtt::prefill_wgmma_smem_bytes<64>(quant != 0);
      case 80:
        return rtt::prefill_wgmma_smem_bytes<80>(quant != 0);
      case 128:
        return rtt::prefill_wgmma_smem_bytes<128>(quant != 0);
      case 256:
        return rtt::prefill_wgmma_smem_bytes<256>(quant != 0);
    }
  }
  return rtt::prefill_smem_floats(K, ps) * sizeof(float);
}

// maps: bf16 q, the tensor maps of q and of the layer's K and V pools (3 x
// TMAP_WORDS numbers from ops/paged_attention.py `prefill_plan`; the pool
// maps all zeros at a page size whose rows the producer gathers); fp32 q,
// NULL.
extern "C" int rtt_paged_prefill_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* offsets, const void* lengths, void* out,
    int B, int C, int H, int K, int ps, int n_pg, float sm_scale,
    const long long* maps, void* stream) {
  if (ps < 1 || n_pg < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0 || H == 0) return (int)cudaSuccess;
  const int* tbl = static_cast<const int*>(tables);
  const int* offs = static_cast<const int*>(offsets);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (K) {
    case 64:
      e = rtt::launch_prefill<64>(dtype, q, k_pool, v_pool, tbl, offs, lens,
                                  out, B, C, H, ps, n_pg, sm_scale, maps, s);
      break;
    case 80:
      e = rtt::launch_prefill<80>(dtype, q, k_pool, v_pool, tbl, offs, lens,
                                  out, B, C, H, ps, n_pg, sm_scale, maps, s);
      break;
    case 128:
      e = rtt::launch_prefill<128>(dtype, q, k_pool, v_pool, tbl, offs, lens,
                                   out, B, C, H, ps, n_pg, sm_scale, maps, s);
      break;
    case 256:
      e = rtt::launch_prefill<256>(dtype, q, k_pool, v_pool, tbl, offs, lens,
                                   out, B, C, H, ps, n_pg, sm_scale, maps, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return (int)e;
}

// The int8 program: int8 pools, the layer's bf16 per-page scale vectors
// [P+1]; q and out in fp32 or bf16 (dtype); maps as above.
extern "C" int rtt_paged_prefill_attention_int8(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale,
    const void* tables, const void* offsets, const void* lengths, void* out,
    int B, int C, int H, int K, int ps, int n_pg, float sm_scale,
    const long long* maps, void* stream) {
  if (ps < 1 || n_pg < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0 || H == 0) return (int)cudaSuccess;
  const int* tbl = static_cast<const int*>(tables);
  const int* offs = static_cast<const int*>(offsets);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (K) {
    case 64:
      e = rtt::launch_prefill_i8<64>(dtype, q, k_pool, v_pool, k_scale,
                                     v_scale, tbl, offs, lens, out, B, C, H,
                                     ps, n_pg, sm_scale, maps, s);
      break;
    case 80:
      e = rtt::launch_prefill_i8<80>(dtype, q, k_pool, v_pool, k_scale,
                                     v_scale, tbl, offs, lens, out, B, C, H,
                                     ps, n_pg, sm_scale, maps, s);
      break;
    case 128:
      e = rtt::launch_prefill_i8<128>(dtype, q, k_pool, v_pool, k_scale,
                                      v_scale, tbl, offs, lens, out, B, C, H,
                                      ps, n_pg, sm_scale, maps, s);
      break;
    case 256:
      e = rtt::launch_prefill_i8<256>(dtype, q, k_pool, v_pool, k_scale,
                                      v_scale, tbl, offs, lens, out, B, C, H,
                                      ps, n_pg, sm_scale, maps, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return (int)e;
}
