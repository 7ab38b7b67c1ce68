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
//  - bf16 q, K in {64, 80, 128, 256}, page sizes in {8, 16, 32} or a
//    multiple of 64
//    (the serving path; `prefill_kernel` in ops/paged_attention.py holds
//    the same rule): the wgmma kernel of attn_wgmma.cuh, the flash
//    forward's mainloop with a paged producer. Persistent blocks, one per
//    SM, take (128-row query tile, head, slot) items, a slot's query tiles
//    next to each other so the second read of its pages comes from L2. The
//    producer warp reads each box's page id from the table once and brings
//    the key tile (BN = 128 keys at head dim 64, else 64) in by TMA from
//    a 3-D tensor map over the layer's pool viewed as [(P+1)·ps, H, K],
//    one box of gcd(ps, BN) rows per page piece, into a four-stage ring
//    (two at 256, `AttnCfg`);
//    the two consumer warpgroups run S = Q·K^T and O += P·V as wgmma,
//    masking only the tiles that reach past a row's diagonal or the
//    slot's length.
//  - bf16 q at any other page size: the mma.sync kernel below (four warps of
//    16 query rows, 64-key tiles staged through registers by 16-byte
//    loads into dynamic shared memory, S and P·V as mma.sync m16n8k16),
//    every head dim. At 256 the O fragments alone are 128 registers a
//    thread, so Q is staged in shared memory once and its A fragments
//    read per k-step (not 64 more registers), and keys are walked in tiles
//    of 32 (S and P half the registers): 68 KB of shared memory a block.
//    A shape rule of the C entry point, not a
//    fallback: the wrapper's plan and rtt_paged_prefill_smem_bytes apply
//    the same rule.
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
//  - bf16 q: the same kernels as the float program on an int8 pool. In the
//    wgmma kernel TMA brings the page codes into a four-stage staging ring
//    (half the bytes of bf16), and warps 1-3 of the producer warpgroup
//    widen them to bf16 (|code| <= 127 is exact) into the swizzled operand
//    tiles of a two-stage ring and write each key's scales beside them;
//    the mma.sync kernel widens as it stages. The scale is one scalar per page, so it factors out of each
//    key's dot product: S = Q · codes^T on the tensor cores, then each score
//    times its key's K scale (exact up to fp32 reassociation). For P · V
//    each fp32 p is multiplied by its key's V scale and split into two bf16
//    terms, p = hi + lo, run as two products (register-A wgmma, or
//    mma.sync) into one fp32 accumulator: the product keeps about 16 bits
//    of p (relative error <= 2^-16), where one bf16 term would round p to 8
//    bits as the gather reference does.

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
// bf16 tensor-core version.

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_TQ = 16 * MMA_WARPS;  // query rows per block
// Head dims the mma.sync kernel takes: every one of the wrappers'.
constexpr int MMA_MAX_KD = 256;
// Past head dim 128 the O fragments alone are 128 registers a thread: Q
// stays in shared memory (its fragments loaded per k-step) instead of 64
// more registers, and the keys are walked in tiles of 32 (half the S and P
// fragments).
template <int KD>
constexpr bool MMA_Q_SMEM = KD > 128;
template <int KD>
constexpr int MMA_TK = KD > 128 ? 32 : 64;  // keys per shared tile

// Dynamic shared memory of one block: the bf16 K and V tiles, the Q tile
// (past head dim 128), and (int8 program) one K and one V scale per key;
// rows padded by 8 elements.
template <int KD>
__host__ __device__ constexpr size_t prefill_mma_smem_bytes(bool quant) {
  return (2 * (size_t)MMA_TK<KD> + (MMA_Q_SMEM<KD> ? MMA_TQ : 0)) *
             (KD + 8) * sizeof(__nv_bfloat16) +
         2 * (size_t)(quant ? MMA_TK<KD> : 1) * sizeof(float);
}

// A warp's Q fragments (the A operand of S = Q·K^T): this lane's rows r0
// and r1 = r0 + 8 of the block's tile at `qb`; rows past `rows` are 0.
template <int KSTEPS>
__device__ __forceinline__ void load_q_frags(const __nv_bfloat16* qb,
                                             size_t row_stride, int r0,
                                             int r1, int rows, int t4,
                                             uint32_t (&qa)[KSTEPS][4]) {
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

// O / l of this lane's rows r0 and r1 in bf16 at `ob` (the tile's first
// row); l == 0 (no visible key) writes zeros, rows past `rows` nothing.
template <int NT_O>
__device__ __forceinline__ void store_o_rows(const float (&o)[NT_O][4],
                                             const float (&l_r)[2],
                                             __nv_bfloat16* ob,
                                             size_t row_stride, int r0,
                                             int r1, int rows, int t4) {
  const float inv0 = 1.f / (l_r[0] == 0.f ? 1.f : l_r[0]);
  const float inv1 = 1.f / (l_r[1] == 0.f ? 1.f : l_r[1]);
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

// TP: the pool's element type, bf16 (the float program) or int8_t (the int8
// program: codes widened to bf16 as they are staged, each score times its
// key's K scale, p times its key's V scale as bf16 hi + lo).
template <typename TP, int KD>
__global__ void __launch_bounds__(MMA_THREADS)
    paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const TP* __restrict__ k_pool,
                             const TP* __restrict__ v_pool,
                             const __nv_bfloat16* __restrict__ k_scale,
                             const __nv_bfloat16* __restrict__ v_scale,
                             const int* __restrict__ tables,
                             const int* __restrict__ offsets,
                             const int* __restrict__ lengths,
                             __nv_bfloat16* __restrict__ out, int C, int H,
                             int ps, int n_pg, float sm_scale) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  static_assert(KD % 16 == 0 && KD <= MMA_MAX_KD, "head dim for the mma path");
  constexpr bool Q_SMEM = MMA_Q_SMEM<KD>;
  constexpr int TK = MMA_TK<KD>;       // keys per shared tile
  constexpr int KSTEPS = KD / 16;      // k-steps of Q·K^T
  constexpr int NT_S = TK / 8;         // n-tiles of S (keys)
  constexpr int NT_O = KD / 8;         // n-tiles of O (head dims)
  constexpr int KP = KD + 8;           // padded shared row, in elements
  constexpr int EPC = 16 / sizeof(TP); // pool elements per 16-byte load
  constexpr int CPR = KD / EPC;        // 16-byte loads per pool row
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* v_s = k_s + TK * KP;
  __nv_bfloat16* q_s = v_s + TK * KP;  // [MMA_TQ][KP] when Q_SMEM
  float* ks_s = reinterpret_cast<float*>(q_s + (Q_SMEM ? MMA_TQ * KP : 0));
  float* vs_s = ks_s + (kQuant ? TK : 1);  // key's V scale
  // ks_s: key's K scale · sm_scale

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

  // Q fragments stay in registers for the whole key walk (past head dim
  // 128, Q in shared memory); rows past C are 0.
  const __nv_bfloat16* qb = q + (((size_t)b * C + q0) * H + h) * KD;
  uint32_t qa[Q_SMEM ? 1 : KSTEPS][4];
  if constexpr (Q_SMEM) {
    for (int i = tid; i < MMA_TQ * (KD / 8); i += MMA_THREADS) {
      const int r = i / (KD / 8);
      const int cc = (i - r * (KD / 8)) * 8;
      *reinterpret_cast<uint4*>(&q_s[r * KP + cc]) =
          r < rows ? *reinterpret_cast<const uint4*>(qb + r * row_stride + cc)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    load_q_frags(qb, row_stride, r0, r1, rows, t4, qa);
  }

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};

  // Last position any row of this tile may attend, plus one.
  int kv_end = min(len, off + q0 + rows);
  kv_end = min(kv_end, n_pg * ps);
  const int n_kt = kv_end > 0 ? (kv_end + TK - 1) / TK : 0;
  const int warp_last_qpos = off + q0 + warp * 16 + 15;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int key0 = kt * TK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < TK * CPR; i += MMA_THREADS) {
      const int r = i / CPR;
      const int cc = (i - r * CPR) * EPC;
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
      if constexpr (kQuant) {
        store_i8x16_as_bf16(&k_s[r * KP + cc], kv);
        store_i8x16_as_bf16(&v_s[r * KP + cc], vv);
      } else {
        *reinterpret_cast<uint4*>(&k_s[r * KP + cc]) = kv;
        *reinterpret_cast<uint4*>(&v_s[r * KP + cc]) = vv;
      }
    }
    if constexpr (kQuant) {
      for (int r = tid; r < TK; r += MMA_THREADS) {
        const int pos = key0 + r;
        float ksc = 0.f, vsc = 0.f;
        if (pos < kv_end) {
          // Indexed by the page id, never by the table position.
          const size_t page = (size_t)tables[(size_t)b * n_pg + pos / ps];
          ksc = to_f(k_scale[page]) * sm_scale;
          vsc = to_f(v_scale[page]);
        }
        ks_s[r] = ksc;
        vs_s[r] = vsc;
      }
    }
    __syncthreads();
    if (key0 > warp_last_qpos) continue;  // all keys after all of our rows

    // S = Q · K^T (int8: Q · codes^T) for this warp's 16 rows and the
    // tile's TK keys.
    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t a[4];
      if constexpr (Q_SMEM) {  // the A fragment of load_q_frags
        const uint32_t* q0w = reinterpret_cast<const uint32_t*>(
            &q_s[r0 * KP + ks * 16 + 2 * t4]);
        const uint32_t* q1w = reinterpret_cast<const uint32_t*>(
            &q_s[r1 * KP + ks * 16 + 2 * t4]);
        a[0] = q0w[0];
        a[1] = q1w[0];
        a[2] = q0w[4];
        a[3] = q1w[4];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qa[ks][e];
      }
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        const uint32_t* kr = reinterpret_cast<const uint32_t*>(
            &k_s[(n * 8 + g) * KP + ks * 16 + 2 * t4]);
        mma_bf16_16816(s[n], a, kr[0], kr[4]);
      }
    }

    // The score scale (sm_scale; int8: times the key's K scale), the
    // two-part mask, then the online softmax of rows r0 and r1. A row's
    // four lanes (same g) hold its TK scores between them.
    float mx0 = m_r[0];
    float mx1 = m_r[1];
    uint32_t valid = 0;  // bit 4n+e: entry s[n][e] is a visible key
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = n * 8 + 2 * t4 + e;
        const int key = key0 + kl;
        const float sc = kQuant ? ks_s[kl] : sm_scale;
        if (key < len && key <= qpos0) {
          valid |= 1u << (4 * n + e);
          s[n][e] *= sc;
          mx0 = fmaxf(mx0, s[n][e]);
        }
        if (key < len && key <= qpos1) {
          valid |= 1u << (4 * n + 2 + e);
          s[n][2 + e] *= sc;
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
    // int8: w = p · vs (fp32, unrounded) as hi = bf16(w) in pa and the
    // remainder lo = w - hi (exact in fp32) in pa_lo.
    uint32_t pa[NT_S / 2][4];
    uint32_t pa_lo[kQuant ? NT_S / 2 : 1][4];
    float ps0 = 0.f;
    float ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = (valid >> (4 * n + e)) & 1u
                   ? __expf(s[n][e] - (e < 2 ? mx0 : mx1))
                   : 0.f;
      ps0 += w[0] + w[1];
      ps1 += w[2] + w[3];
      if constexpr (kQuant) {
        const float vs0 = vs_s[n * 8 + 2 * t4];
        const float vs1 = vs_s[n * 8 + 2 * t4 + 1];
        w[0] *= vs0;
        w[1] *= vs1;
        w[2] *= vs0;
        w[3] *= vs1;
        float lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          lo[e] = w[e] - round_to<__nv_bfloat16>(w[e]);
        pa_lo[n / 2][(n & 1) * 2 + 0] = pack_bf16x2(lo[0], lo[1]);
        pa_lo[n / 2][(n & 1) * 2 + 1] = pack_bf16x2(lo[2], lo[3]);
      }
      pa[n / 2][(n & 1) * 2 + 0] = pack_bf16x2(w[0], w[1]);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16x2(w[2], w[3]);
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
        if constexpr (kQuant) {
          mma_bf16_16816(o[2 * np], pa_lo[j], vb[0], vb[1]);
          mma_bf16_16816(o[2 * np + 1], pa_lo[j], vb[2], vb[3]);
        }
      }
    }
  }

  store_o_rows(o, l_r, out + (((size_t)b * C + q0) * H + h) * KD, row_stride,
               r0, r1, rows, t4);
}

template <typename TP, int KD>
cudaError_t launch_prefill_mma(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const int* tables,
                               const int* offsets, const int* lengths,
                               void* out, int B, int C, int H, int ps,
                               int n_pg, float sm_scale, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  const size_t smem = prefill_mma_smem_bytes<KD>(kQuant);
  cudaError_t e = allow_smem(paged_prefill_mma_kernel<TP, KD>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((C + MMA_TQ - 1) / MMA_TQ, H, B);
  paged_prefill_mma_kernel<TP, KD><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), tables, offsets, lengths,
      static_cast<__nv_bfloat16*>(out), C, H, ps, n_pg, sm_scale);
  return cudaGetLastError();
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

// The page sizes the wgmma kernel takes (`prefill_kernel` in
// ops/paged_attention.py holds the same rule): a key tile is made of whole
// TMA boxes of gcd(ps, BN) rows, each a multiple of one 8-row swizzle atom.
__host__ __device__ constexpr bool wgmma_page_size(int ps) {
  return ps > 0 && ps % 8 == 0 && (64 % ps == 0 || ps % 64 == 0);
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

// QUANT: the int8 program (k_scale / v_scale read by page id; the codes are
// staged and widened by warps 1-3 of the producer warpgroup). Persistent:
// one block per SM.
template <int KD, bool QUANT>
__global__ void __launch_bounds__(ATT_THREADS, 1)
    paged_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
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
  extern __shared__ unsigned char smem_raw[];
  const int n_qt = (C + ATT_BM - 1) / ATT_BM;
  const int n_items = n_qt * H * B;
  const long long row_stride = (long long)H * KD;
  AttnBars bar;
  // int8: the three widening warps arrive once each on full_k.
  unsigned char* base = attn_setup<Cfg::KV_ST, Cfg::STG_ST>(
      smem_raw, Cfg::OFF_BAR, QUANT ? ATT_WIDEN_THREADS / 32 : 1, bar);

  if (threadIdx.x < WG_THREADS) {
    regs_dec<ATT_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const int n_box = BN / box_rows;
      int g = 0, jq = 0;
      for (int k = 0;; ++k) {
        const int item = attn_item(k);
        if (item >= n_items) break;
        const PrefillItem it = prefill_item<BN>(item, n_qt, C, H, ps, n_pg,
                                                offsets, lengths);
        if (it.n_kt == 0) continue;
        const int qb = qbuf<Cfg::Q_BUFS>(jq);
        mbar_wait(bar.a_empty + qb, qphase<Cfg::Q_BUFS>(jq) ^ 1);
        mbar_expect_tx(bar.full_a + qb, Cfg::Q_BYTES);
#pragma unroll
        for (int cb = 0; cb < Cfg::NBOX; ++cb)
          tma_load_4d(attn_q<KD, QUANT>(base, qb) + cb * ATT_BM * 128, &qmap,
                      bar.full_a + qb, cb * 64, it.h, it.q0, it.b);
        ++jq;
        const int* trow = tables + (long long)it.b * n_pg;
        for (int kt = 0; kt < it.n_kt; ++kt, ++g) {
          const int key0 = kt * BN;
          if constexpr (QUANT) {
            const int sg = g % Cfg::STG_ST;
            mbar_wait(bar.stg_empty + sg, ((g / Cfg::STG_ST) & 1) ^ 1);
            // Each box's page id, for the widening warps' scales, before
            // the arrival that publishes it. A box past the tile's reach
            // reads the null page 0 (finite values that the mask hides).
            int* pid = reinterpret_cast<int*>(base + Cfg::OFF_PID) + sg * BN;
            for (int i = 0; i < n_box; ++i) {
              const int pos = key0 + i * box_rows;
              pid[i] = pos < it.kv_end ? trow[pos / ps] : 0;
            }
            mbar_expect_tx(bar.stg_full + sg, 2 * Cfg::STG_BYTES);
            unsigned char* sk = base + Cfg::OFF_STG + sg * 2 * Cfg::STG_BYTES;
            for (int i = 0; i < n_box; ++i) {
              const int pos = key0 + i * box_rows;
              const int row = pid[i] * ps + (pos < it.kv_end ? pos % ps : 0);
              tma_load_3d(sk + i * box_rows * KD, &kmap, bar.stg_full + sg,
                          0, it.h, row);
              tma_load_3d(sk + Cfg::STG_BYTES + i * box_rows * KD, &vmap,
                          bar.stg_full + sg, 0, it.h, row);
            }
          } else {
            const int st = g % Cfg::KV_ST;
            mbar_wait(bar.empty + st, ((g / Cfg::KV_ST) & 1) ^ 1);
            unsigned char* kd = base + Cfg::OFF_K + st * Cfg::KV_BYTES;
            unsigned char* vd = base + Cfg::OFF_V + st * Cfg::KV_BYTES;
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
    } else if (QUANT && threadIdx.x >= 32) {
      int g = 0;
      for (int k = 0;; ++k) {
        const int item = attn_item(k);
        if (item >= n_items) break;
        const PrefillItem it = prefill_item<BN>(item, n_qt, C, H, ps, n_pg,
                                                offsets, lengths);
        attn_widen<KD>(base, bar, g, it.n_kt, box_rows, k_scale, v_scale, c);
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
        // int8: c is in each key's K scale.
        attn_mainloop<KD, QUANT>(base, attn_q<KD, QUANT>(base, qb), bar, wg,
                                 g, it.n_kt, it.kv_lim,
                                 it.off + it.q0 + wg * 64, QUANT ? 1.f : c,
                                 acc, m2, l);
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
  const int box_rows = (int)maps[TMAP_WORDS + 13];  // k's box, dim 2
  if (box_rows < 8 || Cfg::BN % box_rows || ps % box_rows)
    return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  cudaError_t e = encode_tmap(&qm, q, maps);
  if (e == cudaSuccess) e = encode_tmap(&km, k_pool, maps + TMAP_WORDS);
  if (e == cudaSuccess) e = encode_tmap(&vm, v_pool, maps + 2 * TMAP_WORDS);
  if (e != cudaSuccess) return e;
  e = allow_smem(paged_prefill_wgmma_kernel<KD, QUANT>, Cfg::SMEM);
  int grid = 0;
  if (e == cudaSuccess) e = attn_grid((C + ATT_BM - 1) / ATT_BM * H * B, &grid);
  if (e != cudaSuccess) return e;
  paged_prefill_wgmma_kernel<KD, QUANT><<<grid, ATT_THREADS, Cfg::SMEM,
                                          stream>>>(
      qm, km, vm, static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), tables, offsets, lengths,
      static_cast<__nv_bfloat16*>(out), B, C, H, ps, n_pg, box_rows,
      sm_scale * LOG2E);
  return cudaGetLastError();
}

// bf16 q (TP: the pool's element type, bf16 or int8): the wgmma kernel at
// the page sizes it takes, given the tensor maps; the mma.sync kernel at
// any other page size, given none.
template <typename TP, int KD>
cudaError_t launch_prefill_bf16(const void* q, const void* k_pool,
                                const void* v_pool, const void* k_scale,
                                const void* v_scale, const int* tables,
                                const int* offsets, const int* lengths,
                                void* out, int B, int C, int H, int ps,
                                int n_pg, float sm_scale,
                                const long long* maps, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<TP, int8_t>::value;
  if (wgmma_page_size(ps) != (maps != nullptr)) return cudaErrorInvalidValue;
  if (maps != nullptr)
    return launch_prefill_wgmma<KD, kQuant>(
        q, k_pool, v_pool, k_scale, v_scale, tables, offsets, lengths, out, B,
        C, H, ps, n_pg, sm_scale, maps, stream);
  return launch_prefill_mma<TP, KD>(q, k_pool, v_pool, k_scale, v_scale,
                                    tables, offsets, lengths, out, B, C, H, ps,
                                    n_pg, sm_scale, stream);
}

// The float program: bf16 q by launch_prefill_bf16, fp32 by FMA.
template <int KD>
cudaError_t launch_prefill(int dtype, const void* q, const void* k_pool,
                           const void* v_pool, const int* tables,
                           const int* offsets, const int* lengths, void* out,
                           int B, int C, int H, int ps, int n_pg,
                           float sm_scale, const long long* maps,
                           cudaStream_t stream) {
  if (dtype == DTYPE_BF16)
    return launch_prefill_bf16<__nv_bfloat16, KD>(
        q, k_pool, v_pool, nullptr, nullptr, tables, offsets, lengths, out, B,
        C, H, ps, n_pg, sm_scale, maps, stream);
  if (dtype == DTYPE_F32 && maps == nullptr)
    return launch_prefill_kd<float, float, KD>(
        q, k_pool, v_pool, nullptr, nullptr, tables, offsets, lengths, out, B,
        C, H, ps, n_pg, sm_scale, stream);
  return cudaErrorInvalidValue;
}

// The int8 programs: bf16 q by launch_prefill_bf16, fp32 q by FMA.
template <int KD>
cudaError_t launch_prefill_i8(int dtype, const void* q, const void* k_pool,
                              const void* v_pool, const void* k_scale,
                              const void* v_scale, const int* tables,
                              const int* offsets, const int* lengths,
                              void* out, int B, int C, int H, int ps,
                              int n_pg, float sm_scale, const long long* maps,
                              cudaStream_t stream) {
  if (dtype == DTYPE_BF16)
    return launch_prefill_bf16<int8_t, KD>(q, k_pool, v_pool, k_scale,
                                           v_scale, tables, offsets, lengths,
                                           out, B, C, H, ps, n_pg, sm_scale,
                                           maps, stream);
  if (dtype == DTYPE_F32 && maps == nullptr)
    return launch_prefill_kd<float, int8_t, KD>(
        q, k_pool, v_pool, k_scale, v_scale, tables, offsets, lengths, out,
        B, C, H, ps, n_pg, sm_scale, stream);
  return cudaErrorInvalidValue;
}

// Shared memory one block of the bf16-q kernel that (quant, ps) selects
// at head dim KD.
template <int KD>
size_t prefill_bf16_smem_bytes(bool quant, int ps) {
  if (wgmma_page_size(ps))
    return quant ? AttnCfg<KD, true>::SMEM : AttnCfg<KD, false>::SMEM;
  return prefill_mma_smem_bytes<KD>(quant);
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
        return rtt::prefill_bf16_smem_bytes<64>(quant != 0, ps);
      case 80:
        return rtt::prefill_bf16_smem_bytes<80>(quant != 0, ps);
      case 128:
        return rtt::prefill_bf16_smem_bytes<128>(quant != 0, ps);
      case 256:
        return rtt::prefill_bf16_smem_bytes<256>(quant != 0, ps);
    }
  }
  return rtt::prefill_smem_floats(K, ps) * sizeof(float);
}

// maps: bf16 q at a page size the wgmma kernel takes, the tensor maps of q
// and of the layer's K and V pools (3 x TMAP_WORDS numbers from
// ops/paged_attention.py `prefill_plan`); otherwise NULL.
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
