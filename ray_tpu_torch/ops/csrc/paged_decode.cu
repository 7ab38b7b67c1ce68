// Ragged paged-attention DECODE kernel for Hopper (sm_90a), float and int8
// programs on one structure.
//
// Replaces: ray_tpu/ops/paged_attention.py, `_decode_kernel` (Pallas TPU
// kernel behind the wrapper `paged_attention`), traced with a float pool
// and with quantized=True. Same function: each slot b has one query row
// q[b, h, :] per head and attends over the first lengths[b] positions of its
// pages, read in place from one layer's pool [P+1, ps, H, K] through the
// page table tables[b, :n_pg]. Online softmax (m, l, acc) in fp32,
// positions >= lengths[b] masked, pages at or past the length neither read
// nor computed, and l == 0 writes zeros. Output in q.dtype. The float
// program rounds each p to q's dtype before P·V while l sums the unrounded
// p (the Pallas kernel's p.astype(v.dtype)); the int8 program (int8 pages,
// one K and one V scale per page read from the layer's bf16 scale vectors
// by the page id tables[b, j], never by table position) folds the page's K
// scale (x sm_scale) into each score and its V scale into p, and leaves p
// unrounded, as the Pallas program does on pages it dequantizes to fp32.
//
// What bounds it on the H100: bytes. One query row per head meets each K
// and V row once, about 2 FLOPs per byte read at K = 64 bf16 (4 for int8
// codes), far below the ~295 FLOP/byte where the tensor cores would become
// the limit, so the floor is the live KV bytes over 3.35 TB/s. Tensor cores
// are not used: with one query row per head a 64-row wgmma tile would be
// 1/64 useful, and the FMAs below keep up with the bytes (grouped-query
// models, where several query rows share a K/V head, are not in the port).
//
// What the design does about it:
//  - Work unit (slot b, group of DEC_GROUP = 4 adjacent heads, split s of
//    the slot's live positions). The G heads of one position are
//    G·K·itemsize contiguous bytes of the pool (512 B at K = 64 bf16), one
//    row of a TMA box, where one head's 128-byte row sits at a stride of
//    H·K·itemsize (4 KB at the serving shape).
//  - One producer warp keeps a ring of DEC_STAGES = 3 shared-memory stages
//    full with TMA tile loads (cp.async.bulk.tensor ... mbarrier::
//    complete_tx, UTMALDG in the SASS): each stage holds R positions of K
//    and R of V for the block's heads, as boxes of gcd(ps, R) positions x G
//    heads x K from a 3-D tensor map over the layer's plane viewed as
//    [(P+1)·ps, H, K], so a box never crosses a page and one or two boxes
//    per plane fill a stage at the serving page sizes. The C entry point
//    encodes the two maps at every launch (the pool's address changes per
//    layer; nothing is planned in Python). A last group past H reads zeros
//    (the map's bounds) that no warp uses. Completion goes to a `full`
//    mbarrier per stage (32 arrivals, the producer's lanes, plus the
//    bytes); the int8 program's lanes also write their positions' scales
//    (by page id) beside the stage first. The first version issued one
//    non-tensor bulk copy (cp.async.bulk, UBLKCP) per position and plane
//    from 32 lanes: UBLKCP takes warp-uniform operands, so the 32 copies of
//    a warp instruction issue one after another, and 32-64 copies of 256-
//    512 bytes per 16 KB stage held a block to about 10 GB/s.
//  - Four consumer warps, one per head of the group, compute from shared
//    memory and release the stage on its `empty` mbarrier. A K/V row is
//    K/VEC lanes of 16-byte ld.shared, so a quarter-warp reads one
//    contiguous 128-byte row, free of bank conflicts without a swizzle
//    (int8 at K = 64: two 64-byte rows per quarter-warp, a 2-way conflict;
//    shared memory is not the limit there). Each lane group keeps its own
//    online-softmax state (scores in log2 units, exp2 on the SFU) over
//    UNROLL rows per stage; shuffles merge the groups at the end. int8
//    codes are widened by a byte permute and an add (`load_row`).
//  - A stage is DEC_STAGE_BYTES = 16 KB whatever the element type or head
//    dim, R positions: bf16 K 64 16, K 128 8; fp32 8 and 4; int8 32 and
//    16; UNROLL = R / (rows a warp covers per instruction) = 4 rows per
//    lane group. Rows past the length in the last page are loaded with
//    their box and dropped by the consumers; pages past it are never read.
//  - Split-K over the positions (flash-decoding), sized in two steps. The
//    host bounds the grid: n_split splits per (slot, group), DEC_WAVES
//    waves of the 4 blocks per SM that a 49,968-byte ring allows over the
//    B · ceil(H / G) units, at most one per table page (`decode_splits`,
//    mirrored by ops/paged_attention.py and checked by the entry point);
//    it reads no lengths, so the host-bound engine never waits. On the
//    device every block reads all B lengths and gives each slot n_parts of
//    its n_split splits: its share of one wave by its live stages against
//    the batch's (`slot_parts`; `decode_live_splits` in Python). A full
//    batch so keeps one wave of blocks (16 slots of 1,024 at H 32: 4
//    splits, 512 blocks; a second wave cost each block its prologue
//    again), and a light one spreads its few live slots over many (2 live
//    of 16: 16 splits each). Splits are whole stages, so their work
//    differs by at most one stage. The blocks with work take the first
//    block indices (split by split, `Item`), so none waits behind blocks
//    without; the grid is min(units · n_split, units + one wave), and the
//    blocks past the work exit at once. With the splits that a slot does
//    not use interleaved among the others' and a grid of units · n_split,
//    light load took a third longer.
//  - With one split the block writes the output. With more, each writes
//    its partial (m, l, acc) to an fp32 workspace and the last of the
//    slot's splits to arrive (an atomic count per (slot, group) that it
//    zeroes again) merges them in split order: no float atomics, so two
//    calls on the same inputs give the same bits. A separate merge kernel
//    cost its launch and a serial read of the splits, about 5 µs a call.
//    NEG_INF is finite, so even empty states could not make NaN.
//  - Sizing (Little's law): 3.35 TB/s at ~1 µs of latency needs ~25 KB in
//    flight per SM; a block keeps up to three 16 KB stages in flight and 4
//    blocks fit on an SM (a fourth stage, 3 blocks per SM, measured no
//    faster). Measured (PERF.md): the data path alone, without the
//    consumers' arithmetic, takes nearly all of the time; what it adds to
//    streaming is the launch, each block's first loads (the lengths, the
//    table, the tensor maps, prefetched) and the last block's merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <numeric>

#include "common.cuh"
#include "hopper.cuh"

namespace rtt {
namespace {

constexpr int DEC_GROUP = 4;                  // heads per block (one warp each)
constexpr int DEC_THREADS = 32 * (DEC_GROUP + 1);
constexpr int DEC_STAGES = 3;
constexpr int DEC_STAGE_BYTES = 16384;        // R rows of K and R of V
constexpr int DEC_SCALE_BYTES = 2 * 32 * 4;   // int8: R K and R V scales
constexpr int DEC_SMEM = DEC_STAGES * (DEC_STAGE_BYTES + DEC_SCALE_BYTES) +
                         2 * DEC_STAGES * 8;  // + the full/empty mbarriers
// Blocks per SM the ring allows: 228 KB of shared memory per SM, 1 KB of it
// reserved per block.
constexpr int SM_SMEM_BYTES = 233472;
constexpr int DEC_BLOCKS_PER_SM = SM_SMEM_BYTES / (DEC_SMEM + 1024);
constexpr int DEC_WAVES = 4;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(DEC_BLOCKS_PER_SM == 4, "ops/paged_attention.py mirrors 4");

// The split rule (ops/paged_attention.py `decode_splits`): about DEC_WAVES
// waves of resident blocks over B · ceil(H / G) units, at most one split per
// table page, at least one.
int decode_splits(int B, int H, int n_pg, int n_sm) {
  const long long units = (long long)B * ((H + DEC_GROUP - 1) / DEC_GROUP);
  long long n = (long long)DEC_WAVES * n_sm * DEC_BLOCKS_PER_SM / units;
  if (n > n_pg) n = n_pg;
  return n < 1 ? 1 : (int)n;
}

template <typename Tkv, int KD>
struct DecCfg {
  static constexpr bool QUANT = sizeof(Tkv) == 1;
  static constexpr int VEC = 16 / (int)sizeof(Tkv);  // elements per ld.shared
  static constexpr int LPR = KD / VEC;               // lanes per K/V row
  static constexpr int RPW = 32 / LPR;               // rows per warp step
  static constexpr int PIECE = DEC_GROUP * KD * (int)sizeof(Tkv);
  static constexpr int R = DEC_STAGE_BYTES / (2 * PIECE);  // positions/stage
  static constexpr int UNROLL = R / RPW;             // rows per lane group
  static_assert(KD % VEC == 0 && LPR >= 1 && LPR <= 32 && 32 % LPR == 0,
                "head dim must split into 16-byte lanes of one warp");
  static_assert(UNROLL >= 1 && UNROLL * RPW == R && R <= 32,
                "a stage is whole warp steps of at most 32 positions");
};

// A barrier of the DEC_GROUP consumer warps alone (named barrier 1; the
// producer warp has returned by then).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * DEC_GROUP) : "memory");
}

// One K/V row piece of VEC elements from shared memory, widened to fp32.
__device__ __forceinline__ void load_row(const float* p, float (&f)[4]) {
  load16(p, f);
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&f)[8]) {
  load16(p, f);
}
// Sixteen codes: each byte, offset by 128, becomes the low byte of the
// float 2^23 + (code + 128), from which one subtraction gives the code
// exactly: a permute and an add per code on the full-rate pipes, where a
// conversion (I2F) runs at a quarter of the rate.
__device__ __forceinline__ void load_row(const int8_t* p, float (&f)[16]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[4 * i + e] =
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | e)) -
          8388736.f;  // 2^23 + 128
  }
}

// The stages of a slot's live positions: min(len, n_pg·ps) positions (the
// table can be narrower than len when an idle slot's cursor has walked
// past it) in steps of R.
__device__ __forceinline__ int live_stages(int len, int ps, int n_pg, int R) {
  const int n = min(len, n_pg * ps);
  return n > 0 ? (n - 1) / R + 1 : 0;
}

// How many of the grid's n_split splits a slot uses (`decode_live_splits`):
// its share of one wave of `slots` blocks by its live stage-groups against
// the whole batch's, rounded down, at most n_split, at most one per stage,
// at least one.
__device__ __forceinline__ int slot_parts(int len, int batch_stages,
                                          int n_groups, int n_split, int slots,
                                          int ps, int n_pg, int R) {
  const int n_live = live_stages(len, ps, n_pg, R);
  const long long share =
      (long long)n_live * slots / max(1, batch_stages * n_groups);
  return max(1, (int)min((long long)min(n_split, n_live), share));
}

// One block's work item: split s of slot b for head group g. The blocks
// with work come first, split by split: for s = 0, 1, ... the slots that
// use a split s, in slot order, each with its head groups side by side
// (they read the same positions' rows); a block past them exits at once.
// When every slot uses the same number of splits this is block i = (s·B +
// b)·groups + g. Split s takes stages [s·n_live / n_parts, (s+1)·n_live /
// n_parts) of the slot's n_live, positions [t_begin, t_end).
struct Item {
  int b, g, s, t_begin, t_end, n_steps, n_parts;
};

// Tq: q and out (float or bf16). Tkv: the pool, Tq for the float program,
// int8_t for the int8 one (k_scale / v_scale then the layer's bf16 scale
// vectors). kmap / vmap: the layer's K and V planes viewed as [(P+1)·ps,
// H, K], boxes of box_rows positions of min(G, H) heads (`decode_map`). ws
// and counters (n_split > 1, else unused): the splits' states and one
// arrival count per (slot, group), zero at launch and left zero. One block
// per item: B · ceil(H / G) · n_split blocks.
template <typename Tq, typename Tkv, int KD>
__global__ void __launch_bounds__(DEC_THREADS, DEC_BLOCKS_PER_SM)
    paged_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const Tq* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_scale,
                        const __nv_bfloat16* __restrict__ v_scale,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths, Tq* __restrict__ out,
                        float* __restrict__ ws, int* __restrict__ counters,
                        int B, int H, int ps, int n_pg, int n_split,
                        int slots, int box_rows, float sm_scale) {
  using C = DecCfg<Tkv, KD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* scales = reinterpret_cast<float*>(smem + DEC_STAGES * DEC_STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + DEC_STAGES * (DEC_STAGE_BYTES + DEC_SCALE_BYTES));
  uint64_t* empty = full + DEC_STAGES;
  __shared__ int last;

  __shared__ int item[5];  // slot (-1: none), split, group, n_parts, length
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_groups = (H + DEC_GROUP - 1) / DEC_GROUP;
  // The producer reads the first 32 table entries of the slot that block
  // i takes when every slot uses the same number of splits, while warp 0
  // works out the block's item; it reads them again if the guess missed.
  const int guess = (blockIdx.x / n_groups) % B;
  int head = warp == DEC_GROUP && lane < n_pg
                 ? tables[(size_t)guess * n_pg + lane]
                 : 0;
  if (warp == DEC_GROUP && lane == 0) {
    tma_prefetch_map(&kmap);
    tma_prefetch_map(&vmap);
  }

  if (warp == 0) {
    // Every slot's splits from all the lengths (the first 32 slots' kept
    // in a register), then the item whose rank is this block's index.
    const int len0 = lane < B ? lengths[lane] : 0;
    int stages = live_stages(len0, ps, n_pg, C::R);
    for (int i = lane + 32; i < B; i += 32)
      stages += live_stages(lengths[i], ps, n_pg, C::R);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      stages += __shfl_xor_sync(0xffffffffu, stages, o);
    auto parts_of = [&](int j, int len) {
      return j < B ? slot_parts(len, stages, n_groups, n_split, slots, ps,
                                n_pg, C::R)
                   : 0;
    };
    const int parts0 = parts_of(lane, len0);
    int rank = blockIdx.x;
    int found[5] = {-1, 0, 0, 0, 0};
    for (int s = 0; s < n_split && found[0] < 0; ++s) {
      for (int base = 0; base < B; base += 32) {
        const int lj = base == 0 ? len0
                       : base + lane < B ? lengths[base + lane] : 0;
        const int pj = base == 0 ? parts0 : parts_of(base + lane, lj);
        const unsigned uses = __ballot_sync(0xffffffffu, pj > s);
        const int blocks = __popc(uses) * n_groups;
        if (rank < blocks) {  // the (rank / groups)-th slot here using s
          const int k = rank / n_groups;
          const bool kth = (uses >> lane & 1) &&
                           __popc(uses & ((1u << lane) - 1)) == k;
          const int src = __ffs(__ballot_sync(0xffffffffu, kth)) - 1;
          found[0] = base + src;
          found[1] = s;
          found[2] = rank % n_groups;
          found[3] = __shfl_sync(0xffffffffu, pj, src);
          found[4] = __shfl_sync(0xffffffffu, lj, src);
          break;
        }
        rank -= blocks;
      }
    }
    if (lane == 0) {
      for (int i = 0; i < 5; ++i) item[i] = found[i];
      for (int i = 0; i < DEC_STAGES; ++i) {
        mbar_init(full + i, 32);
        mbar_init(empty + i, DEC_GROUP);
      }
      fence_barrier_init();
    }
  }
  __syncthreads();
  if (item[0] < 0) return;
  Item it;
  it.b = item[0];
  it.s = item[1];
  it.g = item[2];
  it.n_parts = item[3];
  const int len = item[4];
  {
    const int n_live = live_stages(len, ps, n_pg, C::R);
    const int st0 = (int)((long long)it.s * n_live / it.n_parts);
    const int st1 = (int)((long long)(it.s + 1) * n_live / it.n_parts);
    it.t_begin = st0 * C::R;
    it.t_end = min(st1 * C::R, min(len, n_pg * ps));
    it.n_steps = st1 - st0;
  }
  const int* table = tables + (size_t)it.b * n_pg;
  const int h0 = it.g * DEC_GROUP;
  // One position of a box: min(G, H) heads (a last group past H reads
  // zeros there, which no warp uses).
  const int row_elems = min(DEC_GROUP, H) * KD;

  if (warp == DEC_GROUP) {
    // Producer. A stage is R / box_rows boxes per plane (box_rows =
    // gcd(ps, R): a box never crosses a page); lane k holds the page id of
    // box k (from `head`, or read one step ahead past the table's first 32
    // entries), and lane r the int8 scales of position r,
    // read before the wait for a free stage, so the table's latency
    // overlaps the ring's. Lane 0 issues the loads (warp-uniform operands).
    const int n_box = C::R / box_rows;
    const uint32_t box_bytes =
        (uint32_t)(box_rows * row_elems * (int)sizeof(Tkv));
    if (it.b != guess) head = lane < n_pg ? table[lane] : 0;
    auto box_page = [&](int i) {
      const int t = it.t_begin + i * C::R + lane * box_rows;
      const int j = t / ps;
      const int held = __shfl_sync(0xffffffffu, head, j & 31);
      if (lane >= n_box || t >= it.t_end) return 0;
      return j < 32 ? held : table[j];
    };
    int page = box_page(0);
    for (int i = 0; i < it.n_steps; ++i) {
      const int st = i % DEC_STAGES;
      const int t0 = it.t_begin + i * C::R;
      const int n_rows = min(C::R, it.t_end - t0);
      const int nb = (n_rows - 1) / box_rows + 1;
      const int page_next = box_page(i + 1);
      float ks = 0.f;
      float vs = 0.f;
      if (C::QUANT) {
        const int p = __shfl_sync(0xffffffffu, page, lane / box_rows);
        if (lane < n_rows) {
          ks = to_f(k_scale[p]) * sm_scale * LOG2E;
          vs = to_f(v_scale[p]);
        }
      }
      mbar_wait(empty + st, ((i / DEC_STAGES) & 1) ^ 1);
      if (C::QUANT && lane < n_rows) {
        scales[st * 64 + lane] = ks;
        scales[st * 64 + 32 + lane] = vs;
      }
      __syncwarp();
      if (lane == 0) mbar_expect_tx(full + st, 2u * nb * box_bytes);
      __syncwarp();
      unsigned char* dst = smem + st * DEC_STAGE_BYTES;
      for (int k = 0; k < nb; ++k) {
        const int p = __shfl_sync(0xffffffffu, page, k);
        const int row = p * ps + (t0 + k * box_rows) % ps;
        if (lane == 0) {
          tma_load_3d(dst + k * box_bytes, &kmap, full + st, 0, h0, row);
          tma_load_3d(dst + (n_box + k) * box_bytes, &vmap, full + st, 0, h0,
                      row);
        }
      }
      if (lane != 0) mbar_arrive(full + st);
      page = page_next;
    }
    return;
  }

  // Consumers: warp w takes head h0 + w (a warp past H only keeps the
  // barriers' counts); lane group grp takes rows grp + u·RPW of a stage.
  const int h = h0 + warp;
  const bool active = h < H;
  const int grp = lane / C::LPR;
  const int col0 = (lane % C::LPR) * C::VEC;
  float qv[C::VEC];
  if (active) {
    load_n<C::VEC>(q + ((size_t)it.b * H + h) * KD + col0, qv);
  } else {
#pragma unroll
    for (int e = 0; e < C::VEC; ++e) qv[e] = 0.f;
  }
  const float scale2 = sm_scale * LOG2E;  // scores in log2 units: exp2 below
  float m = NEG_INF;
  float l = 0.f;
  float acc[C::VEC];
#pragma unroll
  for (int e = 0; e < C::VEC; ++e) acc[e] = 0.f;

  const int head_off = warp * KD + col0;  // elements into a position
  for (int i = 0; i < it.n_steps; ++i) {
    const int st = i % DEC_STAGES;
    mbar_wait(full + st, (i / DEC_STAGES) & 1);
    if (active) {
      const int t0 = it.t_begin + i * C::R;
      const Tkv* ks = reinterpret_cast<const Tkv*>(smem + st * DEC_STAGE_BYTES);
      const Tkv* vs = ks + C::R * row_elems;
      const float* kscale = scales + st * 64;
      float sc[C::UNROLL];
      bool valid[C::UNROLL];
      float mx = m;
#pragma unroll
      for (int u = 0; u < C::UNROLL; ++u) {
        const int r = grp + u * C::RPW;
        valid[u] = t0 + r < it.t_end;
        float kf[C::VEC];
        load_row(ks + r * row_elems + head_off, kf);
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < C::VEC; ++e) d += qv[e] * kf[e];
#pragma unroll
        for (int o = C::LPR / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        // Rows past the length hold stale bytes: their scores are dropped.
        sc[u] = d * (C::QUANT ? kscale[r] : scale2);
        if (valid[u]) mx = fmaxf(mx, sc[u]);
      }
      const float corr = exp2_sfu(m - mx);
      l *= corr;
#pragma unroll
      for (int e = 0; e < C::VEC; ++e) acc[e] *= corr;
#pragma unroll
      for (int u = 0; u < C::UNROLL; ++u) {
        if (!valid[u]) continue;
        const int r = grp + u * C::RPW;
        const float p = exp2_sfu(sc[u] - mx);
        l += p;
        // float: V times p rounded to q's dtype, l the unrounded p; int8:
        // p times the page's V scale, not rounded.
        const float pv = C::QUANT ? p * kscale[32 + r] : round_to<Tq>(p);
        float vf[C::VEC];
        load_row(vs + r * row_elems + head_off, vf);
#pragma unroll
        for (int e = 0; e < C::VEC; ++e) acc[e] += pv * vf[e];
      }
      m = mx;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }

  // Merge the lane groups' states (lanes with the same columns).
#pragma unroll
  for (int o = C::LPR; o < 32; o <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    const float mn = fmaxf(m, m2);
    const float ca = exp2_sfu(m - mn);
    const float cb = exp2_sfu(m2 - mn);
    l = l * ca + l2 * cb;
#pragma unroll
    for (int e = 0; e < C::VEC; ++e) {
      const float a2 = __shfl_xor_sync(0xffffffffu, acc[e], o);
      acc[e] = acc[e] * ca + a2 * cb;
    }
    m = mn;
  }
  const size_t row = (size_t)it.b * H + h;
  if (it.n_parts == 1) {  // the slot's only split: the output itself
    if (active && grp == 0) {
      const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        out[row * KD + col0 + e] = from_f<Tq>(acc[e] * inv);
    }
    return;
  }

  // Split state [B·H rows][n_split][K acc, m, l]; the last of the slot's
  // n_parts splits to arrive merges them (a last-arriving-block merge: a
  // second kernel cost its launch and a serial read of the splits after
  // every block had finished, about 5 µs a call).
  constexpr int ST = KD + 2;
  if (active && grp == 0) {
    float* mine = ws + (row * n_split + it.s) * ST;
#pragma unroll
    for (int e = 0; e < C::VEC; ++e) mine[col0 + e] = acc[e];
    if (lane == 0) {
      mine[KD] = m;
      mine[KD + 1] = l;
    }
  }
  // The barrier orders every consumer's partial before thread 0's release
  // fence; the last block's acquire fence and barrier order the others'
  // before its reads (the pattern of CUTLASS's semaphores: one fence a
  // block, not one a thread).
  consumers_sync();
  if (threadIdx.x == 0) {
    int* count = counters + (size_t)it.b * n_groups + it.g;
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    last = atomicAdd(count, 1) == it.n_parts - 1;
    if (last) {
      *count = 0;  // zero again for the next launch
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    }
  }
  consumers_sync();
  if (!last || !active) return;
  // Warp `warp` merges its head in split order (the same bits whichever
  // block is last): the largest m first, then the weighted sums.
  const float* part = ws + row * n_split * ST;
  float mt = NEG_INF;
  for (int i = lane; i < it.n_parts; i += 32)
    mt = fmaxf(mt, __ldcg(part + (size_t)i * ST + KD));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
  float lt = 0.f;
  float at[KD / 32];
#pragma unroll
  for (int j = 0; j < KD / 32; ++j) at[j] = 0.f;
#pragma unroll 4
  for (int i = 0; i < it.n_parts; ++i) {
    const float* sp = part + (size_t)i * ST;
    const float w = exp2_sfu(__ldcg(sp + KD) - mt);
    lt += __ldcg(sp + KD + 1) * w;
#pragma unroll
    for (int j = 0; j < KD / 32; ++j)
      at[j] += __ldcg(sp + lane + 32 * j) * w;
  }
  const float inv = 1.f / (lt == 0.f ? 1.f : lt);
#pragma unroll
  for (int j = 0; j < KD / 32; ++j)
    out[row * KD + lane + 32 * j] = from_f<Tq>(at[j] * inv);
}

// What an entry point was given, for the launchers.
struct DecArgs {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const void* k_scale;
  const void* v_scale;
  const int* tables;
  const int* lengths;
  void* out;
  void* ws;
  int* counters;
  int B, H, K, ps, n_pg, n_pages, n_split;
  int n_sm;  // the card's SMs, set by check_splits
  float sm_scale;
  cudaStream_t stream;
};

// The tensor map of one plane of the layer, viewed as [n_pages·ps, H, K]
// (TMAP_WORDS numbers, as `encode_tmap` reads them), in boxes of box_rows
// positions of min(G, H) heads, unswizzled. Encoded here at every launch
// (about a microsecond on the host): the pool's address changes per layer.
cudaError_t decode_map(CUtensorMap* map, const void* plane, const DecArgs& a,
                       int item, int box_rows) {
  const long long rec[TMAP_WORDS] = {
      item, 3,
      a.K, a.H, (long long)a.n_pages * a.ps, 0, 0,
      (long long)a.K * item, (long long)a.H * a.K * item, 0, 0,
      a.K, a.H < DEC_GROUP ? a.H : DEC_GROUP, box_rows, 0, 0,
      0};
  return encode_tmap(map, plane, rec);
}

template <typename Tq, typename Tkv, int KD>
cudaError_t launch_decode_kd(const DecArgs& a) {
  using C = DecCfg<Tkv, KD>;
  static bool smem_set = false;  // the attribute is per kernel, set once
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<Tq, Tkv, KD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, DEC_SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int box_rows = std::gcd(a.ps, C::R);
  CUtensorMap km, vm;
  cudaError_t e = decode_map(&km, a.k_pool, a, sizeof(Tkv), box_rows);
  if (e == cudaSuccess) e = decode_map(&vm, a.v_pool, a, sizeof(Tkv), box_rows);
  if (e != cudaSuccess) return e;
  // The blocks with work number at most units + slots (each slot's share of
  // the wave rounded down, plus the slots that get a split though their
  // share is below one).
  const int units = a.B * ((a.H + DEC_GROUP - 1) / DEC_GROUP);
  const int slots = a.n_sm * DEC_BLOCKS_PER_SM;
  const int grid = min(units * a.n_split, units + slots);
  paged_decode_kernel<Tq, Tkv, KD>
      <<<grid, DEC_THREADS, DEC_SMEM, a.stream>>>(
          km, vm, static_cast<const Tq*>(a.q),
          static_cast<const __nv_bfloat16*>(a.k_scale),
          static_cast<const __nv_bfloat16*>(a.v_scale), a.tables, a.lengths,
          static_cast<Tq*>(a.out), static_cast<float*>(a.ws), a.counters,
          a.B, a.H, a.ps, a.n_pg, a.n_split, slots, box_rows, a.sm_scale);
  return cudaGetLastError();
}

template <typename Tq, typename Tkv>
cudaError_t launch_decode(const DecArgs& a) {
  switch (a.K) {
    case 64:
      return launch_decode_kd<Tq, Tkv, 64>(a);
    case 128:
      return launch_decode_kd<Tq, Tkv, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// The entry points' shared checks: n_split is the rule's for this card (the
// wrapper sized the workspace by it) and a workspace and counters come with
// n_split > 1.
cudaError_t check_splits(DecArgs& a) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&a.n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (a.n_split != decode_splits(a.B, a.H, a.n_pg, a.n_sm) ||
      (a.n_split > 1 && (a.ws == nullptr || a.counters == nullptr)))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace
}  // namespace rtt

// ws: the fp32 split workspace, n_split · B · H · (K + 2) floats, and
// counters: B · ceil(H / 4) ints, zero (the kernel leaves them zero), or
// both NULL when n_split == 1; n_split must equal `decode_splits` for this
// card. n_pages: the pool's pages (P + 1), the extent of its tensor maps.
extern "C" int rtt_paged_decode_attention(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lengths, void* out, void* ws,
    void* counters, int B, int H, int K, int ps, int n_pg, int n_pages,
    int n_split, float sm_scale, void* stream) {
  if (ps < 1 || n_pg < 1 || n_pages < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  rtt::DecArgs a{q, k_pool, v_pool, nullptr, nullptr,
                       static_cast<const int*>(tables),
                       static_cast<const int*>(lengths), out, ws,
                       static_cast<int*>(counters), B, H, K, ps, n_pg,
                       n_pages, n_split, 0, sm_scale,
                       static_cast<cudaStream_t>(stream)};
  cudaError_t e = rtt::check_splits(a);
  if (e != cudaSuccess) return (int)e;
  if (dtype == rtt::DTYPE_F32)
    e = rtt::launch_decode<float, float>(a);
  else if (dtype == rtt::DTYPE_BF16)
    e = rtt::launch_decode<__nv_bfloat16, __nv_bfloat16>(a);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

// The int8 program: int8 pools, the layer's bf16 per-page scale vectors
// [P+1]; q and out in fp32 or bf16 (dtype); the rest as above.
extern "C" int rtt_paged_decode_attention_int8(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, void* ws, void* counters, int B, int H,
    int K, int ps, int n_pg, int n_pages, int n_split, float sm_scale,
    void* stream) {
  if (ps < 1 || n_pg < 1 || n_pages < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  rtt::DecArgs a{q, k_pool, v_pool, k_scale, v_scale,
                       static_cast<const int*>(tables),
                       static_cast<const int*>(lengths), out, ws,
                       static_cast<int*>(counters), B, H, K, ps, n_pg,
                       n_pages, n_split, 0, sm_scale,
                       static_cast<cudaStream_t>(stream)};
  cudaError_t e = rtt::check_splits(a);
  if (e != cudaSuccess) return (int)e;
  if (dtype == rtt::DTYPE_F32)
    e = rtt::launch_decode<float, int8_t>(a);
  else if (dtype == rtt::DTYPE_BF16)
    e = rtt::launch_decode<__nv_bfloat16, int8_t>(a);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
