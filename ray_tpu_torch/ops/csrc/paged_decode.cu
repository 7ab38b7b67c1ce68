// Ragged paged-attention DECODE kernel for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/paged_attention.py, `_decode_kernel` (Pallas TPU
// kernel behind the wrapper `paged_attention`). Same function: each slot b
// has one query row q[b, h, :] per head and attends over the first
// lengths[b] positions of its pages, read in place from one layer's pool
// [P+1, ps, H, K] through the page table tables[b, :n_pg]. Online softmax
// (m, l, acc) in fp32, positions >= lengths[b] masked, pages at or past the
// length skipped, and l == 0 writes zeros. Output in q.dtype.
//
// What bounds it on the H100: bytes. Decode attention reads every live K
// and V row once and does about 2 FLOPs per byte read (K = 64, bf16), far
// below the ~295 FLOP/byte where the tensor cores would become the limit,
// so the floor is the live KV bytes over 3.35 TB/s.
//
// What the design does about it: each live K/V element is read from device
// memory exactly once, in 16-byte loads, with many loads in flight. One
// block of four warps per (head h, slot b). A row of K (K contiguous
// elements, 128 bytes at K = 64 bf16) is read by K / 8 adjacent lanes, so a
// warp covers several rows per load instruction, and each lane issues the K
// and V loads of DEC_UNROLL rows before it uses any of them. The block's
// rows are dealt to its warps in steps of (rows per warp) x DEC_UNROLL, so
// the warps walk the timeline independently: no barrier until the end,
// where the per-lane-group and per-warp (m, l, acc) states are merged
// (shuffles, then shared memory). Pages past the length are never touched;
// positions past it inside the last page are not loaded.
//
// The int8 program (paged_decode_i8_kernel; replaces the same Pallas kernel
// traced with quantized=True): int8 pages with one K and one V scale per
// page (the layer's scale vectors, indexed by the page id tables[b, j]).
// Same walk, same merge; what changes is the lane mapping and the scales.
// A 16-byte load now holds 16 codes, so a K = 64 row is 4 lanes, not 8, and
// the raw loads stay packed in registers until used. Both products run in
// fp32 FMAs, as the Pallas int8 program runs them on pages it dequantizes to
// fp32: the page's K scale multiplies each score (q·code·ks, exact up to
// fp32 reassociation), the V scale each probability (p·vs·code), and p is
// not rounded to q's dtype. It is bound by bytes too, now half of them.
//
// Next step (not in these kernels): at small batch B·H blocks do not fill
// the card's 132 SMs; split the page axis across blocks (split-K) and merge
// the per-split (m, l, acc) in a second pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace rtt {
namespace {

constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int DEC_UNROLL = 4;  // rows per lane group per step

// Merge the per-lane-group online-softmax states of a block (lanes with the
// same columns within each warp by shuffles, then the warps through shared
// memory) and write the row acc / l in T. A state that saw no valid row has
// m = NEG_INF, l = 0, acc = 0 and carries no weight once any state saw one.
template <typename T, int KD, int VEC, int LPR>
__device__ __forceinline__ void merge_store(float m, float l,
                                            float (&acc)[VEC], int lane,
                                            int warp, int grp, int col0,
                                            T* __restrict__ out_row) {
  __shared__ float red_m[DEC_WARPS];
  __shared__ float red_l[DEC_WARPS];
  __shared__ float red_acc[DEC_WARPS][KD];
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    const float mn = fmaxf(m, m2);
    const float ca = __expf(m - mn);
    const float cb = __expf(m2 - mn);
    l = l * ca + l2 * cb;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float a2 = __shfl_xor_sync(0xffffffffu, acc[i], o);
      acc[i] = acc[i] * ca + a2 * cb;
    }
    m = mn;
  }
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) red_acc[warp][col0 + i] = acc[i];
    if (lane == 0) {
      red_m[warp] = m;
      red_l[warp] = l;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < KD; k += DEC_THREADS) {
    float mt = NEG_INF;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mt = fmaxf(mt, red_m[w]);
    float lt = 0.f;
    float at = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float cw = __expf(red_m[w] - mt);
      lt += red_l[w] * cw;
      at += red_acc[w][k] * cw;
    }
    out_row[k] = from_f<T>(at / (lt == 0.f ? 1.f : lt));
  }
}

template <typename T, int KD>
__global__ void __launch_bounds__(DEC_THREADS)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int H, int ps, int n_pg, float sm_scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPR = KD / VEC;        // lanes per K/V row
  constexpr int RPW = 32 / LPR;        // rows a warp covers per load
  constexpr int STEP = RPW * DEC_UNROLL;
  static_assert(KD % VEC == 0 && LPR >= 1 && LPR <= 32 && 32 % LPR == 0,
                "head dim must split into 16-byte lanes of one warp");

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / LPR;  // which row of the warp's RPW this lane reads
  const int col0 = (lane % LPR) * VEC;
  const int len = lengths[b];
  const size_t row_stride = (size_t)H * KD;

  float qv[VEC];
  load16(q + ((size_t)b * H + h) * KD + col0, qv);

  // Pages holding at least one position < len; the rest of the table (the
  // null tail) does no work and reads nothing.
  int n_live = len > 0 ? (len + ps - 1) / ps : 0;
  if (n_live > n_pg) n_live = n_pg;
  const int steps_per_page = (ps + STEP - 1) / STEP;
  const int n_steps = n_live * steps_per_page;

  // This lane group's online-softmax state over the rows it reads.
  float m = NEG_INF;
  float l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  for (int c = warp; c < n_steps; c += DEC_WARPS) {  // warp-uniform loop
    const int j = c / steps_per_page;
    const int r0 = (c - j * steps_per_page) * STEP;
    const size_t page = (size_t)tables[(size_t)b * n_pg + j];
    const size_t base = page * ps * row_stride + (size_t)h * KD + col0;
    float kf[DEC_UNROLL][VEC];
    float vf[DEC_UNROLL][VEC];
    bool valid[DEC_UNROLL];
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      const int t = r0 + grp + u * RPW;
      valid[u] = t < ps && j * ps + t < len;
      if (valid[u]) {
        load16(k_pool + base + (size_t)t * row_stride, kf[u]);
        load16(v_pool + base + (size_t)t * row_stride, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
    float s[DEC_UNROLL];
    float mx = m;
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) d += qv[i] * kf[u][i];
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      s[u] = d * sm_scale;
      if (valid[u]) mx = fmaxf(mx, s[u]);
    }
    const float corr = __expf(m - mx);
    l *= corr;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      if (!valid[u]) continue;
      const float p = __expf(s[u] - mx);
      l += p;
      // The reference multiplies V by probabilities rounded to the input
      // dtype; the denominator sums them unrounded.
      const float pr = round_to<T>(p);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += pr * vf[u][i];
    }
    m = mx;
  }

  merge_store<T, KD, VEC, LPR>(m, l, acc, lane, warp, grp, col0,
                               out + ((size_t)b * H + h) * KD);
}

// The int8 program. Lane group grp reads row t of the page through LPR
// lanes of 16 codes each; kr / vr keep the raw loads of DEC_UNROLL rows.
template <typename T, int KD>
__global__ void __launch_bounds__(DEC_THREADS)
    paged_decode_i8_kernel(const T* __restrict__ q,
                           const int8_t* __restrict__ k_pool,
                           const int8_t* __restrict__ v_pool,
                           const __nv_bfloat16* __restrict__ k_scale,
                           const __nv_bfloat16* __restrict__ v_scale,
                           const int* __restrict__ tables,
                           const int* __restrict__ lengths,
                           T* __restrict__ out, int H, int ps, int n_pg,
                           float sm_scale) {
  constexpr int VEC = 16;              // codes per 16-byte load
  constexpr int LPR = KD / VEC;        // lanes per K/V row
  constexpr int RPW = 32 / LPR;        // rows a warp covers per load
  constexpr int STEP = RPW * DEC_UNROLL;
  static_assert(KD % VEC == 0 && LPR >= 1 && LPR <= 32 && 32 % LPR == 0,
                "head dim must split into 16-byte lanes of one warp");

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / LPR;
  const int col0 = (lane % LPR) * VEC;
  const int len = lengths[b];
  const size_t row_stride = (size_t)H * KD;

  float qv[VEC];
  load_n<VEC>(q + ((size_t)b * H + h) * KD + col0, qv);

  int n_live = len > 0 ? (len + ps - 1) / ps : 0;
  if (n_live > n_pg) n_live = n_pg;
  const int steps_per_page = (ps + STEP - 1) / STEP;
  const int n_steps = n_live * steps_per_page;

  float m = NEG_INF;
  float l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  for (int c = warp; c < n_steps; c += DEC_WARPS) {  // warp-uniform loop
    const int j = c / steps_per_page;
    const int r0 = (c - j * steps_per_page) * STEP;
    // The scales are indexed by the page id, never by the table position.
    const size_t page = (size_t)tables[(size_t)b * n_pg + j];
    const float ks = to_f(k_scale[page]) * sm_scale;
    const float vs = to_f(v_scale[page]);
    const size_t base = page * ps * row_stride + (size_t)h * KD + col0;
    uint4 kr[DEC_UNROLL];
    uint4 vr[DEC_UNROLL];
    bool valid[DEC_UNROLL];
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      const int t = r0 + grp + u * RPW;
      valid[u] = t < ps && j * ps + t < len;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (valid[u]) {
        kr[u] = *reinterpret_cast<const uint4*>(k_pool + base +
                                                (size_t)t * row_stride);
        vr[u] = *reinterpret_cast<const uint4*>(v_pool + base +
                                                (size_t)t * row_stride);
      }
    }
    float s[DEC_UNROLL];
    float mx = m;
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      float kf[VEC];
      unpack_i8x16(kr[u], kf);
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) d += qv[i] * kf[i];
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      s[u] = d * ks;
      if (valid[u]) mx = fmaxf(mx, s[u]);
    }
    const float corr = __expf(m - mx);
    l *= corr;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      if (!valid[u]) continue;
      const float p = __expf(s[u] - mx);
      l += p;
      const float pv = p * vs;  // not rounded: the Pallas int8 program's p
      float vf[VEC];
      unpack_i8x16(vr[u], vf);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += pv * vf[i];
    }
    m = mx;
  }

  merge_store<T, KD, VEC, LPR>(m, l, acc, lane, warp, grp, col0,
                               out + ((size_t)b * H + h) * KD);
}

template <typename T, int KD>
cudaError_t launch_decode_kd(const void* q, const void* k_pool,
                             const void* v_pool, const int* tables,
                             const int* lengths, void* out, int B, int H,
                             int ps, int n_pg, float sm_scale,
                             cudaStream_t stream) {
  dim3 grid(H, B);
  paged_decode_kernel<T, KD><<<grid, DEC_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, lengths, static_cast<T*>(out), H,
      ps, n_pg, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode(const void* q, const void* k_pool,
                          const void* v_pool, const int* tables,
                          const int* lengths, void* out, int B, int H, int K,
                          int ps, int n_pg, float sm_scale,
                          cudaStream_t stream) {
  switch (K) {
    case 64:
      return launch_decode_kd<T, 64>(q, k_pool, v_pool, tables, lengths, out,
                                     B, H, ps, n_pg, sm_scale, stream);
    case 128:
      return launch_decode_kd<T, 128>(q, k_pool, v_pool, tables, lengths,
                                      out, B, H, ps, n_pg, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int KD>
cudaError_t launch_decode_i8_kd(const void* q, const void* k_pool,
                                const void* v_pool, const void* k_scale,
                                const void* v_scale, const int* tables,
                                const int* lengths,
                                void* out, int B, int H, int ps, int n_pg,
                                float sm_scale, cudaStream_t stream) {
  dim3 grid(H, B);
  paged_decode_i8_kernel<T, KD><<<grid, DEC_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k_pool),
      static_cast<const int8_t*>(v_pool),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), tables, lengths,
      static_cast<T*>(out), H, ps, n_pg, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode_i8(const void* q, const void* k_pool,
                             const void* v_pool, const void* k_scale,
                             const void* v_scale, const int* tables,
                             const int* lengths, void* out,
                             int B, int H, int K, int ps, int n_pg,
                             float sm_scale, cudaStream_t stream) {
  switch (K) {
    case 64:
      return launch_decode_i8_kd<T, 64>(q, k_pool, v_pool, k_scale, v_scale,
                                        tables, lengths, out, B, H, ps, n_pg,
                                        sm_scale, stream);
    case 128:
      return launch_decode_i8_kd<T, 128>(q, k_pool, v_pool, k_scale,
                                         v_scale, tables, lengths, out, B, H,
                                         ps, n_pg, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace rtt

extern "C" int rtt_paged_decode_attention(int dtype, const void* q,
                                          const void* k_pool,
                                          const void* v_pool,
                                          const void* tables,
                                          const void* lengths, void* out,
                                          int B, int H, int K, int ps,
                                          int n_pg, float sm_scale,
                                          void* stream) {
  if (ps < 1 || n_pg < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  const int* tbl = static_cast<const int*>(tables);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == rtt::DTYPE_F32)
    e = rtt::launch_decode<float>(q, k_pool, v_pool, tbl, lens, out, B, H, K,
                                  ps, n_pg, sm_scale, s);
  else if (dtype == rtt::DTYPE_BF16)
    e = rtt::launch_decode<__nv_bfloat16>(q, k_pool, v_pool, tbl, lens, out,
                                          B, H, K, ps, n_pg, sm_scale, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

// The int8 program: int8 pools, the layer's bf16 per-page scale vectors
// [P+1]; q and out in fp32 or bf16 (dtype).
extern "C" int rtt_paged_decode_attention_int8(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale,
    const void* tables, const void* lengths, void* out, int B, int H, int K,
    int ps, int n_pg, float sm_scale, void* stream) {
  if (ps < 1 || n_pg < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  const int* tbl = static_cast<const int*>(tables);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == rtt::DTYPE_F32)
    e = rtt::launch_decode_i8<float>(q, k_pool, v_pool, k_scale, v_scale,
                                     tbl, lens, out, B, H, K, ps, n_pg,
                                     sm_scale, s);
  else if (dtype == rtt::DTYPE_BF16)
    e = rtt::launch_decode_i8<__nv_bfloat16>(q, k_pool, v_pool, k_scale,
                                             v_scale, tbl, lens, out, B, H, K,
                                             ps, n_pg, sm_scale, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
