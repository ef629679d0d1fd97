// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel`
// (torchbooster_tpu/ops/paged_attention.py:70, called through
// `paged_attention` at :171). Same operands, same math:
//   q (slots, S, H, Dh) bf16|fp32, one layer's pool (P, ps, H_kv, Dh)
//   bf16|fp32 or int8 values + bf16 per-(token, head) scales, the
//   compacted live-page walk work_pages (W,), work_refs (W, lanes),
//   work_pos (W,), lengths (slots,), optional tree_vis (slots, S, S).
//   Returns (slots, S, H, Dh) in q's dtype.
//
// The TPU grid is ONE sequential walk carrying per-slot softmax state in
// scratch; on an H100 that would run the whole decode on one SM. Here
// the walk is split into two launches of fixed grid shape:
//
//   pass 1, grid (W, H_kv): one CTA per (work entry, kv head). It skips
//     padding entries (every lane -1), loads its page's K/V tile for its
//     kv head into shared memory ONCE (int8 dequantized in fp32 with the
//     per-(token, head) scale), then for every non-empty lane computes
//     the rep x S query rows' online-softmax partial (o, m, l) against
//     the page and writes it to a (W, lanes, H, S, .) fp32 buffer. A
//     prefix page shared by k slots is read from memory once for all k.
//   pass 2, grid (slots, H): merges every (entry, lane) partial whose
//     lane is that slot, normalizes by max(l, 1e-30), casts to q's dtype.
//
// What bounds it: decode attention reads each live K/V byte once and
// does ~4 flops per element, far below the card's ~295 flop/byte ridge,
// so the bound is memory bytes (live pages x page bytes). The design
// keeps the byte count at the live context (cached and free pages are
// never in the walk, shared pages are read once) and spreads it over
// W x H_kv CTAs. Dot products run on CUDA cores in fp32; tensor cores,
// TMA and split-K tuning are later work.
//
// The mask gates the PROBABILITIES, not just the scores: a fully masked
// lane contributes l = 0 (never page_size phantom tokens) and the merge
// of all-masked partials (every m = -1e30) yields 0, never NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kWarps * 32)
paged_partials(const QT* __restrict__ q, const KT* __restrict__ pool_k,
               const KT* __restrict__ pool_v,
               const __nv_bfloat16* __restrict__ scale_k,
               const __nv_bfloat16* __restrict__ scale_v,
               const int* __restrict__ work_pages,
               const int* __restrict__ work_refs,
               const int* __restrict__ work_pos,
               const int* __restrict__ lengths,
               const int* __restrict__ tree_vis,
               float* __restrict__ o_part, float* __restrict__ m_part,
               float* __restrict__ l_part, int s_q, int n_heads,
               int kv_heads, int head_dim, int page_size, int n_lanes,
               float sm_scale) {
  const int w = blockIdx.x;
  const int g = blockIdx.y;
  const int* refs = work_refs + static_cast<size_t>(w) * n_lanes;
  bool any = false;
  for (int i = 0; i < n_lanes; ++i) any |= refs[i] >= 0;
  if (!any) return;  // padding entry: nothing references it

  extern __shared__ float smem[];
  const int kstride = head_dim + 1;  // odd stride: per-token K rows hit distinct banks
  float* sk = smem;
  float* sv = sk + page_size * kstride;
  float* sq = sv + page_size * head_dim;
  float* sp = sq + kWarps * head_dim;

  const size_t page = static_cast<size_t>(work_pages[w]);
  for (int i = threadIdx.x; i < page_size * head_dim; i += blockDim.x) {
    const int t = i / head_dim;
    const int d = i - t * head_dim;
    const size_t row = (page * page_size + t) * kv_heads + g;
    float kf = to_f(pool_k[row * head_dim + d]);
    float vf = to_f(pool_v[row * head_dim + d]);
    if (scale_k != nullptr) {
      kf *= __bfloat162float(scale_k[row]);
      vf *= __bfloat162float(scale_v[row]);
    }
    sk[t * kstride + d] = kf;
    sv[t * head_dim + d] = vf;
  }
  __syncthreads();

  const int rep = n_heads / kv_heads;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows_per_lane = rep * s_q;
  const int n_rows = n_lanes * rows_per_lane;
  const int tok0 = work_pos[w] * page_size;
  float* my_q = sq + warp * head_dim;
  float* my_p = sp + warp * page_size;

  for (int row = warp; row < n_rows; row += kWarps) {
    const int rl = row / rows_per_lane;
    const int slot = refs[rl];
    if (slot < 0) continue;  // warp-uniform
    const int rr = row - rl * rows_per_lane;
    const int r = rr / s_q;
    const int j = rr - r * s_q;
    const int h = g * rep + r;  // query head h reads kv head h // rep
    const QT* qrow = q + ((static_cast<size_t>(slot) * s_q + j) * n_heads + h) * head_dim;
    for (int d = lane; d < head_dim; d += 32) my_q[d] = to_f(qrow[d]) * sm_scale;
    __syncwarp();

    const int len = lengths[slot];
    uint32_t visbits = 0;
    float mloc = kNegInf;
    int it = 0;
    for (int t = lane; t < page_size; t += 32, ++it) {
      const int pos = tok0 + t;
      bool vis;
      if (tree_vis != nullptr) {
        // tree verify: prior context always visible, draft offset
        // `off` only when node `off` is an ancestor-or-self of node j
        const int off = pos - len;
        vis = off <= 0 ||
              (off < s_q &&
               tree_vis[(static_cast<size_t>(slot) * s_q + j) * s_q + off] != 0);
      } else {
        vis = pos <= len + j;  // j = 0 is the decode mask
      }
      float s = kNegInf;
      if (vis) {
        const float* kr = sk + t * kstride;
        float acc = 0.f;
        for (int d = 0; d < head_dim; ++d) acc = fmaf(my_q[d], kr[d], acc);
        s = acc;
        visbits |= 1u << it;
      }
      my_p[t] = s;
      mloc = fmaxf(mloc, s);
    }
    const float m = warp_max(mloc);
    float lsum = 0.f;
    it = 0;
    for (int t = lane; t < page_size; t += 32, ++it) {
      const float p = ((visbits >> it) & 1u) ? expf(my_p[t] - m) : 0.f;
      my_p[t] = p;
      lsum += p;
    }
    const float l = warp_sum(lsum);
    __syncwarp();
    const size_t base = ((static_cast<size_t>(w) * n_lanes + rl) * n_heads + h) * s_q + j;
    for (int d = lane; d < head_dim; d += 32) {
      float acc = 0.f;
      for (int t = 0; t < page_size; ++t) acc = fmaf(my_p[t], sv[t * head_dim + d], acc);
      o_part[base * head_dim + d] = acc;
    }
    if (lane == 0) {
      m_part[base] = m;
      l_part[base] = l;
    }
    __syncwarp();
  }
}

template <typename QT>
__global__ void paged_merge(const int* __restrict__ work_refs,
                            const float* __restrict__ o_part,
                            const float* __restrict__ m_part,
                            const float* __restrict__ l_part,
                            QT* __restrict__ out, int n_entries, int s_q,
                            int n_heads, int head_dim) {
  const int slot = blockIdx.x;
  const int h = blockIdx.y;
  for (int j = 0; j < s_q; ++j) {
    for (int d = threadIdx.x; d < head_dim; d += blockDim.x) {
      float mx = kNegInf, lx = 0.f, ox = 0.f;
      for (int e = 0; e < n_entries; ++e) {
        if (work_refs[e] != slot) continue;
        const size_t base = (static_cast<size_t>(e) * n_heads + h) * s_q + j;
        const float mi = m_part[base];
        const float mn = fmaxf(mx, mi);
        const float a = expf(mx - mn);
        const float b = expf(mi - mn);
        lx = lx * a + l_part[base] * b;
        ox = ox * a + o_part[base * head_dim + d] * b;
        mx = mn;
      }
      out[((static_cast<size_t>(slot) * s_q + j) * n_heads + h) * head_dim + d] =
          from_f<QT>(ox / fmaxf(lx, 1e-30f));
    }
  }
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const void* sk, const void* sv, const int* wp,
                   const int* wr, const int* wpos, const int* lengths,
                   const int* tvis, void* out, float* o_part, float* m_part,
                   float* l_part, int n_slots, int s_q, int n_heads,
                   int kv_heads, int head_dim, int page_size, int n_w,
                   int n_lanes, float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(page_size) * (head_dim + 1) +
       static_cast<size_t>(page_size) * head_dim + kWarps * head_dim +
       kWarps * page_size);
  cudaError_t err;
  if (smem > 48 * 1024) {  // above 48 KB only after an explicit opt-in
    err = cudaFuncSetAttribute(paged_partials<QT, KT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  paged_partials<QT, KT><<<dim3(n_w, kv_heads), kWarps * 32, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(pk),
      static_cast<const KT*>(pv), static_cast<const __nv_bfloat16*>(sk),
      static_cast<const __nv_bfloat16*>(sv), wp, wr, wpos, lengths, tvis,
      o_part, m_part, l_part, s_q, n_heads, kv_heads, head_dim, page_size,
      n_lanes, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = head_dim < 128 ? ((head_dim + 31) / 32) * 32 : 128;
  paged_merge<QT><<<dim3(n_slots, n_heads), threads, 0, stream>>>(
      wr, o_part, m_part, l_part, static_cast<QT*>(out), n_w * n_lanes, s_q,
      n_heads, head_dim);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tb_paged_attention(
    int q_dtype, int kv_dtype, const void* q, const void* pool_k,
    const void* pool_v, const void* scale_k, const void* scale_v,
    const int* work_pages, const int* work_refs, const int* work_pos,
    const int* lengths, const int* tree_vis, void* out, float* o_part,
    float* m_part, float* l_part, int n_slots, int s_q, int n_heads,
    int kv_heads, int head_dim, int page_size, int n_w, int n_lanes,
    float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TB_ARGS q, pool_k, pool_v, scale_k, scale_v, work_pages, work_refs, \
    work_pos, lengths, tree_vis, out, o_part, m_part, l_part, n_slots, s_q,  \
    n_heads, kv_heads, head_dim, page_size, n_w, n_lanes, sm_scale, st
  if (q_dtype == kF32) {
    if (kv_dtype == kF32) return launch<float, float>(TB_ARGS);
    if (kv_dtype == kBF16) return launch<float, __nv_bfloat16>(TB_ARGS);
    if (kv_dtype == kI8) return launch<float, int8_t>(TB_ARGS);
  } else if (q_dtype == kBF16) {
    if (kv_dtype == kF32) return launch<__nv_bfloat16, float>(TB_ARGS);
    if (kv_dtype == kBF16) return launch<__nv_bfloat16, __nv_bfloat16>(TB_ARGS);
    if (kv_dtype == kI8) return launch<__nv_bfloat16, int8_t>(TB_ARGS);
  }
#undef TB_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
