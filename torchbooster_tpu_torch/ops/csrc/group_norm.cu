// GroupNorm(+ReLU) forward and backward over NHWC, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of torchbooster_tpu/ops/group_norm.py
// (bound together by the custom_vjp at :190-263), each as route "two_pass":
// fp32 and the shapes (C off the 16-byte vectors, over 2048 channels, a
// sample run too large for 8 CTAs) that `plan_gn_fwd` and `plan_gn_bwd`
// (ops/group_norm.py) do not send to the one-pass kernels of
// group_norm_fwd_sm90.cu and group_norm_bwd_sm90.cu:
//   B5 `_fwd_kernel` (:69, pallas_call :202)  -> gn_fwd
//   B6 `_bwd_kernel` (:106, pallas_call :236) -> gn_bwd
// Operands are the TPU kernels': x and dy (N, H*W, C) in bf16 or fp32, C
// innermost; scale and bias (C,) fp32 (the wrapper casts them); stats
// (N, 2, C) fp32 = per-channel group mean and 1/sqrt(var + eps); part
// (N, 2, C) fp32 = per-sample dscale and dbias partials, which the wrapper
// sums over N (as the JAX package does at :258).
//
// Numerics follow the TPU kernels: moments in fp32 as sums of x and x^2 per
// channel, combined per group, var = max(E[x^2] - E[x]^2, 0) (B5 clamps, the
// fused conv kernels of fused_block.cu do not); B6 recomputes the ReLU mask
// as xhat * scale + bias > 0 in fp32 and forms
//   dx = inv * (m dy scale - mean_g(m dy scale) - xhat mean_g(m dy scale xhat))
// with the two group means taken from the per-channel sums scale_c sum(m dy)
// and scale_c sum(m dy xhat).
//
// Design. The TPU kernel folds spatial positions into its 128-wide lane
// dimension (`_fold`, `_layout`) and walks H*W in fori_loop chunks. Neither
// carries over: here one CTA owns one sample and one block of channels that
// holds whole groups, and reads NHWC directly, neighbouring threads on
// neighbouring channels, 16 bytes per thread (8 bf16 or 4 fp32 channels). A
// loop over H*W takes the place of the chunked fori_loop. Two passes over
// the CTA's (H*W, cb) slab: moments (per-thread fp32 sums, reduced through
// shared memory in a fixed order, so runs repeat bit for bit), then the
// affine write (B5) or the dx write (B6).
//
// What bounds it: a normalisation does a handful of flops per element, far
// below the card's ~295 flop/byte ridge, so the bound is bytes: B5 reads x
// and writes y, B6 reads x and dy and writes dx. The second pass re-reads
// the slab, from the 50 MB L2 at best: nothing here holds it on chip. The
// one-pass kernels hold a sample's run in shared memory and read it once;
// these two-pass ones stay for the operands they do not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
enum DType { kF32 = 0, kBF16 = 1 };

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int kN = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int kN = 8; };

// VEC consecutive channels of element `i` (16 bytes when VEC is the full
// vector width, one element otherwise) as fp32
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(float (&out)[VEC], const T* __restrict__ p) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 2) out[0] = __bfloat162float(p[0]);
    else out[0] = p[0];
  } else {
    const int4 raw = *reinterpret_cast<const int4*>(p);
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
      }
    } else {
      const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = f[i];
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 2) p[0] = __float2bfloat16(v[0]);
    else p[0] = v[0];
  } else {
    int4 raw;
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    } else {
      float* f = reinterpret_cast<float*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = v[i];
    }
    *reinterpret_cast<int4*>(p) = raw;
  }
}

// Thread layout over a CTA's (hw, cb) slab: `lanes` threads side by side
// along the channels (VEC channels each), `rows` such groups along hw.
struct Slab {
  int lanes, rows, lane, row;
  bool active;
  __device__ Slab(int cb, int vec) {
    lanes = cb / vec;
    rows = max(1, kThreads / lanes);
    lane = threadIdx.x % lanes;
    row = threadIdx.x / lanes;
    active = row < rows && lanes <= kThreads;
  }
};

// Sum the per-thread partials `part[v]` (VEC channels of this thread) of
// every row group into smem[channel] in a fixed order, for two arrays at
// once. `red` holds rows * cb floats per array.
template <int VEC>
__device__ __forceinline__ void reduce_rows(const Slab& s, int cb, float* red,
                                            const float (&a)[VEC], const float (&b)[VEC],
                                            float* out_a, float* out_b) {
  if (s.active) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      red[s.row * cb + s.lane * VEC + v] = a[v];
      red[(s.rows + s.row) * cb + s.lane * VEC + v] = b[v];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cb; j += blockDim.x) {
    float sa = 0.f, sb = 0.f;
    for (int r = 0; r < s.rows; ++r) {
      sa += red[r * cb + j];
      sb += red[(s.rows + r) * cb + j];
    }
    out_a[j] = sa;
    out_b[j] = sb;
  }
  __syncthreads();
}

// B5: grid (C / cb, N). y = x * a + b per channel (a = inv * scale,
// b = bias - mean * a), then ReLU; stats[n] = (mean, inv) per channel.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_fwd(const T* __restrict__ x, const float* __restrict__ scale,
       const float* __restrict__ bias, T* __restrict__ y, float* __restrict__ stats,
       int hw, int c, int cb, int group_w, float eps, int relu) {
  extern __shared__ float smem[];
  const Slab s(cb, VEC);
  float* red = smem;                       // 2 * rows * cb
  float* sum1 = red + 2 * s.rows * cb;     // cb
  float* sum2 = sum1 + cb;                 // cb
  float* coef_a = sum2 + cb;               // cb
  float* coef_b = coef_a + cb;             // cb

  const int n = blockIdx.y;
  const int c0 = blockIdx.x * cb;
  const size_t base = static_cast<size_t>(n) * hw * c + c0;
  const int ch = s.lane * VEC;

  float s1[VEC], s2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) s1[v] = s2[v] = 0.f;
  if (s.active) {
    for (int p = s.row; p < hw; p += s.rows) {
      float xv[VEC];
      load_vec<T, VEC>(xv, x + base + static_cast<size_t>(p) * c + ch);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        s1[v] += xv[v];
        s2[v] = fmaf(xv[v], xv[v], s2[v]);
      }
    }
  }
  reduce_rows<VEC>(s, cb, red, s1, s2, sum1, sum2);

  const float inv_count = 1.f / static_cast<float>(hw * group_w);
  for (int j = threadIdx.x; j < cb; j += blockDim.x) {
    const int g0 = (j / group_w) * group_w;
    float g1 = 0.f, g2 = 0.f;
    for (int k = 0; k < group_w; ++k) {
      g1 += sum1[g0 + k];
      g2 += sum2[g0 + k];
    }
    const float mean = g1 * inv_count;
    const float var = fmaxf(g2 * inv_count - mean * mean, 0.f);
    const float inv = rsqrtf(var + eps);
    const float a = inv * scale[c0 + j];
    coef_a[j] = a;
    coef_b[j] = bias[c0 + j] - mean * a;
    float* st = stats + static_cast<size_t>(n) * 2 * c + c0 + j;
    st[0] = mean;
    st[c] = inv;
  }
  __syncthreads();

  if (!s.active) return;
  float a[VEC], b[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    a[v] = coef_a[ch + v];
    b[v] = coef_b[ch + v];
  }
  for (int p = s.row; p < hw; p += s.rows) {
    const size_t off = base + static_cast<size_t>(p) * c + ch;
    float xv[VEC];
    load_vec<T, VEC>(xv, x + off);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float out = fmaf(xv[v], a[v], b[v]);
      xv[v] = relu ? fmaxf(out, 0.f) : out;
    }
    store_vec<T, VEC>(y + off, xv);
  }
}

// B6: grid (C / cb, N). part[n] = (sum m dy xhat, sum m dy) per channel;
// dx = inv * (m dy scale - g1 - xhat g2).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_bwd(const T* __restrict__ x, const T* __restrict__ dy,
       const float* __restrict__ stats, const float* __restrict__ scale,
       const float* __restrict__ bias, T* __restrict__ dx, float* __restrict__ part,
       int hw, int c, int cb, int group_w, int relu) {
  extern __shared__ float smem[];
  const Slab s(cb, VEC);
  float* red = smem;
  float* sum_xh = red + 2 * s.rows * cb;   // cb: sum m dy xhat
  float* sum_dy = sum_xh + cb;             // cb: sum m dy
  float* g1s = sum_dy + cb;                // cb: group mean of m dy scale
  float* g2s = g1s + cb;                   // cb: group mean of m dy scale xhat

  const int n = blockIdx.y;
  const int c0 = blockIdx.x * cb;
  const size_t base = static_cast<size_t>(n) * hw * c + c0;
  const int ch = s.lane * VEC;
  const float* st = stats + static_cast<size_t>(n) * 2 * c + c0;

  float mean[VEC], inv[VEC], sc[VEC], bi[VEC];
  if (s.active) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      mean[v] = st[ch + v];
      inv[v] = st[c + ch + v];
      sc[v] = scale[c0 + ch + v];
      bi[v] = bias[c0 + ch + v];
    }
  }

  float pxh[VEC], pdy[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) pxh[v] = pdy[v] = 0.f;
  if (s.active) {
    for (int p = s.row; p < hw; p += s.rows) {
      const size_t off = base + static_cast<size_t>(p) * c + ch;
      float xv[VEC], gv[VEC];
      load_vec<T, VEC>(xv, x + off);
      load_vec<T, VEC>(gv, dy + off);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float xhat = (xv[v] - mean[v]) * inv[v];
        const float g = (relu && !(xhat * sc[v] + bi[v] > 0.f)) ? 0.f : gv[v];
        pxh[v] = fmaf(g, xhat, pxh[v]);
        pdy[v] += g;
      }
    }
  }
  reduce_rows<VEC>(s, cb, red, pxh, pdy, sum_xh, sum_dy);

  const float inv_count = 1.f / static_cast<float>(hw * group_w);
  for (int j = threadIdx.x; j < cb; j += blockDim.x) {
    const int g0 = (j / group_w) * group_w;
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < group_w; ++k) {
      const float sck = scale[c0 + g0 + k];
      t1 = fmaf(sck, sum_dy[g0 + k], t1);
      t2 = fmaf(sck, sum_xh[g0 + k], t2);
    }
    g1s[j] = t1 * inv_count;
    g2s[j] = t2 * inv_count;
    float* pp = part + static_cast<size_t>(n) * 2 * c + c0 + j;
    pp[0] = sum_xh[j];
    pp[c] = sum_dy[j];
  }
  __syncthreads();

  if (!s.active) return;
  float g1[VEC], g2[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    g1[v] = g1s[ch + v];
    g2[v] = g2s[ch + v];
  }
  for (int p = s.row; p < hw; p += s.rows) {
    const size_t off = base + static_cast<size_t>(p) * c + ch;
    float xv[VEC], gv[VEC];
    load_vec<T, VEC>(xv, x + off);
    load_vec<T, VEC>(gv, dy + off);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float xhat = (xv[v] - mean[v]) * inv[v];
      const float g = (relu && !(xhat * sc[v] + bi[v] > 0.f)) ? 0.f : gv[v];
      xv[v] = inv[v] * (g * sc[v] - g1[v] - xhat * g2[v]);
    }
    store_vec<T, VEC>(dx + off, xv);
  }
}

// Channel block: the fewest whole groups that reach min(C, 64) channels and
// divide C. Returns 0 when the block would need more than kThreads lanes.
int channel_block(int c, int groups, int vec) {
  const int group_w = c / groups;
  int k = ((c < 64 ? c : 64) + group_w - 1) / group_w;
  while (groups % k) ++k;
  const int cb = k * group_w;
  return cb / vec <= kThreads ? cb : 0;
}

size_t smem_bytes(int cb, int vec) {
  const int lanes = cb / vec;
  const int rows = lanes >= kThreads ? 1 : kThreads / lanes;
  return sizeof(float) * (2 * rows * cb + 4 * cb);
}

template <typename T>
int launch(bool fwd, const void* x, const void* dy, const float* stats_in,
           const float* scale, const float* bias, void* out, float* stats_out,
           int n, int hw, int c, int groups, float eps, int relu, cudaStream_t st) {
  constexpr int kVec = Vec<T>::kN;
  if (n <= 0 || hw <= 0 || c <= 0 || groups <= 0 || c % groups)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte vectors need C and the channel block to be multiples of the
  // vector width; other widths take the one-element route
  int cb = channel_block(c, groups, kVec);
  const bool vec = cb != 0 && c % kVec == 0 && cb % kVec == 0;
  if (!vec) cb = channel_block(c, groups, 1);
  if (cb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int group_w = c / groups;
  const dim3 grid(c / cb, n);
  const size_t smem = smem_bytes(cb, vec ? kVec : 1);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (fwd) {
    if (vec)
      gn_fwd<T, kVec><<<grid, kThreads, smem, st>>>(xt, scale, bias, ot, stats_out, hw, c,
                                                    cb, group_w, eps, relu);
    else
      gn_fwd<T, 1><<<grid, kThreads, smem, st>>>(xt, scale, bias, ot, stats_out, hw, c, cb,
                                                 group_w, eps, relu);
  } else {
    const T* dyt = static_cast<const T*>(dy);
    if (vec)
      gn_bwd<T, kVec><<<grid, kThreads, smem, st>>>(xt, dyt, stats_in, scale, bias, ot,
                                                    stats_out, hw, c, cb, group_w, relu);
    else
      gn_bwd<T, 1><<<grid, kThreads, smem, st>>>(xt, dyt, stats_in, scale, bias, ot,
                                                 stats_out, hw, c, cb, group_w, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plain C interface (loaded with ctypes). dtype: 0 fp32, 1 bf16; every
// pointer is a contiguous device buffer; returns the CUDA error code of the
// launch (0 on success); shapes the kernels do not take return
// cudaErrorInvalidValue without launching.
extern "C" int tb_gn_fwd(int dtype, const void* x, const float* scale,
                         const float* bias, void* y, float* stats, int n, int hw,
                         int c, int groups, float eps, int relu, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(true, x, nullptr, nullptr, scale, bias, y, stats, n, hw, c,
                         groups, eps, relu, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(true, x, nullptr, nullptr, scale, bias, y, stats, n,
                                 hw, c, groups, eps, relu, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tb_gn_bwd(int dtype, const void* x, const void* dy,
                         const float* stats, const float* scale, const float* bias,
                         void* dx, float* part, int n, int hw, int c, int groups,
                         int relu, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(false, x, dy, stats, scale, bias, dx, part, n, hw, c, groups,
                         0.f, relu, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(false, x, dy, stats, scale, bias, dx, part, n, hw, c,
                                 groups, 0.f, relu, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
