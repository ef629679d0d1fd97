// Fused convolution + GroupNorm (+ReLU), forward, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of torchbooster_tpu/ops/fused_block.py:
//   B7 `_fwd_kernel`  (:70, pallas_call :139)  1x1 conv + GN + ReLU, any
//      stride (the strided slice of :391-392 becomes strided addressing)
//   B8 `_fwd3_kernel` (:238, pallas_call :319) 3x3 conv, stride 1, padding
//      1, + GN + ReLU
// for fp32, and for the bf16 shapes that `plan_conv1x1` / `plan_conv3x3`
// (ops/fused_block.py) send to the "mma_sync" route (Cin or Cout off the
// multiples of 8, a sample over 1024 output positions); the other bf16
// shapes run the one-pass wgmma kernel of conv_gn_sm90.cuh (entry points in
// conv1x1_gn_sm90.cu and conv3x3_gn_sm90.cu).
// Both are one implicit GEMM here: out[b, m, n] = sum over taps (ky, kx) and
// input channels k of x[b, ih, iw, k] * w[ky, kx, k, n], with ih = oh *
// stride + ky - pad and iw = ow * stride + kx - pad (zero outside the image:
// the tap coordinates are computed and masked at the border, in place of the
// TPU's padded copy shifted along the flattened rows with column masks).
// Operands: x (B, H, W, Cin) and the weight in the dtype of x (bf16 or
// fp32), the weight handed over as wt (taps, Cout, Cin) so that a tile of it
// loads with Cin contiguous; scale and bias (Cout,) fp32; out (B, Ho, Wo,
// Cout) in the dtype of x; mu and rstd (B, Cout) fp32, the per-channel group
// mean and 1/sqrt(var + eps) that B7's backward reads.
//
// Numerics follow the TPU kernels: products accumulate in fp32 and the
// moments are taken from the fp32 accumulator y (never from a rounded y);
// group moments are NOT clamped (var = E[y^2] - E[y]^2, :84 and :273),
// unlike the standalone GroupNorm of group_norm.cu; out = y * a + b with
// a = rstd * scale and b = bias - mean * a, then ReLU.
//
// Design. On the TPU a whole sample's (M, Cout) fp32 y lives in VMEM (up to
// 12 MiB; `_samples_per_cell` plans the grid around it). A CTA here has at
// most 227 KB, so the group moments need a reduction across CTAs. y is kept
// out of device memory, as on the TPU, at the price of computing the product
// twice:
//   pass 1, grid (M tiles, Cout tiles, B): the tiled product, whose epilogue
//     writes only per-tile fp32 channel sums of y and y^2 (part);
//   moments, grid (B): part -> per-(sample, group) mean and rstd, summed in a
//     fixed order with no atomics, so runs repeat bit for bit;
//   pass 2, the same grid: the product again, with the normalise + ReLU
//     epilogue, writes out.
// The trade: pass 1 adds 2 M Cout K flops per sample (K = taps Cin) and a
// re-read of x and w; storing y instead would add a write and a read of the
// fp32 (M, Cout) y, 8 bytes per output element against the 2 of bf16 out.
// For ResNet-18's first stage at batch 512 (M = 1024, Cout = 64, K = 576)
// that is 38.7 GFLOP recomputed against 268 MB not moved: 39 us at the bf16
// tensor-core peak against 80 us at the HBM rate, so at peak the recompute
// is the cheaper side. These kernels run far below that peak (measured on
// an H100 SXM: about 75 TFLOP/s over both passes, chip_smoke.py phase
// conv), where storing y would be the faster design; the recompute keeps
// the TPU kernel's property (only out leaves the chip) and is the version
// to beat.
//
// Two routes of the same algorithm, chosen by dtype. bf16 runs conv_mma:
// tensor cores, mma.sync m16n8k16 with fp32 accumulators, 4 warps, a
// (16 WM) x 64 tile (WM = 1, 2 or 4 by the number of output positions per
// sample, so a 4 x 4 feature map is not padded to 64 rows), K in steps of
// 32, operands in shared memory with rows padded by 8 elements (the fragment
// loads hit 32 distinct banks). fp32 runs conv_f32: CUDA-core fp32 products,
// 256 threads, a 64 x 64 tile of 4 x 4 blocks, so fp32 inputs stay within
// 1e-4 of the plain version.
//
// What bounds it: at ResNet shapes the product is 2 M Cout K flops against
// bytes of order M (Cin + Cout), above the ~295 flop/byte ridge for K in the
// hundreds, so the bound is operations at the bf16 tensor-core rate (the
// bound counts the product once, not the recompute). Neither route reaches
// it: tiles load with plain 16-byte loads, wait for every load before
// computing (no cp.async or TMA pipeline), and the product runs twice. With
// 16-row tiles (WM = 1, the 4 x 4 maps) each warp does only four mma per
// shared-memory round trip, and every sample re-reads the whole weight, so
// that case runs at under half the others' rate. conv_gn_sm90.cuh takes
// those steps for the bf16 shapes it runs (one pass, packed samples, a
// cp.async ring, wgmma).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
enum DType { kF32 = 0, kBF16 = 1 };

struct Conv {
  int h, w, cin, ho, wo, cout, ks, stride, pad, m;  // m = ho * wo
};

// the input element offset (within one sample) of output row m at tap
// (ky, kx), or -1 where the tap falls outside the image or m is past the
// last output position
__device__ __forceinline__ long long tap_offset(const Conv& g, int m, int ky, int kx) {
  if (m >= g.m) return -1;
  const int oh = m / g.wo;
  const int ow = m - oh * g.wo;
  const int ih = oh * g.stride + ky - g.pad;
  const int iw = ow * g.stride + kx - g.pad;
  if (ih < 0 || ih >= g.h || iw < 0 || iw >= g.w) return -1;
  return (static_cast<long long>(ih) * g.w + iw) * g.cin;
}

// ------------------------------------------------------------------------
// bf16 route: tensor cores
// ------------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kThreadsMma = 32 * kWarps;
constexpr int kBN = 64;          // output channels per tile
constexpr int kBK = 32;          // reduction depth per step
constexpr int kLd = kBK + 8;     // shared row stride (bf16 elements)

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 x 16, row-major, `base` at (row 0, k 0))
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* base) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  a[0] = ld32(base + g * kLd + 2 * t);
  a[1] = ld32(base + (g + 8) * kLd + 2 * t);
  a[2] = ld32(base + g * kLd + 2 * t + 8);
  a[3] = ld32(base + (g + 8) * kLd + 2 * t + 8);
}

// B fragment (16 x 8, k x n) from rows of n with k contiguous
__device__ __forceinline__ void frag_b(uint32_t b[2], const bf16* base) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  b[0] = ld32(base + g * kLd + 2 * t);
  b[1] = ld32(base + g * kLd + 2 * t + 8);
}

// One tile of the product into acc; tiles of x (BM rows) and wt (kBN rows)
// pass through shared memory kBK input channels at a time. `vec`: Cin is a
// multiple of 8, so each row's chunk loads as 16-byte vectors.
template <int WM>
__device__ __forceinline__ void mma_tile(float (&acc)[(kBN / (4 / WM)) / 8][4],
                                         bf16* sa, bf16* sb, const bf16* __restrict__ xb,
                                         const bf16* __restrict__ wt, const Conv& g,
                                         int m0, int n0, bool vec) {
  constexpr int BM = 16 * WM, WN = kWarps / WM, WCOLS = kBN / WN, NF = WCOLS / 8;
  const int warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  constexpr int kChunks = kBK / 8;
  const bf16 zero = __float2bfloat16(0.f);
  for (int tap = 0; tap < g.ks * g.ks; ++tap) {
    const int ky = tap / g.ks, kx = tap - (tap / g.ks) * g.ks;
    const bf16* wtap = wt + static_cast<size_t>(tap) * g.cout * g.cin;
    for (int k0 = 0; k0 < g.cin; k0 += kBK) {
      __syncthreads();  // the previous step's readers of sa/sb are done
      if (vec) {
        for (int i = threadIdx.x; i < BM * kChunks; i += kThreadsMma) {
          const int r = i / kChunks, kc = (i - r * kChunks) * 8;
          int4 v = make_int4(0, 0, 0, 0);
          const long long off = tap_offset(g, m0 + r, ky, kx);
          if (off >= 0 && k0 + kc < g.cin)
            v = *reinterpret_cast<const int4*>(xb + off + k0 + kc);
          *reinterpret_cast<int4*>(sa + r * kLd + kc) = v;
        }
        for (int i = threadIdx.x; i < kBN * kChunks; i += kThreadsMma) {
          const int r = i / kChunks, kc = (i - r * kChunks) * 8;
          int4 v = make_int4(0, 0, 0, 0);
          if (n0 + r < g.cout && k0 + kc < g.cin)
            v = *reinterpret_cast<const int4*>(wtap + static_cast<size_t>(n0 + r) * g.cin +
                                               k0 + kc);
          *reinterpret_cast<int4*>(sb + r * kLd + kc) = v;
        }
      } else {
        for (int i = threadIdx.x; i < BM * kBK; i += kThreadsMma) {
          const int r = i / kBK, k = i - r * kBK;
          const long long off = tap_offset(g, m0 + r, ky, kx);
          sa[r * kLd + k] = (off >= 0 && k0 + k < g.cin) ? xb[off + k0 + k] : zero;
        }
        for (int i = threadIdx.x; i < kBN * kBK; i += kThreadsMma) {
          const int r = i / kBK, k = i - r * kBK;
          sb[r * kLd + k] = (n0 + r < g.cout && k0 + k < g.cin)
                                ? wtap[static_cast<size_t>(n0 + r) * g.cin + k0 + k]
                                : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t a[4];
        frag_a(a, sa + wm * 16 * kLd + ks * 16);
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          uint32_t b[2];
          frag_b(b, sb + (wn * WCOLS + nf * 8) * kLd + ks * 16);
          mma16816(acc[nf], a, b);
        }
      }
    }
  }
}

// NORM = false: pass 1 (per-tile channel sums of y and y^2 into part);
// NORM = true: pass 2 (normalise, ReLU, write out).
// grid (M tiles, Cout tiles, B); part (B, M tiles, 2, Cout).
template <int WM, bool NORM>
__global__ void __launch_bounds__(kThreadsMma)
conv_mma(const bf16* __restrict__ x, const bf16* __restrict__ wt,
         const float* __restrict__ scale, const float* __restrict__ bias,
         const float* __restrict__ mu, const float* __restrict__ rstd,
         bf16* __restrict__ out, float* __restrict__ part, Conv g, int relu, int vec) {
  constexpr int BM = 16 * WM, WN = kWarps / WM, WCOLS = kBN / WN, NF = WCOLS / 8;
  __shared__ __align__(16) bf16 sa[BM * kLd];
  __shared__ __align__(16) bf16 sb[kBN * kLd];
  __shared__ float red[2][WM][kBN];

  const int mt = blockIdx.x, b = blockIdx.z;
  const int m0 = mt * BM, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;

  float acc[NF][4];
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) acc[nf][0] = acc[nf][1] = acc[nf][2] = acc[nf][3] = 0.f;
  mma_tile<WM>(acc, sa, sb, x + static_cast<size_t>(b) * g.h * g.w * g.cin, wt, g, m0,
               n0, vec != 0);

  if constexpr (!NORM) {
    // rows past M and taps past the border loaded as zeros: they add 0
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float v0 = acc[nf][j], v1 = acc[nf][j + 2];
        float s1 = v0 + v1, s2 = fmaf(v0, v0, v1 * v1);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        if (gq == 0) {
          const int col = wn * WCOLS + nf * 8 + 2 * t + j;
          red[0][wm][col] = s1;
          red[1][wm][col] = s2;
        }
      }
    __syncthreads();
    for (int col = threadIdx.x; col < kBN; col += kThreadsMma) {
      const int n = n0 + col;
      if (n >= g.cout) continue;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int w = 0; w < WM; ++w) {
        s1 += red[0][w][col];
        s2 += red[1][w][col];
      }
      float* p = part + (static_cast<size_t>(b) * gridDim.x + mt) * 2 * g.cout + n;
      p[0] = s1;
      p[g.cout] = s2;
    }
  } else {
    const float* mub = mu + static_cast<size_t>(b) * g.cout;
    const float* rsb = rstd + static_cast<size_t>(b) * g.cout;
    bf16* ob = out + static_cast<size_t>(b) * g.m * g.cout;
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      const int col = n0 + wn * WCOLS + nf * 8 + 2 * t;
      float a[2] = {0.f, 0.f}, c[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (col + j < g.cout) {
          a[j] = rsb[col + j] * scale[col + j];
          c[j] = bias[col + j] - mub[col + j] * a[j];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 16 + gq + 8 * h;
        if (m >= g.m) continue;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float y = fmaf(acc[nf][2 * h + j], a[j], c[j]);
          v[j] = relu ? fmaxf(y, 0.f) : y;
        }
        bf16* dst = ob + static_cast<size_t>(m) * g.cout + col;
        if (col + 1 < g.cout && (g.cout & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v[0], v[1]);
        } else {
          if (col < g.cout) dst[0] = __float2bfloat16(v[0]);
          if (col + 1 < g.cout) dst[1] = __float2bfloat16(v[1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------------
// fp32 route: CUDA-core products
// ------------------------------------------------------------------------
constexpr int kThreadsF = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

template <bool NORM>
__global__ void __launch_bounds__(kThreadsF)
conv_f32(const float* __restrict__ x, const float* __restrict__ wt,
         const float* __restrict__ scale, const float* __restrict__ bias,
         const float* __restrict__ mu, const float* __restrict__ rstd,
         float* __restrict__ out, float* __restrict__ part, Conv g, int relu) {
  __shared__ float sa[kFBK][kFBM + 4];
  __shared__ float sb[kFBK][kFBN + 4];
  __shared__ float red[2][16][kFBN];

  const int mt = blockIdx.x, b = blockIdx.z;
  const int m0 = mt * kFBM, n0 = blockIdx.y * kFBN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* xb = x + static_cast<size_t>(b) * g.h * g.w * g.cin;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < g.ks * g.ks; ++tap) {
    const int ky = tap / g.ks, kx = tap - (tap / g.ks) * g.ks;
    const float* wtap = wt + static_cast<size_t>(tap) * g.cout * g.cin;
    for (int k0 = 0; k0 < g.cin; k0 += kFBK) {
      __syncthreads();
      for (int i = threadIdx.x; i < kFBM * kFBK; i += kThreadsF) {
        const int r = i / kFBK, k = i - r * kFBK;
        const long long off = tap_offset(g, m0 + r, ky, kx);
        sa[k][r] = (off >= 0 && k0 + k < g.cin) ? xb[off + k0 + k] : 0.f;
      }
      for (int i = threadIdx.x; i < kFBN * kFBK; i += kThreadsF) {
        const int r = i / kFBK, k = i - r * kFBK;
        sb[k][r] = (n0 + r < g.cout && k0 + k < g.cin)
                       ? wtap[static_cast<size_t>(n0 + r) * g.cin + k0 + k]
                       : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kFBK; ++k) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sa[k][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sb[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
  }

  if constexpr (!NORM) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s1 += acc[i][j];
        s2 = fmaf(acc[i][j], acc[i][j], s2);
      }
      red[0][ty][tx + 16 * j] = s1;
      red[1][ty][tx + 16 * j] = s2;
    }
    __syncthreads();
    for (int col = threadIdx.x; col < kFBN; col += kThreadsF) {
      const int n = n0 + col;
      if (n >= g.cout) continue;
      float s1 = 0.f, s2 = 0.f;
      for (int r = 0; r < 16; ++r) {
        s1 += red[0][r][col];
        s2 += red[1][r][col];
      }
      float* p = part + (static_cast<size_t>(b) * gridDim.x + mt) * 2 * g.cout + n;
      p[0] = s1;
      p[g.cout] = s2;
    }
  } else {
    const float* mub = mu + static_cast<size_t>(b) * g.cout;
    const float* rsb = rstd + static_cast<size_t>(b) * g.cout;
    float* ob = out + static_cast<size_t>(b) * g.m * g.cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= g.cout) continue;
      const float a = rsb[n] * scale[n];
      const float c = bias[n] - mub[n] * a;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty * 4 + i;
        if (m >= g.m) continue;
        const float y = fmaf(acc[i][j], a, c);
        ob[static_cast<size_t>(m) * g.cout + n] = relu ? fmaxf(y, 0.f) : y;
      }
    }
  }
}

// ------------------------------------------------------------------------
// group moments: part (B, M tiles, 2, Cout) -> mu, rstd (B, Cout)
// ------------------------------------------------------------------------
constexpr int kThreadsMoments = 256;

__global__ void __launch_bounds__(kThreadsMoments)
group_moments(const float* __restrict__ part, float* __restrict__ mu,
              float* __restrict__ rstd, int n_mt, int cout, int group_w,
              float inv_count, float eps) {
  extern __shared__ float sums[];  // 2 * cout
  const int b = blockIdx.x;
  const float* pb = part + static_cast<size_t>(b) * n_mt * 2 * cout;
  for (int c = threadIdx.x; c < cout; c += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int mt = 0; mt < n_mt; ++mt) {
      s1 += pb[static_cast<size_t>(mt) * 2 * cout + c];
      s2 += pb[(static_cast<size_t>(mt) * 2 + 1) * cout + c];
    }
    sums[c] = s1;
    sums[cout + c] = s2;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cout; c += blockDim.x) {
    const int g0 = (c / group_w) * group_w;
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < group_w; ++k) {
      s1 += sums[g0 + k];
      s2 += sums[cout + g0 + k];
    }
    const float mean = s1 * inv_count;
    const float var = s2 * inv_count - mean * mean;
    mu[static_cast<size_t>(b) * cout + c] = mean;
    rstd[static_cast<size_t>(b) * cout + c] = rsqrtf(var + eps);
  }
}

// rows of a bf16 tile: 16, 32 or 64 by the output positions per sample, so
// that small feature maps (4 x 4 = 16 at ResNet-18's last stage) do not pad
// a 64-row tile
int mma_wm(int m) { return m <= 16 ? 1 : (m <= 32 ? 2 : 4); }

int m_tiles(int dtype, int m) {
  const int bm = dtype == kF32 ? kFBM : 16 * mma_wm(m);
  return (m + bm - 1) / bm;
}

template <int WM>
cudaError_t launch_mma(const void* x, const void* wt, const float* scale,
                       const float* bias, void* out, float* mu, float* rstd,
                       float* part, const Conv& g, int b, int relu, int vec,
                       int groups, float eps, cudaStream_t st) {
  const dim3 grid((g.m + 16 * WM - 1) / (16 * WM), (g.cout + kBN - 1) / kBN, b);
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* wtt = static_cast<const bf16*>(wt);
  conv_mma<WM, false><<<grid, kThreadsMma, 0, st>>>(xt, wtt, scale, bias, mu, rstd,
                                                    nullptr, part, g, relu, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int group_w = g.cout / groups;
  group_moments<<<b, kThreadsMoments, 2 * g.cout * sizeof(float), st>>>(
      part, mu, rstd, grid.x, g.cout, group_w,
      1.f / static_cast<float>(g.m * group_w), eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  conv_mma<WM, true><<<grid, kThreadsMma, 0, st>>>(xt, wtt, scale, bias, mu, rstd,
                                                   static_cast<bf16*>(out), part, g,
                                                   relu, vec);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const void* wt, const float* scale,
                       const float* bias, void* out, float* mu, float* rstd,
                       float* part, const Conv& g, int b, int relu, int groups,
                       float eps, cudaStream_t st) {
  const dim3 grid((g.m + kFBM - 1) / kFBM, (g.cout + kFBN - 1) / kFBN, b);
  const float* xt = static_cast<const float*>(x);
  const float* wtt = static_cast<const float*>(wt);
  conv_f32<false><<<grid, kThreadsF, 0, st>>>(xt, wtt, scale, bias, mu, rstd, nullptr,
                                              part, g, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int group_w = g.cout / groups;
  group_moments<<<b, kThreadsMoments, 2 * g.cout * sizeof(float), st>>>(
      part, mu, rstd, grid.x, g.cout, group_w,
      1.f / static_cast<float>(g.m * group_w), eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  conv_f32<true><<<grid, kThreadsF, 0, st>>>(xt, wtt, scale, bias, mu, rstd,
                                             static_cast<float*>(out), part, g, relu);
  return cudaGetLastError();
}

}  // namespace

// The plain C interface (loaded with ctypes). dtype: 0 fp32, 1 bf16.
//
// tb_conv_gn_tiles: the number of M tiles per sample the kernels use for
// `m` output positions, which sizes the caller's part buffer.
extern "C" int tb_conv_gn_tiles(int dtype, int m) { return m_tiles(dtype, m); }

// tb_conv_gn: out = relu(group_norm(conv(x, w))) with the weight as wt
// (ks * ks, cout, cin); every pointer a contiguous device buffer, part
// (b, tb_conv_gn_tiles(dtype, ho * wo), 2, cout) fp32 scratch. Returns the
// CUDA error code of the launches (0 on success); shapes the kernels do not
// take return cudaErrorInvalidValue without launching.
extern "C" int tb_conv_gn(int dtype, const void* x, const void* wt,
                          const float* scale, const float* bias, void* out,
                          float* mu, float* rstd, float* part, int b, int h,
                          int w, int cin, int cout, int ks, int stride, int pad,
                          int groups, float eps, int relu, void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || ks <= 0 ||
      stride <= 0 || pad < 0 || groups <= 0 || cout % groups ||
      2 * cout * sizeof(float) > 48 * 1024 || (cout + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Conv g;
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.cout = cout;
  g.ks = ks;
  g.stride = stride;
  g.pad = pad;
  g.ho = (h + 2 * pad - ks) / stride + 1;
  g.wo = (w + 2 * pad - ks) / stride + 1;
  if (g.ho <= 0 || g.wo <= 0) return static_cast<int>(cudaErrorInvalidValue);
  g.m = g.ho * g.wo;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return static_cast<int>(
        launch_f32(x, wt, scale, bias, out, mu, rstd, part, g, b, relu, groups, eps, st));
  if (dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = cin % 8 == 0;
  switch (mma_wm(g.m)) {
    case 1:
      return static_cast<int>(launch_mma<1>(x, wt, scale, bias, out, mu, rstd, part, g,
                                            b, relu, vec, groups, eps, st));
    case 2:
      return static_cast<int>(launch_mma<2>(x, wt, scale, bias, out, mu, rstd, part, g,
                                            b, relu, vec, groups, eps, st));
    default:
      return static_cast<int>(launch_mma<4>(x, wt, scale, bias, out, mu, rstd, part, g,
                                            b, relu, vec, groups, eps, st));
  }
}
