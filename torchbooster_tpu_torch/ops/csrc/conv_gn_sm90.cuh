// The one-pass convolution + GroupNorm (+ReLU) forward for Hopper (sm_90a),
// shared by B8 (conv3x3_gn_sm90.cu: 3x3, stride 1, padding 1) and B7
// (conv1x1_gn_sm90.cu: 1x1 at any stride). One template, `conv_gn_sm90<KS,
// BN>`, with the kernel size KS as its parameter: the K loop runs over KS^2
// taps times Cin, and output row (b, oh, ow) reads input pixel (b, oh s + ky
// - pad, ow s + kx - pad) at tap (ky, kx), zero outside the image. The
// input map (H, W) is kept apart from the output map (Ho, Wo).
//
// It computes what the two-pass kernels of fused_block.cu compute: y is the
// fp32 accumulator of the product; the per-(sample, group) moments of y are
// NOT clamped (var = E[y^2] - E[y]^2, JAX fused_block.py :84 and :273); out =
// relu(y a + b) in bf16 with a = rstd scale and b = bias - mean a; mu and
// rstd (B, Cout) fp32.
//
// Why one pass. A sample's rows are held by at most 8 CTAs at once, so the
// moments are reduced while y is still on the chip:
//   cluster route (M = Ho Wo > 128 rows per sample, ceil(M / 128) <= 8): the
//     CTAs of one sample and one Cout tile form a thread-block cluster. Each
//     stages its fp32 y tile in shared memory, writes its per-channel sums of
//     y and y^2 there, and after a cluster barrier reads every peer's sums
//     over distributed shared memory in rank order, so every CTA derives the
//     same moments bit for bit; a second cluster barrier keeps each CTA's
//     shared memory alive until its peers have read it. Rank 0 writes mu and
//     rstd.
//   pack route (M <= 128): P = min(8, 128 / M) samples share one tile, as the
//     TPU's `_samples_per_cell` (:315) packs samples per grid cell; rows past
//     P M, and the missing samples of the last pack, load as zeros and store
//     nothing; the sums are taken per row segment (one sample each). A 4 x 4
//     map then reads the weight B / 8 times per call instead of B.
// The product runs once and only out, mu and rstd leave the chip. Every sum
// runs in a fixed order, with no atomics, so two calls on the same inputs
// agree bit for bit.
//
// The product: an implicit GEMM with 128-row tiles (two consumer warpgroups
// of 64 rows, 256 threads) and a Cout tile BN of 64, 128 or 256 (a multiple
// of the group width, so no group straddles two tiles). K runs in steps of 64
// bf16 (one 128-byte row). A ring of `Cfg::kStages` slots in shared memory is
// filled by cp.async 16-byte copies into 128-byte-swizzled rows (the
// zero-fill form, src-size 0, for taps outside the image, rows past the
// tile's samples, and channels past Cin); `kAhead` steps load while wgmma
// m64nBNk16 (bf16 in, fp32 accumulate, both operands from shared memory
// through SW128 K-major descriptors) runs on the current one, and `kLag`
// wgmma groups stay in flight across steps. B8's weight is the wrapper's
// (taps, Cout, Cin) copy, so B loads K-major like A. B7 reads its (Cin,
// Cout) weight as it lies, MN-major, into 64-column blocks of 64 K-rows read
// through wgmma's transpose bit (the layout `tb_wgmma_probe` holds to
// torch.matmul): no copy of the weight before the launch.
//
// The epilogue stages y as fp32 128 x (BN + 8) in shared memory, reusing the
// ring: 61 / 101 / 182 KB with the sums and coefficients for BN = 64 / 128 /
// 256. Shared memory is max(ring, epilogue) + 1 KB alignment slack.
#pragma once

#include <math.h>

#include "sm90_wgmma.cuh"

namespace conv_gn {

using sm90::bf16;

constexpr int kBM = 128;         // tile rows: two consumer warpgroups of 64
constexpr int kThreads = 256;
constexpr int kBK = 64;          // bf16 per K step: one 128-byte row
constexpr int kMaxPack = 8;      // samples per tile, pack route
constexpr int kMaxCluster = 8;   // CTAs per sample, cluster route (portable)

enum Route { kCluster = 1, kPack = 2 };

struct Geo {
  int b, h, w, cin, cout;        // input map (H, W) and widths
  int ho, wo, m, stride, pad;    // output map; m = ho wo rows per sample
  int gw;                        // Cout / groups
  int route, p, cs;              // samples per tile (pack), CTAs per cluster
  float eps;
  int relu;
};

// What differs between the two instances. B8 (3x3) is bound by operations: 4
// ring slots, two steps loading ahead and one wgmma group in flight across
// steps; registers for two CTAs an SM at BN 64, one at 128 and 256. B7 (1x1)
// is bound by bytes and K is 1-4 steps: 3 slots, two steps loading ahead of
// the one multiplying (a K of Cin <= 128 is in flight at once), each step's
// wgmma waited on, so the ring (72 / 96 KB) stays inside the epilogue's
// footprint; registers and shared memory for two CTAs an SM at BN 64 and 128,
// so one CTA's loads run under the other's epilogue.
template <int KS, int BN> struct Cfg;
template <int BN> struct Cfg<3, BN> {
  static constexpr int kStages = 4, kLag = 1, kMinBlocks = BN == 64 ? 2 : 1;
};
template <int BN> struct Cfg<1, BN> {
  static_assert(BN <= 128, "a 1x1 instance keeps two CTAs an SM");
  static constexpr int kStages = 3, kLag = 0, kMinBlocks = 2;
};

template <int KS, int BN>
constexpr int ring_bytes() { return Cfg<KS, BN>::kStages * (kBM + BN) * 128; }

template <int BN>
constexpr int epilogue_bytes() {
  // ys, psum [2][kMaxPack][NP][BN], segsum [2][kMaxPack][BN], tot [2][BN],
  // coef [2][kMaxPack][BN]
  return 4 * (kBM * (BN + 8) + 2 * kMaxPack * kThreads + 2 * kMaxPack * BN + 2 * BN +
              2 * kMaxPack * BN);
}

template <int KS, int BN>
constexpr int smem_bytes() {
  return (ring_bytes<KS, BN>() > epilogue_bytes<BN>() ? ring_bytes<KS, BN>()
                                                      : epilogue_bytes<BN>()) + 1024;
}

// grid: cluster route (cs, Cout tiles, B) in clusters of (cs, 1, 1); pack
// route (ceil(B / p), Cout tiles, 1). 256 threads; smem_bytes() dynamic.
template <int KS, int BN>
__global__ void __launch_bounds__(kThreads, (Cfg<KS, BN>::kMinBlocks))
conv_gn_sm90(const bf16* __restrict__ x, const bf16* __restrict__ wt,
             const float* __restrict__ scale, const float* __restrict__ bias,
             bf16* __restrict__ out, float* __restrict__ mu, float* __restrict__ rstd,
             Geo g) {
  using namespace sm90;
  constexpr int kStages = Cfg<KS, BN>::kStages;
  constexpr int kLag = Cfg<KS, BN>::kLag;
  constexpr int kAhead = kStages - 1 - kLag;  // K steps loading ahead
  constexpr int kStageBytes = (kBM + BN) * 128;
  constexpr int kRowsA = kBM * 8 / kThreads;  // A rows per thread (one chunk each)
  constexpr int kRowsB = BN * 8 / kThreads;   // B rows per thread
  constexpr int kRowStep = kThreads / 8;
  constexpr int NP = kThreads / BN;           // threads per column in the sums
  constexpr int kLdY = BN + 8;                // staged y row (floats; 2-way banks)

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t pad = ((raw_s + 1023u) & ~1023u) - raw_s;  // SW128 wants 1 KB
  uint8_t* smem = smem_raw + pad;
  const uint32_t base_s = raw_s + pad;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;
  const bool pack = g.route == kPack;
  // this CTA's rows are rows R0 .. R0 + V - 1 of the (B M, Cout) output
  long long r0;
  int v_rows, sample = 0;
  if (pack) {
    r0 = static_cast<long long>(blockIdx.x) * g.p * g.m;
    const long long left = static_cast<long long>(g.b) * g.m - r0;
    v_rows = static_cast<int>(left < g.p * g.m ? left : g.p * g.m);
  } else {
    sample = blockIdx.z;
    const int m0 = blockIdx.x * kBM;
    r0 = static_cast<long long>(sample) * g.m + m0;
    v_rows = min(kBM, g.m - m0);
  }

  // A rows this thread loads (fixed for the whole K loop): the input pixel
  // (oh s, ow s) at channel chunk `chunk`, and its (ih, iw); rows past the
  // tile's samples get an (ih, iw) that every tap leaves outside the image
  const int chunk = tid & 7;
  const bf16* a_src[kRowsA];
  int a_ih[kRowsA], a_iw[kRowsA];
#pragma unroll
  for (int q = 0; q < kRowsA; ++q) {
    const int r = tid / 8 + q * kRowStep;
    a_src[q] = x;
    a_ih[q] = a_iw[q] = -4 * KS;
    if (r < v_rows) {
      const long long row = r0 + r;
      const long long bb = row / g.m;
      const int mm = static_cast<int>(row - bb * g.m);
      const int oh = mm / g.wo;
      a_ih[q] = oh * g.stride;
      a_iw[q] = (mm - oh * g.wo) * g.stride;
      a_src[q] = x + ((bb * g.h + a_ih[q]) * g.w + a_iw[q]) * g.cin + chunk * 8;
    }
  }
  const int kc = (g.cin + kBK - 1) / kBK;
  const int kt_n = KS * KS * kc;

  auto load_stage = [&](int kt, int slot) {
    const int tap = kt / kc, k0 = (kt - tap * kc) * kBK;
    const int dy = tap / KS - g.pad, dx = tap - (tap / KS) * KS - g.pad;
    const bool kin = k0 + chunk * 8 < g.cin;
    const uint32_t sa = base_s + slot * kStageBytes;
    const uint32_t sb = sa + kBM * 128;
    const int shift = (dy * g.w + dx) * g.cin + k0;
#pragma unroll
    for (int q = 0; q < kRowsA; ++q) {
      const int r = tid / 8 + q * kRowStep;
      const int ih = a_ih[q] + dy, iw = a_iw[q] + dx;
      const bool ok = kin && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w;
      cp_async16(sa + r * 128 + ((chunk ^ (r & 7)) << 4), ok ? a_src[q] + shift : x,
                 ok ? 16 : 0);
    }
    if constexpr (KS == 1) {
      // K-row r, columns 8 j .. 8 j + 7 of the tile: block j / 8, chunk j % 8
      constexpr int kChunksN = BN / 8;
#pragma unroll
      for (int q = 0; q < kRowsB; ++q) {
        const int i = tid + q * kThreads, r = i / kChunksN, j = i - r * kChunksN;
        const bool ok = k0 + r < g.cin && n0 + 8 * j < g.cout;
        const bf16* src = ok ? wt + static_cast<size_t>(k0 + r) * g.cout + n0 + 8 * j : wt;
        cp_async16(sb + (j >> 3) * kBK * 128 + r * 128 + (((j & 7) ^ (r & 7)) << 4), src,
                   ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int q = 0; q < kRowsB; ++q) {
        const int r = tid / 8 + q * kRowStep;
        const bool ok = kin && n0 + r < g.cout;
        const bf16* src =
            ok ? wt + (static_cast<size_t>(tap) * g.cout + n0 + r) * g.cin + k0 + chunk * 8
               : wt;
        cp_async16(sb + r * 128 + ((chunk ^ (r & 7)) << 4), src, ok ? 16 : 0);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);

  // ring: stage kt in slot kt % kStages; stages kt + 1 .. kt + kAhead load
  // while stage kt multiplies and the wgmma of stage kt - kLag may still run
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < kt_n) load_stage(s, s);
    cp_async_commit();
  }
  const int wg = tid >> 7;
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of stage kt landed
    fence_proxy_async();
    // every copy of stage kt is visible, and every warpgroup's wgmma of stage
    // kt + kAhead - kStages is done (its wait<kLag> below), so that slot is free
    __syncthreads();
    if (kt + kAhead < kt_n) load_stage(kt + kAhead, (kt + kAhead) % kStages);
    cp_async_commit();
    const uint32_t sa = base_s + (kt % kStages) * kStageBytes + wg * 64 * 128;
    const uint32_t sb = base_s + (kt % kStages) * kStageBytes + kBM * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if constexpr (KS == 1)
        wgmma_ss<BN, 1>(acc, desc_k(sa + kk * 32), desc_mn(sb + kk * 16 * 128, kBK * 128));
      else
        wgmma_ss<BN, 0>(acc, desc_k(sa + kk * 32), desc_k(sb + kk * 32));
    }
    wgmma_commit();
    wgmma_wait<kLag>();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the epilogue reuses it

  float* ys = reinterpret_cast<float*>(smem);       // [kBM][kLdY] fp32 y
  float* psum = ys + kBM * kLdY;                    // [2][kMaxPack][NP][BN]
  float* segsum = psum + 2 * kMaxPack * NP * BN;    // [2][kMaxPack][BN]
  float* tot = segsum + 2 * kMaxPack * BN;          // [2][BN] (cluster)
  float* coef = tot + 2 * BN;                       // [2][kMaxPack][BN]: a, b
  {
    // wgmma accumulator layout: warp w of the warpgroup holds rows 16 w ..
    // 16 w + 15; acc[4 i + 2 j + e] is row lane / 4 + 8 j, column 8 i + 2
    // (lane % 4) + e
    const int lane = tid & 31;
    const int row = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int col = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<float2*>(ys + (row + 8 * j) * kLdY + 8 * i + col) =
            make_float2(acc[4 * i + 2 * j], acc[4 * i + 2 * j + 1]);
  }
  __syncthreads();

  // per-(segment, channel) sums of y and y^2; a segment is one sample's rows
  // (pack) or the tile's valid rows (cluster). NP threads share a column,
  // each taking every NP-th row; then their partials add in part order.
  const int seglen = pack ? g.m : v_rows;
  const int nseg = pack ? (v_rows + g.m - 1) / g.m : 1;
  {
    const int c = tid % BN, part = tid / BN;
    for (int s = 0; s < nseg; ++s) {
      const int end = min((s + 1) * seglen, v_rows);
      float s1 = 0.f, s2 = 0.f;
      for (int r = s * seglen + part; r < end; r += NP) {
        const float v = ys[r * kLdY + c];
        s1 += v;
        s2 = fmaf(v, v, s2);
      }
      psum[(s * NP + part) * BN + c] = s1;
      psum[((kMaxPack + s) * NP + part) * BN + c] = s2;
    }
  }
  __syncthreads();
  for (int i = tid; i < nseg * BN; i += kThreads) {
    const int s = i / BN, c = i - s * BN;
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      t1 += psum[(s * NP + p) * BN + c];
      t2 += psum[((kMaxPack + s) * NP + p) * BN + c];
    }
    segsum[s * BN + c] = t1;
    segsum[(kMaxPack + s) * BN + c] = t2;
  }
  const float* sums = segsum;  // [2][ld] with ld = kMaxPack BN or BN
  int sums_ld = kMaxPack * BN;
  uint32_t rank = 0;
  if (!pack) {
    rank = cluster_rank();
    cluster_sync();  // every CTA's tile sums are in its shared memory
    for (int c = tid; c < BN; c += kThreads) {
      float t1 = 0.f, t2 = 0.f;
      for (int rk = 0; rk < g.cs; ++rk) {  // rank order: the same sum everywhere
        t1 += ld_cluster(segsum + c, rk);
        t2 += ld_cluster(segsum + kMaxPack * BN + c, rk);
      }
      tot[c] = t1;
      tot[BN + c] = t2;
    }
    // peers have read this CTA's sums (it may now exit), and tot is visible
    cluster_sync();
    sums = tot;
    sums_ld = BN;
  } else {
    __syncthreads();
  }

  // group moments (unclamped) -> per-(segment, channel) a and b; mu, rstd
  const float inv_count = 1.f / (static_cast<float>(g.m) * g.gw);
  for (int i = tid; i < nseg * BN; i += kThreads) {
    const int s = i / BN, c = i - s * BN, n = n0 + c;
    if (n >= g.cout) continue;
    const int c0 = c - c % g.gw;
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < g.gw; ++k) {
      t1 += sums[s * BN + c0 + k];
      t2 += sums[sums_ld + s * BN + c0 + k];
    }
    const float mean = t1 * inv_count;
    const float var = t2 * inv_count - mean * mean;
    const float rs = rsqrtf(var + g.eps);
    const float a = rs * scale[n];
    coef[s * BN + c] = a;
    coef[(kMaxPack + s) * BN + c] = bias[n] - mean * a;
    const int bb = pack ? blockIdx.x * g.p + s : sample;
    if (pack || rank == 0) {
      mu[static_cast<size_t>(bb) * g.cout + n] = mean;
      rstd[static_cast<size_t>(bb) * g.cout + n] = rs;
    }
  }
  __syncthreads();

  // normalise + ReLU from the staged y; 8 channels (16 bytes of out) a thread
  constexpr int kChunksN = BN / 8;
  for (int i = tid; i < v_rows * kChunksN; i += kThreads) {
    const int r = i / kChunksN, j = i - r * kChunksN, n = n0 + 8 * j;
    if (n >= g.cout) continue;
    const int s = pack ? r / g.m : 0;
    const float* yr = ys + r * kLdY + 8 * j;
    const float* ca = coef + s * BN + 8 * j;
    const float* cb = ca + kMaxPack * BN;
    const float4 y0 = *reinterpret_cast<const float4*>(yr);
    const float4 y1 = *reinterpret_cast<const float4*>(yr + 4);
    const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float o0 = fmaf(yv[2 * e], ca[2 * e], cb[2 * e]);
      float o1 = fmaf(yv[2 * e + 1], ca[2 * e + 1], cb[2 * e + 1]);
      if (g.relu) {
        o0 = fmaxf(o0, 0.f);
        o1 = fmaxf(o1, 0.f);
      }
      packed[e] = pack_bf16(o0, o1);
    }
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(r0 + r) * g.cout + n) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// ------------------------------------------------------------------ host
// Fills g's plan fields and checks what the kernel takes; false for a plan
// it cannot run (the entry point then returns cudaErrorInvalidValue without
// launching). `max_bn` is the instance's widest Cout tile.
inline bool plan_ok(Geo& g, int groups, int route, int bm, int bn, int p, int cluster,
                    int max_bn) {
  if (g.b <= 0 || g.h <= 0 || g.w <= 0 || g.cin <= 0 || g.cout <= 0 || groups <= 0 ||
      g.stride <= 0 || g.ho <= 0 || g.wo <= 0 || g.cout % groups || g.cin % 8 ||
      g.cout % 8 || bm != kBM || (bn != 64 && bn != 128 && bn != 256) || bn > max_bn ||
      bn % (g.cout / groups) || (g.cout + bn - 1) / bn > 65535 ||
      static_cast<long long>(g.h) * g.w > (1 << 30))
    return false;
  g.m = g.ho * g.wo;
  g.gw = g.cout / groups;
  g.route = route;
  g.p = p;
  g.cs = cluster;
  if (route == kCluster)
    return p == 1 && cluster == (g.m + kBM - 1) / kBM && cluster >= 2 &&
           cluster <= kMaxCluster && g.b <= 65535;
  if (route == kPack)
    return cluster == 1 && g.m <= kBM && p >= 1 && p <= kMaxPack && p * g.m <= kBM;
  return false;
}

template <int KS, int BN>
cudaError_t launch(const Geo& g, const void* x, const void* wt, const float* scale,
                   const float* bias, void* out, float* mu, float* rstd, cudaStream_t st) {
  constexpr int smem = smem_bytes<KS, BN>();
  auto kern = conv_gn_sm90<KS, BN>;
  cudaError_t err = sm90::set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const unsigned n_tiles = (g.cout + BN - 1) / BN;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  if (g.route == kCluster) {
    cfg.gridDim = dim3(g.cs, n_tiles, g.b);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = g.cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
  } else {
    cfg.gridDim = dim3((g.b + g.p - 1) / g.p, n_tiles, 1);
    cfg.numAttrs = 0;
  }
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const bf16*>(x),
                           static_cast<const bf16*>(wt), scale, bias,
                           static_cast<bf16*>(out), mu, rstd, g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// CTAs of conv_gn_sm90<KS, BN> that fit one SM at once (registers, shared
// memory, threads), as the occupancy calculator reports it; -1 on error
template <int KS, int BN>
int occupancy() {
  constexpr int smem = smem_bytes<KS, BN>();
  auto kern = conv_gn_sm90<KS, BN>;
  int n = 0;
  if (sm90::set_smem(kern, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads, smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace conv_gn
