// GroupNorm(+ReLU) forward over NHWC for Hopper (sm_90a): the one-pass route
// of B5.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// torchbooster_tpu/ops/group_norm.py (:69, pallas_call :202) for bf16 x whose C
// is a multiple of 8 (at most 2048) and whose sample run fits 8 CTAs of about
// 75 KB; fp32 and other shapes keep `gn_fwd` of group_norm.cu ("two_pass"). The
// route is planned before launch by `plan_gn_fwd` (ops/group_norm.py).
//
// It computes what gn_fwd computes: per-channel fp32 sums of x and x^2 over
// the sample, combined per group, mean = E[x], var = max(E[x^2] - mean^2, 0)
// (the clamp of JAX :87), inv = rsqrt(var + eps); y = x a + b with a = inv
// scale and b = bias - mean a per channel, then ReLU, rounded to bf16 once;
// stats (N, 2, C) fp32 = (mean, inv) per channel. The a and b that form y come
// from exactly the stats written, so B6 rebuilds y's ReLU mask from them.
//
// Bound: bytes. A few flops an element against the card's ~295 flop/byte
// ridge: x read once, y written once (40.1 us for ResNet-18's stem norm at
// batch 512 on an H100 SXM's 3.35 TB/s).
//
// What the design does about it. gn_fwd makes two passes over each (H W,
// channel block) slab, moments then the affine write, so x is read twice, the
// second time from L2 at best; at small maps it runs thousands of CTAs of a
// few KB with half their threads idle. Here, as in B6's one-pass kernel
// (group_norm_bwd_sm90.cu), each sample's x is read once into shared memory
// and y is written from that copy:
//   - a sample's H W positions are split into `cs` contiguous runs of `rows`
//     positions, one CTA each (NHWC keeps a run contiguous, every channel
//     included); the cs CTAs of a sample form a thread-block cluster.
//     `plan_gn_fwd` takes the fewest CTAs (at most 8) whose shared memory
//     lets three share an SM: 2, 1, 1, 1 at ResNet-18's four norms;
//   - or, at `pack` > 1 (cs 1, rows = H W), one CTA holds `pack` whole
//     consecutive samples, one contiguous run too, each sample's sums kept
//     apart: `plan_gn_fwd` packs two where a sample's x is 32 KB or more and
//     two such CTAs still share an SM (ResNet-18's 8 x 8 x 256 norm), where
//     the smoke's plan sweep found it faster;
//   - the run lands in up to four cp.async groups (whole samples a group
//     when packed), and each part's x and x^2 are summed as soon as it has
//     landed, under the copies of the later parts; where each thread copied
//     exactly the chunks it reads (ResNet's widths), no barrier waits for the
//     slowest warp's copies;
//   - threads lie side by side along the channels (8 a thread), so the
//     copies, the shared-memory reads and the y stores are 16 bytes a thread,
//     neighbours on neighbouring addresses;
//   - per-channel partials add across thread rows in a fixed order (one sum
//     at a time through one 8 KB buffer when a CTA holds one sample), then
//     across the cluster over distributed shared memory in rank order
//     (group_norm_sm90.cuh), so every CTA derives the same group statistics
//     bit for bit, with no atomics. Rank 0 writes stats.
// Two calls on the same inputs agree bit for bit.
//
// Designs tried and left (their times in PERF.md): 71 registers, three CTAs
// an SM (512 one-sample CTAs took 1.3 waves at the 8 x 8 and 4 x 4 norms;
// the cap of 64 registers fits them in one); a packed CTA that reduces and
// writes each sample while the later ones land, through one partials
// buffer (slower at every norm, packed or not).
//
// Shared memory per CTA: the run (rows x C x 2 bytes), the thread rows'
// partials (8 KB; at least 2 C floats, which also take the cluster totals;
// packed: both sums of every sample), the channel sums and the group
// statistics: 74 KB at the stem's and stage 1's norms (three CTAs an SM),
// 100 KB packed at stage 2's (two), 28 KB at stage 3's (four, by registers).
// `tb_gn_fwd_sm90_occupancy` reports the CTAs an SM for a plan.

#include <math.h>

#include "group_norm_sm90.cuh"

namespace {

using namespace gn_sm90;

// shared memory of one CTA, in bytes: the run of `pack` x `rows` positions,
// the thread rows' partials (one sum at a time, [max(trows, 2)][C], at pack 1;
// [pack][2][trows][C] packed), the channel sums [pack][2][C] and the group
// statistics [pack][2][groups]
long long smem_bytes(int rows, int c, int groups, int pack) {
  const long long trows = kThreads / (c / kVec);
  const long long red = pack == 1 ? (trows > 2 ? trows : 2) : 2LL * pack * trows;
  return 2LL * pack * rows * c + red * c * 4 + 8LL * pack * c + 8LL * pack * groups;
}

// grid (cs, ceil(N / pack)) in clusters of (cs, 1, 1) when cs > 1; 256
// threads; smem_bytes(rows, c, groups, pack) dynamic. At pack 1, CTA (r, n)
// holds positions r rows .. r rows + rows - 1 of sample n (fewer at the end
// of the map); at pack > 1 (cs 1, rows = hw), CTA (0, m) holds samples
// m pack .. m pack + pack - 1 (fewer in the last).
__global__ void __launch_bounds__(kThreads, 4)
gn_fwd_sm90(const bf16* __restrict__ x, const float* __restrict__ scale,
            const float* __restrict__ bias, bf16* __restrict__ y, float* __restrict__ stats,
            int n, int hw, int c, int groups, float eps, int relu, int rows, int cs,
            int pack) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lanes = c / kVec;            // threads along the channels
  const int trows = kThreads / lanes;    // thread rows along the positions
  const int tid = threadIdx.x;
  const int lane = tid % lanes, trow = tid / lanes;
  const bool active = trow < trows;
  const int n0 = blockIdx.y * pack;      // this CTA's first sample
  const int nsamp = min(pack, n - n0);
  const int p0 = blockIdx.x * rows;      // == cluster rank * rows
  const int nrows = pack == 1 ? max(0, min(rows, hw - p0)) : nsamp * hw;
  const int span = pack == 1 ? nrows : hw;  // positions of one sample here
  const int nred = pack == 1 ? max(trows, 2) : 2 * pack * trows;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(xs + static_cast<size_t>(pack) * rows * c);
  float* csum = red + nred * c;          // [pack][2][C]: sums of x, x^2
  float* gstat = csum + pack * 2 * c;    // [pack][2][groups]: mean, inv

  // the run: one contiguous range of x in kParts groups of consecutive
  // positions (whole samples when packed; the last groups empty for a short
  // run)
  const size_t base = (static_cast<size_t>(n0) * hw + p0) * c;
  int part_rows;
  if (pack == 1) {
    part_rows = max(kMinPartRows, (nrows + kParts - 1) / kParts);
    part_rows = (part_rows + trows - 1) / trows * trows;
  } else {
    part_rows = hw * ((nsamp + kParts - 1) / kParts);
  }
  {
    const uint32_t xs_s = smem_u32(xs);
#pragma unroll
    for (int k = 0; k < kParts; ++k) {
      const int end = min((k + 1) * part_rows, nrows) * lanes;
      for (int i = k * part_rows * lanes + tid; i < end; i += kThreads)
        cp_async16(xs_s + 16 * i, x + base + kVec * i, 16);
      cp_async_commit();
    }
  }

  // this thread's channel constants, read while the copies land
  const int ch = lane * kVec;
  float sc[kVec], bi[kVec];
  ldg8(sc, scale + ch);
  ldg8(bi, bias + ch);

  // per-channel partials of x and x^2 over this thread's positions (trow,
  // trow + trows, ...), each part of the run summed once it has landed; a
  // packed sample's partials go to `red` as soon as its last position is in.
  // Where the lanes divide the threads and a part the thread rows, each
  // thread copied exactly the chunks it reads here and in the write pass, so
  // its own wait suffices and the warps run on without a barrier.
  const bool own = kThreads % lanes == 0 && part_rows % trows == 0;
  float s1[kVec], s2[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) s1[v] = s2[v] = 0.f;
#pragma unroll
  for (int k = 0; k < kParts; ++k) {
    const int lo = k * part_rows, hi = min(lo + part_rows, nrows);
    if (lo >= nrows) break;  // the same for every thread
    wait_part(k);
    if (!own) __syncthreads();
    if (!active) continue;
    for (int s = lo / span; s * span < hi; ++s) {
      const int a = max(lo, s * span), b = min(hi, (s + 1) * span);
      for (int p = a + (trow - a % trows + trows) % trows; p < b; p += trows) {
        float xv[kVec];
        load8(xv, xs + p * c + ch);
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          s1[v] += xv[v];
          s2[v] = fmaf(xv[v], xv[v], s2[v]);
        }
      }
      if (pack > 1) {  // parts hold whole samples: sample s is complete
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          float* r = red + ((2 * s + k2) * trows + trow) * c + ch;
          const float* v = k2 == 0 ? s1 : s2;
          *reinterpret_cast<float4*>(r) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(r + 4) = make_float4(v[4], v[5], v[6], v[7]);
        }
#pragma unroll
        for (int v = 0; v < kVec; ++v) s1[v] = s2[v] = 0.f;
      }
    }
  }
  cp_async_wait<0>();  // every group (the empty ones of a short run too)
  // thread rows in order: one sum at a time through `red` at pack 1, every
  // sample's two sums at once packed
  if (pack == 1) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (active) {
        float* r = red + trow * c + ch;
        const float* v = k == 0 ? s1 : s2;
        *reinterpret_cast<float4*>(r) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(r + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
      __syncthreads();
      for (int j = tid; j < c; j += kThreads) {
        float t = 0.f;
        for (int r = 0; r < trows; ++r) t += red[r * c + j];
        csum[k * c + j] = t;
      }
      __syncthreads();
    }
  } else {
    __syncthreads();
    for (int j = tid; j < nsamp * 2 * c; j += kThreads) {
      const int sk = j / c, jc = j - sk * c;  // sk = 2 sample + sum
      float t = 0.f;
      for (int r = 0; r < trows; ++r) t += red[(sk * trows + r) * c + jc];
      csum[j] = t;
    }
    __syncthreads();
  }
  const float* sums = csum;
  if (cs > 1) {
    // every rank's channel sums, added in rank order, land in `red`
    cluster_totals(csum, red, 2 * c, cs);
    sums = red;
  }

  // group statistics, one thread a (sample, group), its channels in order
  const int gw = c / groups;
  const float inv_count = 1.f / static_cast<float>(hw * gw);
  for (int j = tid; j < nsamp * groups; j += kThreads) {
    const int s = j / groups, gi = j - s * groups;
    const float* sm = sums + s * 2 * c;
    float t1 = 0.f, t2 = 0.f;
#pragma unroll 8
    for (int k = gi * gw; k < (gi + 1) * gw; ++k) {
      t1 += sm[k];
      t2 += sm[c + k];
    }
    const float mean = t1 * inv_count;
    const float var = fmaxf(t2 * inv_count - mean * mean, 0.f);
    gstat[s * 2 * groups + gi] = mean;
    gstat[s * 2 * groups + groups + gi] = rsqrtf(var + eps);
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    // stats[n] = (mean, inv) per channel, each channel its group's
    float* st = stats + static_cast<size_t>(n0) * 2 * c;
    for (int j = tid; j < nsamp * 2 * c; j += kThreads) {
      const int sk = j / c, jc = j - sk * c;  // sk = 2 sample + (0 mean, 1 inv)
      st[j] = gstat[sk * groups + jc / gw];
    }
  }

  // y = x a + b (then ReLU) from the copy on chip, a = inv scale and
  // b = bias - mean a from the very statistics written
  if (!active) return;
  bf16* out = y + base + ch;
  for (int s = 0; s < nsamp; ++s) {
    float ca[kVec], cb[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int gi = (ch + v) / gw;
      const float mean = gstat[s * 2 * groups + gi];
      const float inv = gstat[s * 2 * groups + groups + gi];
      ca[v] = inv * sc[v];
      cb[v] = bi[v] - mean * ca[v];
    }
    const int lo = s * span;
    for (int p = lo + (trow - lo % trows + trows) % trows; p < lo + span; p += trows) {
      float xv[kVec];
      load8(xv, xs + p * c + ch);
      uint32_t packed[kVec / 2];
#pragma unroll
      for (int e = 0; e < kVec / 2; ++e) {
        float o[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int v = 2 * e + u;
          o[u] = fmaf(xv[v], ca[v], cb[v]);
          if (relu) o[u] = fmaxf(o[u], 0.f);
        }
        packed[e] = pack_bf16(o[0], o[1]);
      }
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(p) * c) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
}

bool plan_ok(int n, int hw, int c, int groups, int rows, int cs, int pack) {
  return n > 0 && n <= 65535 && hw > 0 && c > 0 && c % kVec == 0 && c <= kMaxC &&
         groups > 0 && c % groups == 0 && cs >= 1 && cs <= kMaxCluster && rows > 0 &&
         pack >= 1 && (pack == 1 || (cs == 1 && rows == hw)) &&
         static_cast<long long>(rows) * cs >= hw &&
         static_cast<long long>(rows) * (cs - 1) < hw &&
         smem_bytes(rows, c, groups, pack) <= kMaxSmem;
}

}  // namespace

// tb_gn_fwd_sm90: (y, stats) of B5 for bf16 x (N, H W, C); scale, bias (C,)
// fp32; y (N, H W, C) bf16; stats (N, 2, C) fp32. Every pointer a contiguous,
// 16-byte-aligned device buffer. The plan (cs CTAs a sample of `rows`
// positions each, or `pack` samples a CTA) comes from `plan_gn_fwd`; a plan
// this kernel cannot run returns cudaErrorInvalidValue without launching.
// Otherwise returns the launch's CUDA error code.
extern "C" int tb_gn_fwd_sm90(const void* x, const float* scale, const float* bias, void* y,
                              float* stats, int n, int hw, int c, int groups, float eps,
                              int relu, int rows, int cs, int pack, void* stream) {
  if (!plan_ok(n, hw, c, groups, rows, cs, pack))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(gn_fwd_sm90, dim3(cs, (n + pack - 1) / pack, 1), cs,
                static_cast<int>(smem_bytes(rows, c, groups, pack)), stream,
                static_cast<const bf16*>(x), scale, bias, static_cast<bf16*>(y), stats, n, hw,
                c, groups, eps, relu, rows, cs, pack);
}

// CTAs of a (rows, c, groups, pack) plan that share one SM (registers, shared
// memory and threads together), from cudaOccupancyMaxActiveBlocksPerMultiprocessor;
// -1 for a plan the kernel cannot run or on error
extern "C" int tb_gn_fwd_sm90_occupancy(int rows, int c, int groups, int pack) {
  if (!plan_ok(pack, rows, c, groups, rows, 1, pack)) return -1;
  return occupancy(gn_fwd_sm90, static_cast<int>(smem_bytes(rows, c, groups, pack)));
}
