// GroupNorm(+ReLU) backward over NHWC for Hopper (sm_90a): the one-pass route
// of B6.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of
// torchbooster_tpu/ops/group_norm.py (:106, pallas_call :236) for bf16
// operands whose C is a multiple of 8 (at most 2048) and whose sample slab of
// x and dy fits 8 CTAs of about 64 KB; fp32 and other shapes keep `gn_bwd`
// of group_norm.cu ("two_pass"). The route is planned before launch by
// `plan_gn_bwd` (ops/group_norm.py).
//
// It computes what gn_bwd computes: with xhat = (x - mean) inv from stats
// (N, 2, C) = (mean, inv), the ReLU mask m = xhat scale + bias > 0 in fp32
// (JAX :123), the per-channel sums S_xh = sum m dy xhat and S_dy = sum m dy
// over the sample, the group means g1 = mean_g(scale S_dy) and g2 =
// mean_g(scale S_xh), and dx = inv (m dy scale - g1 - xhat g2) in bf16; part
// (N, 2, C) fp32 = (S_xh, S_dy), which the wrapper sums over N (JAX :258).
//
// Bound: bytes. A few flops an element against the card's ~295 flop/byte
// ridge: x and dy read once, dx written once (60.3 us for ResNet-18's stem
// norm at batch 512 on an H100 SXM's 3.35 TB/s).
//
// What the design does about it. gn_bwd makes two passes over each (H W,
// channel block) slab, so x and dy are read twice: five tensor passes against
// the bound's three, the second read left to the L2. Here each sample's slab
// is read once, with 16-byte cp.async copies of one contiguous run per tensor
// (NHWC keeps a run of positions contiguous, every channel included), into
// shared memory, and dx is computed from that copy:
//   - a sample's H W positions are split into `cs` contiguous runs of
//     `rows` positions, one CTA each; the cs CTAs of a sample form a
//     thread-block cluster. `plan_gn_bwd` takes the fewest CTAs (at most 8)
//     whose shared memory lets three share an SM: 4, 2, 1, 1 at ResNet-18's
//     four norms at batch 512;
//   - the run lands in up to four cp.async groups, and the first pass sums
//     each part as soon as it has landed, so that pass runs under the copies
//     of the later parts (each thread copies the very chunks it reads, so
//     at ResNet's widths no barrier waits for the slowest warp's copies);
//     with ReLU it writes the masked dy back over dy
//     (exact in bf16), and the second pass forms dx as two FMAs a value
//     from per-channel constants;
//   - each CTA holds every channel of its positions, threads side by side
//     along the channels (8 a thread), so the copies, the shared-memory reads
//     and the dx stores are all 16 bytes a thread, neighbours on neighbouring
//     addresses;
//   - its per-channel partials of S_xh and S_dy add across its threads in a
//     fixed order, then across the cluster over distributed shared memory in
//     rank order (every rank's sum loaded at once, then added in order), as
//     conv_gn_sm90.cuh's cluster route exchanges its moments (the exchange
//     is group_norm_sm90.cuh's, shared with B5's forward), so every CTA
//     derives the same group means bit for bit, with no atomics; a second
//     cluster barrier keeps each CTA's sums alive until its peers have read
//     them. Rank 0 writes part.
// Two calls on the same inputs agree bit for bit.
//
// Designs tried and left (their times in PERF.md): two CTAs an SM
// with a 16 KB partials buffer; persistent CTAs with two slab buffers, the
// next sample's runs loading under this one's arithmetic. Each sample pays a
// fixed cost (barriers, the cluster exchange, the group means), and halving
// the runs to fit two buffers doubled it: slower at every norm.
//
// Shared memory per CTA: the slab (rows x C x 4 bytes: x and dy in bf16),
// the partials of its thread rows for one sum at a time (8 KB; at least 2 C
// floats, which also take the cluster totals), the channel sums and the
// group means: 72-74 KB at ResNet-18's norms, three CTAs an SM.
// `tb_gn_bwd_sm90_occupancy` reports the CTAs an SM for a plan.

#include <math.h>

#include "group_norm_sm90.cuh"

namespace {

using namespace gn_sm90;

// shared memory of one CTA, in bytes: the slab of x and dy, the thread
// rows' partials [max(trows, 2)][C] (one sum at a time; then the cluster
// totals), the channel sums [2][C], the group means [2][groups]
int smem_bytes(int rows, int c, int groups) {
  const int trows = kThreads / (c / kVec);
  return rows * c * 4 + (trows > 2 ? trows : 2) * c * 4 + 2 * c * 4 + 2 * groups * 4;
}

// grid (cs, N) in clusters of (cs, 1, 1) when cs > 1; 256 threads;
// smem_bytes(rows, c, groups) dynamic. CTA (r, n) holds positions r rows ..
// r rows + rows - 1 of sample n (fewer at the end of the map).
__global__ void __launch_bounds__(kThreads, 3)
gn_bwd_sm90(const bf16* __restrict__ x, const bf16* __restrict__ dy,
            const float* __restrict__ stats, const float* __restrict__ scale,
            const float* __restrict__ bias, bf16* __restrict__ dx,
            float* __restrict__ part, int hw, int c, int groups, int rows, int cs,
            int relu) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lanes = c / kVec;            // threads along the channels
  const int trows = kThreads / lanes;    // thread rows along the positions
  const int tid = threadIdx.x;
  const int lane = tid % lanes, trow = tid / lanes;
  const bool active = trow < trows;
  const int n = blockIdx.y;
  const int p0 = blockIdx.x * rows;      // == cluster rank * rows
  const int nrows = max(0, min(rows, hw - p0));
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ys = xs + rows * c;
  float* red = reinterpret_cast<float*>(ys + rows * c);  // [max(trows, 2)][C]
  float* csum = red + max(trows, 2) * c;                 // [2][C]: S_xh, S_dy
  float* gmean = csum + 2 * c;                           // [2][groups]

  // the run: one contiguous range of x and one of dy, in kParts groups of
  // consecutive positions (the last ones empty for a short run)
  const size_t base = (static_cast<size_t>(n) * hw + p0) * c;
  const int part_rows = max(kMinPartRows, (nrows + kParts - 1) / kParts);
  {
    const uint32_t xs_s = smem_u32(xs), ys_s = smem_u32(ys);
#pragma unroll
    for (int k = 0; k < kParts; ++k) {
      const int end = min((k + 1) * part_rows, nrows) * lanes;
      for (int i = k * part_rows * lanes + tid; i < end; i += kThreads) {
        cp_async16(xs_s + 16 * i, x + base + kVec * i, 16);
        cp_async16(ys_s + 16 * i, dy + base + kVec * i, 16);
      }
      cp_async_commit();
    }
  }

  // this thread's channel constants, read while the copies land
  const int ch = lane * kVec;
  const int jc = active ? ch : 0;
  const float* st = stats + static_cast<size_t>(n) * 2 * c;
  float mean[kVec], inv[kVec], sc[kVec], bi[kVec];
  ldg8(mean, st + jc);
  ldg8(inv, st + c + jc);
  ldg8(sc, scale + jc);
  ldg8(bi, bias + jc);

  // per-channel partials over this thread's positions (trow, trow + trows,
  // ...), each part of the run summed once it has landed. With ReLU the
  // masked dy goes back over dy (exact in bf16), so the second pass needs
  // no mask.
  // Where the lanes divide the threads and a part the thread rows, each
  // thread copied exactly the chunks it reads here and in the second pass,
  // so its own wait suffices and the warps run on without a barrier.
  const bool own = kThreads % lanes == 0 && part_rows % trows == 0;
  float pxh[kVec], pdy[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) pxh[v] = pdy[v] = 0.f;
#pragma unroll
  for (int k = 0; k < kParts; ++k) {
    const int lo = k * part_rows, hi = min(lo + part_rows, nrows);
    if (lo >= nrows) break;  // the same for every thread
    wait_part(k);
    if (!own) __syncthreads();
    if (!active) continue;
    for (int p = lo + (trow - lo % trows + trows) % trows; p < hi; p += trows) {
      float xv[kVec], gv[kVec];
      load8(xv, xs + p * c + ch);
      load8(gv, ys + p * c + ch);
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float xhat = (xv[v] - mean[v]) * inv[v];
        if (relu && !(xhat * sc[v] + bi[v] > 0.f)) gv[v] = 0.f;
        pxh[v] = fmaf(gv[v], xhat, pxh[v]);
        pdy[v] += gv[v];
      }
      if (relu)
        *reinterpret_cast<uint4*>(ys + p * c + ch) =
            make_uint4(pack_bf16(gv[0], gv[1]), pack_bf16(gv[2], gv[3]),
                       pack_bf16(gv[4], gv[5]), pack_bf16(gv[6], gv[7]));
    }
  }
  cp_async_wait<0>();  // every group (the empty ones of a short run too)
  // thread rows in order, one sum at a time through `red`
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (active) {
      float* r = red + trow * c + ch;
      const float* v = k == 0 ? pxh : pdy;
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
  const float* sums = csum;
  if (cs > 1) {
    // every rank's channel sums, added in rank order, land in `red`
    cluster_totals(csum, red, 2 * c, cs);
    sums = red;
  }

  // group means, one thread a group, its channels in order
  const int gw = c / groups;
  const float inv_count = 1.f / (static_cast<float>(hw) * gw);
  for (int gi = tid; gi < groups; gi += kThreads) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll 8
    for (int k = gi * gw; k < (gi + 1) * gw; ++k) {
      const float sk = __ldg(scale + k);
      t1 = fmaf(sk, sums[c + k], t1);
      t2 = fmaf(sk, sums[k], t2);
    }
    gmean[gi] = t1 * inv_count;
    gmean[groups + gi] = t2 * inv_count;
  }
  if (blockIdx.x == 0) {
    float* pp = part + static_cast<size_t>(n) * 2 * c;
    for (int j = tid; j < 2 * c; j += kThreads) pp[j] = sums[j];
  }
  __syncthreads();

  // dx = inv (g scale - g1 - xhat g2) with xhat = (x - mean) inv, as
  // g a + x e + b from the copy on chip, with a = inv scale, e = -inv^2 g2
  // and b = inv (mean inv g2 - g1) per channel
  if (!active) return;
  float ca[kVec], ce[kVec], cb[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int gi = (ch + v) / gw;
    const float g1 = gmean[gi], g2 = gmean[groups + gi];
    ca[v] = inv[v] * sc[v];
    ce[v] = -inv[v] * inv[v] * g2;
    cb[v] = inv[v] * (mean[v] * inv[v] * g2 - g1);
  }
  bf16* out = dx + base + ch;
  for (int p = trow; p < nrows; p += trows) {
    float xv[kVec], gv[kVec];
    load8(xv, xs + p * c + ch);
    load8(gv, ys + p * c + ch);
    uint32_t packed[kVec / 2];
#pragma unroll
    for (int e = 0; e < kVec / 2; ++e) {
      float o[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int v = 2 * e + u;
        o[u] = fmaf(xv[v], ce[v], fmaf(gv[v], ca[v], cb[v]));
      }
      packed[e] = pack_bf16(o[0], o[1]);
    }
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(p) * c) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

bool plan_ok(int n, int hw, int c, int groups, int rows, int cs) {
  return n > 0 && n <= 65535 && hw > 0 && c > 0 && c % kVec == 0 && c <= kMaxC &&
         groups > 0 && c % groups == 0 && cs >= 1 && cs <= kMaxCluster && rows > 0 &&
         static_cast<long long>(rows) * cs >= hw &&
         static_cast<long long>(rows) * (cs - 1) < hw &&
         smem_bytes(rows, c, groups) <= kMaxSmem;
}

}  // namespace

// tb_gn_bwd_sm90: (dx, part) of B6 for bf16 x, dy (N, H W, C); stats (N, 2,
// C), scale, bias (C,), part (N, 2, C) fp32; dx (N, H W, C) bf16. Every
// pointer a contiguous, 16-byte-aligned device buffer. The plan (cs CTAs a
// sample, `rows` positions a CTA) comes from `plan_gn_bwd`; a plan this kernel
// cannot run returns cudaErrorInvalidValue without launching. Otherwise
// returns the launch's CUDA error code.
extern "C" int tb_gn_bwd_sm90(const void* x, const void* dy, const float* stats,
                              const float* scale, const float* bias, void* dx,
                              float* part, int n, int hw, int c, int groups, int relu,
                              int rows, int cs, void* stream) {
  if (!plan_ok(n, hw, c, groups, rows, cs)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(gn_bwd_sm90, dim3(cs, n, 1), cs, smem_bytes(rows, c, groups), stream,
                static_cast<const bf16*>(x), static_cast<const bf16*>(dy), stats, scale, bias,
                static_cast<bf16*>(dx), part, hw, c, groups, rows, cs, relu);
}

// CTAs of a (rows, c, groups) plan that share one SM (registers, shared memory
// and threads together), from cudaOccupancyMaxActiveBlocksPerMultiprocessor;
// -1 for a plan the kernel cannot run or on error
extern "C" int tb_gn_bwd_sm90_occupancy(int rows, int c, int groups) {
  if (!plan_ok(1, rows, c, groups, rows, 1)) return -1;
  return occupancy(gn_bwd_sm90, smem_bytes(rows, c, groups));
}
