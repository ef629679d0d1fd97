// Fused 3x3 convolution + GroupNorm (+ReLU), forward, for Hopper (sm_90a):
// the one-pass tensor-core route of B8.
//
// Replaces the Pallas TPU kernel `_fwd3_kernel` of
// torchbooster_tpu/ops/fused_block.py (:238, pallas_call :319): 3x3 conv,
// stride 1, padding 1, + GroupNorm + ReLU, for bf16 operands whose Cin and
// Cout are multiples of 8 and whose sample spans at most eight 128-row tiles.
// Other shapes, and fp32, keep the two-pass kernels of fused_block.cu; the
// route is planned before launch by `plan_conv3x3` (ops/fused_block.py).
//
// It computes what those kernels compute: y is the fp32 accumulator of the
// product out[b, m, n] = sum over taps (ky, kx) and channels k of
// x[b, oh + ky - 1, ow + kx - 1, k] * w[ky, kx, k, n] (zero outside the
// image); the per-(sample, group) moments of y are NOT clamped (var = E[y^2]
// - E[y]^2, :273); out = relu(y * a + b) in bf16 with a = rstd * scale and
// b = bias - mean * a; mu and rstd (B, Cout) fp32.
//
// Bound: operations. At ResNet-18's stride-1 3x3 shapes (batch 512) each
// call is 38.65 GFLOP against 5-12 MB of operands: 39.1 us at 989 TFLOP/s,
// 2-4 us at 3.35 TB/s.
//
// Why one pass. The two-pass kernels computed the product twice so that y
// never reached device memory: pass 1 for per-tile channel sums, pass 2 again
// for the normalise epilogue. Here a sample's rows are held by at most 8 CTAs
// at once, so the moments are reduced while y is still on the chip:
//   cluster route (M = H W > 128 rows per sample, ceil(M / 128) <= 8): the
//     CTAs of one sample and one Cout tile form a thread-block cluster. Each
//     stages its fp32 y tile in shared memory, writes its per-channel sums of
//     y and y^2 there, and after a cluster barrier reads every peer's sums
//     over distributed shared memory (mapa + ld.shared::cluster) in rank
//     order, so every CTA derives the same moments bit for bit; a second
//     cluster barrier keeps each CTA's shared memory alive until its peers
//     have read it. Rank 0 writes mu and rstd. (ResNet-18 stages 0 and 1.)
//   pack route (M <= 128): P = min(8, 128 / M) samples share one tile, as the
//     TPU's `_samples_per_cell` (:315) packs samples per grid cell; rows past
//     P M, and the missing samples of the last pack, load as zeros and store
//     nothing; the sums are taken per row segment (one sample each). At the
//     4 x 4 stage this reads the weight B / 8 times per call instead of B.
//     (ResNet-18 stages 2 and 3.)
// The product runs once (38.65 GFLOP per call, not 77) and only out, mu and
// rstd leave the chip. Every sum runs in a fixed order, with no atomics, so
// two calls on the same inputs agree bit for bit.
//
// The product: an implicit GEMM with 128-row tiles (two consumer warpgroups
// of 64 rows, 256 threads) and a Cout tile BN of 64, 128 or 256 (a multiple
// of the group width, so no group straddles two tiles). K runs over the 9
// taps times Cin in steps of 64 bf16 (one 128-byte row). A 4-slot ring in
// shared memory is filled by cp.async 16-byte copies into 128-byte-swizzled
// rows (the zero-fill form, src-size 0, for taps outside the image, rows
// past the tile's samples, and channels past Cin); two steps are in flight
// while wgmma.mma_async m64nBNk16 (bf16 in, fp32 accumulate, both operands
// from shared memory through SW128 K-major descriptors) runs on the current
// one, and one wgmma group stays in flight across steps.
//
// The weight stays a (taps, Cout, Cin) copy, made by the wrapper: B is
// loaded K-major, the layout whose SW128 descriptor is the same as A's. The
// HWIO weight is MN-major for B; reading it directly needs wgmma's transpose
// bit with the MN-major swizzle atom, a second descriptor layout to prove.
// The copy moves 2 x 4.7 MB at most per call (about 3 us at the HBM rate,
// against 100+ us of product) and is left for a later PR.
//
// Budget per CTA (256 threads; the fp32 accumulators BN / 2 registers a
// thread): shared memory max(ring, epilogue) + 1 KB alignment slack, with
// the ring 4 x (128 + BN) x 128 bytes = 96 / 128 / 192 KB for BN = 64 / 128
// / 256, and the epilogue (y staged as fp32 128 x (BN + 8), partial and
// segment sums, coefficients) reusing it: 61 / 101 / 182 KB. BN = 64 fits
// two CTAs an SM (128 registers a thread at most), BN = 128 and 256 one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;         // tile rows: two consumer warpgroups of 64
constexpr int kThreads = 256;
constexpr int kBK = 64;          // bf16 per K step: one 128-byte row
constexpr int kStages = 4;       // ring slots; two loads ahead of the product
constexpr int kMaxPack = 8;      // samples per tile, pack route
constexpr int kMaxCluster = 8;   // CTAs per sample, cluster route (portable)

enum Route { kCluster = 1, kPack = 2 };

struct Geo {
  int b, h, w, cin, cout, m, gw;  // m = h w rows per sample; gw = Cout / groups
  int route, p, cs;               // samples per tile (pack), CTAs per cluster
  float eps;
  int relu;
};

template <int BN>
constexpr int ring_bytes() { return kStages * (kBM + BN) * 128; }

template <int BN>
constexpr int epilogue_bytes() {
  // ys, psum [2][kMaxPack][NP][BN], segsum [2][kMaxPack][BN], tot [2][BN],
  // coef [2][kMaxPack][BN]
  return 4 * (kBM * (BN + 8) + 2 * kMaxPack * kThreads + 2 * kMaxPack * BN + 2 * BN +
              2 * kMaxPack * BN);
}

template <int BN>
constexpr int smem_bytes() {
  return (ring_bytes<BN>() > epilogue_bytes<BN>() ? ring_bytes<BN>()
                                                  : epilogue_bytes<BN>()) + 1024;
}

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy into shared memory; `bytes` 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// makes this thread's completed cp.async writes visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the float at the same shared-memory offset as `local` in cluster CTA `rank`
__device__ __forceinline__ float ld_cluster(const float* local, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO), the leading offset unused for this layout (1);
// `saddr` within a 1024-byte-aligned tile, advanced by 32 bytes per k16 step
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// D (64 x N, fp32, registers) += A (64 x 16, shared) * B (16 x N, shared);
// scale-d is 1 (the accumulators start at zero)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64)
    wgmma_n64(d, da, db);
  else if constexpr (BN == 128)
    wgmma_n128(d, da, db);
  else
    wgmma_n256(d, da, db);
}

// grid: cluster route (cs, Cout tiles, B) in clusters of (cs, 1, 1); pack
// route (ceil(B / p), Cout tiles, 1). 256 threads; smem_bytes<BN>() dynamic.
template <int BN>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv3x3_gn_sm90(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                const float* __restrict__ scale, const float* __restrict__ bias,
                bf16* __restrict__ out, float* __restrict__ mu,
                float* __restrict__ rstd, Geo g) {
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

  // A rows this thread loads (fixed for the whole K loop): the sample
  // pixel's address at channel chunk `chunk`, and its (oh, ow); rows past
  // the tile's samples get an (oh, ow) that every tap leaves outside the image
  const int chunk = tid & 7;
  const bf16* a_src[kRowsA];
  int a_oh[kRowsA], a_ow[kRowsA];
#pragma unroll
  for (int q = 0; q < kRowsA; ++q) {
    const int r = tid / 8 + q * kRowStep;
    a_src[q] = x;
    a_oh[q] = a_ow[q] = -4;
    if (r < v_rows) {
      const long long row = r0 + r;
      const long long bb = row / g.m;
      const int mm = static_cast<int>(row - bb * g.m);
      a_oh[q] = mm / g.w;
      a_ow[q] = mm - a_oh[q] * g.w;
      a_src[q] = x + (bb * g.m + mm) * g.cin + chunk * 8;
    }
  }
  const int kc = (g.cin + kBK - 1) / kBK;
  const int kt_n = 9 * kc;

  auto load_stage = [&](int kt, int slot) {
    const int tap = kt / kc, k0 = (kt - tap * kc) * kBK;
    const int dy = tap / 3 - 1, dx = tap - (tap / 3) * 3 - 1;
    const bool kin = k0 + chunk * 8 < g.cin;
    const uint32_t sa = base_s + slot * kStageBytes;
    const uint32_t sb = sa + kBM * 128;
    const int shift = (dy * g.w + dx) * g.cin + k0;
#pragma unroll
    for (int q = 0; q < kRowsA; ++q) {
      const int r = tid / 8 + q * kRowStep;
      const int ih = a_oh[q] + dy, iw = a_ow[q] + dx;
      const bool ok = kin && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w;
      cp_async16(sa + r * 128 + ((chunk ^ (r & 7)) << 4), ok ? a_src[q] + shift : x,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int q = 0; q < kRowsB; ++q) {
      const int r = tid / 8 + q * kRowStep;
      const bool ok = kin && n0 + r < g.cout;
      const bf16* src =
          ok ? wt + (static_cast<size_t>(tap) * g.cout + n0 + r) * g.cin + k0 + chunk * 8
             : wt;
      cp_async16(sb + r * 128 + ((chunk ^ (r & 7)) << 4), src, ok ? 16 : 0);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);

  // ring: stage kt in slot kt % kStages; stages kt + 1 and kt + 2 load while
  // stage kt multiplies and stage kt - 1's wgmma may still run
#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < kt_n) load_stage(s, s);
    cp_async_commit();
  }
  const int wg = tid >> 7;
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kStages - 3>();  // this thread's copies of stage kt landed
    fence_proxy_async();
    // every copy of stage kt is visible, and every warpgroup's wgmma of stage
    // kt - 2 is done (its wait<1> below), so slot (kt + 2) % 4 is free
    __syncthreads();
    if (kt + kStages - 2 < kt_n) load_stage(kt + kStages - 2, (kt + kStages - 2) % kStages);
    cp_async_commit();
    const uint32_t sa = base_s + (kt % kStages) * kStageBytes + wg * 64 * 128;
    const uint32_t sb = base_s + (kt % kStages) * kStageBytes + kBM * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_tile<BN>(acc, desc_sw128(sa + kk * 32), desc_sw128(sb + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();
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
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(o0, o1);
      packed[e] = *reinterpret_cast<const uint32_t*>(&h2);
    }
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(r0 + r) * g.cout + n) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

template <int BN>
cudaError_t launch(const Geo& g, const void* x, const void* wt, const float* scale,
                   const float* bias, void* out, float* mu, float* rstd,
                   cudaStream_t st) {
  constexpr int smem = smem_bytes<BN>();
  auto kern = conv3x3_gn_sm90<BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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

}  // namespace

// tb_conv3x3_gn_sm90: out = relu(group_norm(conv3x3(x, w))) for bf16 x (B, H,
// W, Cin) and the weight as wt (9, Cout, Cin) bf16; scale, bias (Cout,) fp32;
// out (B, H, W, Cout) bf16; mu, rstd (B, Cout) fp32. Every pointer a
// contiguous, 16-byte-aligned device buffer. The plan (route 1 cluster or 2
// pack, bm, bn, p samples a tile, cluster CTAs a sample) comes from
// `plan_conv3x3`; a plan this kernel cannot run returns cudaErrorInvalidValue
// without launching. Otherwise returns the launch's CUDA error code.
extern "C" int tb_conv3x3_gn_sm90(const void* x, const void* wt, const float* scale,
                                  const float* bias, void* out, float* mu, float* rstd,
                                  int b, int h, int w, int cin, int cout, int groups,
                                  float eps, int relu, int route, int bm, int bn, int p,
                                  int cluster, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || groups <= 0 ||
      cout % groups || cin % 8 || cout % 8 || bm != kBM ||
      (bn != 64 && bn != 128 && bn != 256) || bn % (cout / groups) ||
      (cout + bn - 1) / bn > 65535 || static_cast<long long>(h) * w > (1 << 30))
    return bad;
  Geo g;
  g.b = b;
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.cout = cout;
  g.m = h * w;
  g.gw = cout / groups;
  g.route = route;
  g.p = p;
  g.cs = cluster;
  g.eps = eps;
  g.relu = relu;
  if (route == kCluster) {
    if (p != 1 || cluster != (g.m + kBM - 1) / kBM || cluster < 2 ||
        cluster > kMaxCluster || b > 65535)
      return bad;
  } else if (route == kPack) {
    if (cluster != 1 || g.m > kBM || p < 1 || p > kMaxPack || p * g.m > kBM) return bad;
  } else {
    return bad;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64:
      return static_cast<int>(launch<64>(g, x, wt, scale, bias, out, mu, rstd, st));
    case 128:
      return static_cast<int>(launch<128>(g, x, wt, scale, bias, out, mu, rstd, st));
    default:
      return static_cast<int>(launch<256>(g, x, wt, scale, bias, out, mu, rstd, st));
  }
}
