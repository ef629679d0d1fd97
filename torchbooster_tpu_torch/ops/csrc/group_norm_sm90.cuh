// What the one-pass GroupNorm kernels for Hopper (sm_90a) share: B5's forward
// (group_norm_fwd_sm90.cu) and B6's backward (group_norm_bwd_sm90.cu). Both
// hold a sample's run of positions in shared memory, threads side by side
// along the channels 8 bf16 a thread, and add their per-channel sums across
// the CTAs of a thread-block cluster over distributed shared memory in rank
// order, so every CTA derives the same group statistics bit for bit with no
// atomics; the cluster launch with more than 48 KB of dynamic shared memory.

#pragma once

#include "sm90_wgmma.cuh"

namespace gn_sm90 {

using namespace sm90;

constexpr int kThreads = 256;
constexpr int kVec = 8;           // bf16 channels per 16-byte chunk
constexpr int kMaxCluster = 8;    // CTAs per sample (portable cluster size)
constexpr int kMaxC = kVec * kThreads;
constexpr int kParts = 4;         // cp.async groups a run lands in, at most
constexpr int kMinPartRows = 16;  // positions of one group, at least
constexpr int kMaxSmem = 227 * 1024;

// 8 bf16 at a 16-byte-aligned shared address as fp32
__device__ __forceinline__ void load8(float (&out)[kVec], const bf16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 8 fp32 at a 16-byte-aligned global address
__device__ __forceinline__ void ldg8(float (&out)[kVec], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

// waits for this thread's cp.async groups up to and including part k of
// kParts committed in order
__device__ __forceinline__ void wait_part(int k) {
  if (k == 0) cp_async_wait<kParts - 1>();
  if (k == 1) cp_async_wait<kParts - 2>();
  if (k == 2) cp_async_wait<kParts - 3>();
  if (k == 3) cp_async_wait<0>();
}

// totals[j] = the sum over the cluster's cs CTAs, in rank order, of their
// sums[j] (j < count): every rank's value is loaded at once, then added in
// order, so every CTA gets the same bits. `totals` must not alias `sums`. The
// second barrier keeps each CTA's sums alive until its peers have read them
// and makes the totals visible to the whole CTA.
__device__ __forceinline__ void cluster_totals(const float* sums, float* totals, int count,
                                               int cs) {
  cluster_sync();
  for (int j = threadIdx.x; j < count; j += kThreads) {
    float v[kMaxCluster];
#pragma unroll
    for (int rk = 0; rk < kMaxCluster; ++rk)
      if (rk < cs) v[rk] = ld_cluster(sums + j, rk);
    float t = 0.f;
#pragma unroll
    for (int rk = 0; rk < kMaxCluster; ++rk)
      if (rk < cs) t += v[rk];
    totals[j] = t;
  }
  cluster_sync();
}

// launches `kernel` on `grid` (clusters of (cs, 1, 1) along x when cs > 1)
// with kThreads threads and `smem` bytes of dynamic shared memory; returns the
// CUDA error code
template <typename... Params, typename... Args>
inline int launch(void (*kernel)(Params...), dim3 grid, int cs, int smem, void* stream,
                  Args... args) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (cs > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of `kernel` at `smem` bytes that share one SM (registers, shared
// memory and threads together); -1 on error
template <typename K>
inline int occupancy(K kernel, int smem) {
  int blocks = 0;
  if (set_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace gn_sm90
