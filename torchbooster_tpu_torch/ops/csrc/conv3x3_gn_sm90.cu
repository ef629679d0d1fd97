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
// for the normalise epilogue. Here the moments are reduced while y is still
// on the chip (conv_gn_sm90.cuh says how): over a thread-block cluster of the
// sample's CTAs ("cluster", ResNet-18 stages 0 and 1) or per row segment of a
// tile that packs up to 8 samples ("pack", stages 2 and 3). The product runs
// once (38.65 GFLOP per call, not 77) and only out, mu and rstd leave the
// chip; two calls on the same inputs agree bit for bit.
//
// The kernel is `conv_gn_sm90<3, BN>` of conv_gn_sm90.cuh, which B7's 1x1
// instance shares: 4 ring slots, two K steps loading ahead while wgmma runs on
// the current one and one wgmma group in flight across steps (K is 9 taps
// times Cin, in steps of 64 bf16).
//
// The weight stays a (taps, Cout, Cin) copy, made by the wrapper: B is
// loaded K-major, the layout whose SW128 descriptor is the same as A's. The
// HWIO weight is MN-major for B; reading it directly needs wgmma's transpose
// bit with the MN-major swizzle atom. The copy moves 2 x 4.7 MB at most per
// call (about 3 us at the HBM rate, against 100+ us of product) and is left
// for a later PR.
//
// Budget per CTA (256 threads; the fp32 accumulators BN / 2 registers a
// thread): shared memory max(ring, epilogue) + 1 KB alignment slack, with
// the ring 4 x (128 + BN) x 128 bytes = 96 / 128 / 192 KB for BN = 64 / 128
// / 256, and the epilogue 61 / 101 / 182 KB. BN = 64 fits two CTAs an SM
// (128 registers a thread at most), BN = 128 and 256 one.

#include "conv_gn_sm90.cuh"

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
  using namespace conv_gn;
  Geo g;
  g.b = b;
  g.h = g.ho = h;
  g.w = g.wo = w;
  g.cin = cin;
  g.cout = cout;
  g.stride = 1;
  g.pad = 1;
  g.eps = eps;
  g.relu = relu;
  if (!plan_ok(g, groups, route, bm, bn, p, cluster, 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64:
      return static_cast<int>(launch<3, 64>(g, x, wt, scale, bias, out, mu, rstd, st));
    case 128:
      return static_cast<int>(launch<3, 128>(g, x, wt, scale, bias, out, mu, rstd, st));
    default:
      return static_cast<int>(launch<3, 256>(g, x, wt, scale, bias, out, mu, rstd, st));
  }
}
