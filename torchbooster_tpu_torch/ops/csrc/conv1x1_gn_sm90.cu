// Fused 1x1 convolution (any stride) + GroupNorm (+ReLU), forward, for Hopper
// (sm_90a): the one-pass tensor-core route of B7.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// torchbooster_tpu/ops/fused_block.py (:70, pallas_call :139): 1x1 conv +
// GroupNorm + ReLU, with the stride-s projection's strided slice (:391-392)
// read as strided addressing, for bf16 operands whose Cin and Cout are
// multiples of 8 and whose sample spans at most eight 128-row tiles. Other
// shapes (Cin 12, ResNet-50's 56 x 56 maps), and fp32, keep the two-pass
// kernels of fused_block.cu; the route is planned before launch by
// `plan_conv1x1` (ops/fused_block.py).
//
// It computes out[b, oh, ow, n] = sum over k of x[b, oh s, ow s, k] w[k, n]
// in fp32, Ho = ceil(H / s), Wo = ceil(W / s) (JAX's x[:, ::s, ::s, :]); the
// group moments of that fp32 y, NOT clamped (:84); out = relu(y a + b) in
// bf16; mu and rstd (B, Cout) fp32 for `conv1x1_gn_backward`.
//
// Bound: bytes. At ResNet-18's three stride-2 projections (batch 512) K is
// Cin = 64, 128, 256: 42-166 flops per operand byte against the card's ~295,
// so a call is 4.5-15.2 us of bytes (the strided quarter of x, w, out) and
// about 2 us of products at the bf16 peak.
//
// What the design does about it. The two-pass kernel computed the product
// twice, with a moments launch between (three launches), waited on every
// plain load, and at the 4 x 4 map re-read the weight once per sample in
// both passes (about 268 MB of weight reads against 12.6 MB of operands).
// This is `conv_gn_sm90<1, BN>` of conv_gn_sm90.cuh, B8's one-pass kernel at
// one tap: one launch (the weight read as it lies, MN-major, with no copy
// before it), the product once, y reduced on the chip (a cluster of 2 CTAs a
// sample at 16 x 16 outputs; 2 and 8 samples packed into a tile at 8 x 8 and
// 4 x 4, so the weight is read B / p times). Its ring is sized to K (3
// slots, two steps ahead of the one multiplying) and fits inside the
// epilogue, and BN is at most 128, so two CTAs share an SM at every shape
// (`tb_conv1x1_gn_sm90_occupancy` reports it): one CTA's loads run under the
// other's product and epilogue.

#include "conv_gn_sm90.cuh"

// tb_conv1x1_gn_sm90: out = relu(group_norm(conv1x1(x, wgt, stride))) for
// bf16 x (B, H, W, Cin) and the weight wgt (1, 1, Cin, Cout) bf16 as it lies;
// scale, bias (Cout,) fp32; out (B, Ho, Wo, Cout) bf16 with Ho = ceil(H /
// stride), Wo = ceil(W / stride); mu, rstd (B, Cout) fp32. Every pointer a contiguous,
// 16-byte-aligned device buffer. The plan (route 1 cluster or 2 pack, bm, bn
// <= 128, p samples a tile, cluster CTAs a sample) comes from `plan_conv1x1`;
// a plan this kernel cannot run returns cudaErrorInvalidValue without
// launching. Otherwise returns the launch's CUDA error code.
extern "C" int tb_conv1x1_gn_sm90(const void* x, const void* wgt, const float* scale,
                                  const float* bias, void* out, float* mu, float* rstd,
                                  int b, int h, int w, int cin, int cout, int groups,
                                  int stride, float eps, int relu, int route, int bm,
                                  int bn, int p, int cluster, void* stream) {
  using namespace conv_gn;
  if (stride <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Geo g;
  g.b = b;
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.cout = cout;
  g.stride = stride;
  g.pad = 0;
  g.ho = (h + stride - 1) / stride;
  g.wo = (w + stride - 1) / stride;
  g.eps = eps;
  g.relu = relu;
  if (!plan_ok(g, groups, route, bm, bn, p, cluster, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64)
    return static_cast<int>(launch<1, 64>(g, x, wgt, scale, bias, out, mu, rstd, st));
  return static_cast<int>(launch<1, 128>(g, x, wgt, scale, bias, out, mu, rstd, st));
}

// CTAs of the Cout-tile-`bn` instance that share one SM (registers, shared
// memory and threads together), from cudaOccupancyMaxActiveBlocksPerMultiprocessor;
// -1 for a bn the route does not build or on error
extern "C" int tb_conv1x1_gn_sm90_occupancy(int bn) {
  if (bn == 64) return conv_gn::occupancy<1, 64>();
  if (bn == 128) return conv_gn::occupancy<1, 128>();
  return -1;
}
