// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of
// torchbooster_tpu/ops/flash_attention.py (the custom_vjp at :377-399):
//   B1 `_fwd_kernel` (:104, pallas_call :180)  -> flash_fwd_mma / flash_fwd
//   B2 `_dq_kernel`  (:227, pallas_call :324)  -> flash_dq_mma  / flash_dq
//   B3 `_dkv_kernel` (:265, pallas_call :351)  -> flash_dkv_mma / flash_dkv
// Operands are the TPU kernels': q (BH, S_q, D), k/v (BH_kv, S_kv, D) with
// BH % BH_kv == 0 and q row b reading grouped k/v row b / rep (GQA), o and
// dO like q, lse fp32 (BH, S_q) (plain rows, not the TPU's 8-lane padding).
// Head dims 32, 48, 64, 128. Two routes of the same algorithm, chosen by
// dtype: bf16 runs the *_mma kernels (tensor cores, mma.sync m16n8k16, fp32
// accumulators; P and dS round to bf16 before their second product, as in
// FlashAttention-2); fp32 runs CUDA-core fp32 products throughout, so fp32
// inputs stay within 1e-4 of the plain version. The bf16 forward and
// backward at head dims 64 and 128 run the wgmma kernels of
// flash_fwd_sm90.cu and flash_bwd_sm90.cu instead (the "sm90" route,
// planned by `plan_flash_fwd` / `plan_flash_bwd`); the *_mma kernels keep
// D 32 (64-byte rows, a swizzle the wgmma kernels do not build) and D 48
// (96-byte rows, which fit none of the 32/64/128-byte swizzles), and are
// timed beside them.
//
// Numerics follow the TPU kernels: q is scaled before the product
// ((q * scale) K^T; the tensor-core route scales the fp32 scores, the same
// number up to rounding); the causal mask writes -1e30 into the SCORES
// before the running max (keys visible to query i are [0, i + S_kv - S_q]:
// queries align to the last keys); the backward recomputes
// P = exp(scale q K^T - lse) with the mask applied before the exp. Keys past
// a ragged S_kv are left out altogether (probability 0), so any length
// works, S = 1000 included.
//
// The TPU grid walks the KV axis sequentially with the softmax state in VMEM
// scratch. Here every CTA owns one 64-row tile and loops over the other
// axis itself:
//   B1, grid (q tiles, BH): loops over the KV tiles visible to its last
//     query row, online softmax in registers, writes O and lse once.
//   B2, grid (q tiles, BH): delta = rowsum(dO o O) from its own tiles (also
//     written to a (BH, S_q) fp32 buffer for B3, which runs after it on the
//     same stream), then loops over the visible KV tiles:
//     dS = P o (dO V^T - delta), dQ += scale dS K. dQ is written once.
//   B3, grid (KV tiles, BH_kv): K and V stay in shared memory while the CTA
//     sweeps every q tile that can see them, for each of the rep query heads
//     of its group: dV += P^T dO, dK += scale dS^T Q. Grouped dK/dV are
//     written once, with no atomics, as on the TPU.
//
// What bounds it: attention does 2 (forward) or 5 (backward) products of
// S_q x S_kv x D per head, times the causal visible share, against bytes of
// order BH S D: far above the card's ~295 flop/byte ridge, so the bound is
// operations, at the bf16 tensor-core rate. Neither route reaches it. The
// tensor-core route loads each tile with plain loads (operands needed along
// their other axis are transposed element by element as they are stored),
// waits for every load before computing (no cp.async / TMA pipeline) and
// runs 4 warps per CTA; ldmatrix fragment loads, a cp.async or TMA ring and
// wgmma are the next steps. The CUDA-core route (256 threads, each a 4 x 4
// block of a 64 x 64 tile) is bound by shared-memory loads under the fp32
// peak of 67 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the JAX package's mask value (never -inf)
constexpr int kTile = 64;          // rows of a q tile and of a kv tile
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 elements each
constexpr int kPLd = kTile + 1;    // row stride of the P / dS tiles

enum DType { kF32 = 0, kBF16 = 1 };

// ------------------------------------------------------------------------
// fp32 route: CUDA-core products
// ------------------------------------------------------------------------


// reductions over the 16 threads that share a row group (one half-warp)
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0 + kTile) of a (rows, D) fp32 matrix into shared memory
// with row stride D + 1 (odd: a column walk hits 32 distinct banks); rows
// past `rows` read as zeros
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int row0, int rows, float scale) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] =
        row < rows ? src[static_cast<size_t>(row) * D + d] * scale : 0.f;
  }
}

// visible KV tiles of q tile [q0, q0 + kTile): the loop stops at the tile
// of the last key seen by the tile's last query row
__device__ __forceinline__ int kv_tiles(int q0, int s_q, int s_kv, int causal) {
  int n = (s_kv + kTile - 1) / kTile;
  if (causal) {
    const int last_key = min(q0 + kTile, s_q) - 1 + (s_kv - s_q);
    n = last_key < 0 ? 0 : min(n, last_key / kTile + 1);
  }
  return n;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
          int s_q, int s_kv, int rep, int causal, float sm_scale) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kTile * LD;
  float* sv = sk + kTile * LD;
  float* sp = sv + kTile * LD;

  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int offset = s_kv - s_q;
  const float* kb = k + static_cast<size_t>(bh / rep) * s_kv * D;
  const float* vb = v + static_cast<size_t>(bh / rep) * s_kv * D;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<D>(sq, q + static_cast<size_t>(bh) * s_q * D, q0, s_q, sm_scale);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = kv_tiles(q0, s_q, s_kv, causal);
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's readers of sk/sv/sp are done
    load_tile<D>(sk, kb, k0, s_kv, 1.f);
    load_tile<D>(sv, vb, k0, s_kv, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sq[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sk[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (kj >= s_kv) s[i][j] = -INFINITY;                 // past a ragged end
        else if (causal && kj > qi + offset) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[(ty * 4 + i) * kPLd + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sp[(ty * 4 + i) * kPLd + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sv[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s_q) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* orow = o + (static_cast<size_t>(bh) * s_q + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0) lse[static_cast<size_t>(bh) * s_q + row] = m[i] + logf(l[i]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ o,
         const float* __restrict__ dout, const float* __restrict__ lse,
         float* __restrict__ delta_out, float* __restrict__ dq, int s_q, int s_kv,
         int rep, int causal, float sm_scale) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kTile * LD;
  float* sk = sdo + kTile * LD;
  float* sv = sk + kTile * LD;
  float* sds = sv + kTile * LD;

  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int offset = s_kv - s_q;
  const size_t qbase = static_cast<size_t>(bh) * s_q * D;
  const float* kb = k + static_cast<size_t>(bh / rep) * s_kv * D;
  const float* vb = v + static_cast<size_t>(bh / rep) * s_kv * D;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<D>(sq, q + qbase, q0, s_q, sm_scale);
  load_tile<D>(sdo, dout + qbase, q0, s_q, 1.f);
  __syncthreads();

  // delta = rowsum(dO o O) in fp32, from tiles this CTA holds anyway
  float delta[4], row_lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    float part = 0.f;
    if (row < s_q) {
      const float* orow = o + qbase + static_cast<size_t>(row) * D;
      for (int d = tx; d < D; d += 16) part += orow[d] * sdo[(ty * 4 + i) * LD + d];
    }
    delta[i] = row_sum(part);
    row_lse[i] = row < s_q ? lse[static_cast<size_t>(bh) * s_q + row] : 0.f;
    if (row < s_q && tx == 0) delta_out[static_cast<size_t>(bh) * s_q + row] = delta[i];
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const int n_kv = kv_tiles(q0, s_q, s_kv, causal);
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<D>(sk, kb, k0, s_kv, 1.f);
    load_tile<D>(sv, vb, k0, s_kv, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], b[4], g[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sq[(ty * 4 + i) * LD + d];
        g[i] = sdo[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = sk[(tx + 16 * j) * LD + d];
        w[j] = sv[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float p = 0.f;
        if (qi < s_q && kj < s_kv) {
          const float sc = (causal && kj > qi + offset) ? kNegInf : s[i][j];
          p = expf(sc - row_lse[i]);
        }
        sds[(ty * 4 + i) * kPLd + tx + 16 * j] = p * (dp[i][j] - delta[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float ds[4], kv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sds[(ty * 4 + i) * kPLd + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = sk[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s_q) continue;
    float* drow = dq + qbase + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) drow[tx + 16 * c] = sm_scale * acc[i][c];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dk, float* __restrict__ dv, int s_q, int s_kv, int rep,
          int causal, float sm_scale) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kTile * LD;
  float* sq = sv + kTile * LD;
  float* sdo = sq + kTile * LD;
  float* sp = sdo + kTile * LD;
  float* sds = sp + kTile * kPLd;

  const int k0 = blockIdx.x * kTile;
  const int bkv = blockIdx.y;
  const int offset = s_kv - s_q;
  const size_t kvbase = static_cast<size_t>(bkv) * s_kv * D;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<D>(sk, k + kvbase, k0, s_kv, 1.f);
  load_tile<D>(sv, v + kvbase, k0, s_kv, 1.f);

  // dK/dV rows ty*4+i of this kv tile, columns tx + 16c
  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // causal: the first q tile holding a row that sees key k0
  const int first_q = causal ? max(0, k0 - offset) : 0;
  const int n_q = (s_q + kTile - 1) / kTile;
  for (int r = 0; r < rep; ++r) {
    const int bh = bkv * rep + r;
    const size_t qbase = static_cast<size_t>(bh) * s_q * D;
    for (int qt = first_q / kTile; qt < n_q; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile<D>(sq, q + qbase, q0, s_q, sm_scale);
      load_tile<D>(sdo, dout + qbase, q0, s_q, 1.f);
      __syncthreads();

      // scores of q rows ty*4+i against kv columns tx + 16j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[4], b[4], g[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = sq[(ty * 4 + i) * LD + d];
          g[i] = sdo[(ty * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = sk[(tx + 16 * j) * LD + d];
          w[j] = sv[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i], b[j], s[i][j]);
            dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty * 4 + i;
        const bool row_ok = qi < s_q;
        const size_t ri = static_cast<size_t>(bh) * s_q + (row_ok ? qi : 0);
        const float row_lse = lse[ri];
        const float row_delta = delta[ri];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = k0 + tx + 16 * j;
          float p = 0.f;
          if (row_ok && kj < s_kv) {
            const float sc = (causal && kj > qi + offset) ? kNegInf : s[i][j];
            p = expf(sc - row_lse);
          }
          sp[(ty * 4 + i) * kPLd + tx + 16 * j] = p;
          sds[(ty * 4 + i) * kPLd + tx + 16 * j] = p * (dp[i][j] - row_delta);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T (q scale): sq already holds q * scale
#pragma unroll 4
      for (int qq = 0; qq < kTile; ++qq) {
        float p[4], ds[4], gd[NC], qv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = sp[qq * kPLd + ty * 4 + i];
          ds[i] = sds[qq * kPLd + ty * 4 + i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          gd[c] = sdo[qq * LD + tx + 16 * c];
          qv[c] = sq[qq * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc_v[i][c] = fmaf(p[i], gd[c], acc_v[i][c]);
            acc_k[i][c] = fmaf(ds[i], qv[c], acc_k[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= s_kv) continue;
    float* krow = dk + kvbase + static_cast<size_t>(row) * D;
    float* vrow = dv + kvbase + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      krow[tx + 16 * c] = acc_k[i][c];
      vrow[tx + 16 * c] = acc_v[i][c];
    }
  }
}

// ------------------------------------------------------------------------
// bf16 route: the same three kernels with their products on tensor cores
// (mma.sync m16n8k16, bf16 operands, fp32 accumulators), FlashAttention-2
// style: each warp owns 16 rows of the tile, scores stay in registers, and
// the score accumulators are re-packed in place as the A operand of the
// next product (P V, dS K, P^T dO, dS^T Q), so P and dS round once to bf16
// there. Tiles live in shared memory as bf16 with rows padded by 8 elements
// (fragment loads hit 32 distinct banks); an operand that must be read
// along its other axis is stored transposed as it is loaded.
// ------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kWarpsMma = 4;
constexpr int kThreadsMma = 32 * kWarpsMma;
constexpr int kTileDkvQ = 32;  // q rows per sweep step of flash_dkv_mma

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment (16 x 16, row-major source, `base` at (row 0, k 0))
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* base, int ld) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  a[0] = ld32(base + g * ld + 2 * t);
  a[1] = ld32(base + (g + 8) * ld + 2 * t);
  a[2] = ld32(base + g * ld + 2 * t + 8);
  a[3] = ld32(base + (g + 8) * ld + 2 * t + 8);
}

// B fragment (16 x 8, k x n) from storage that holds each n as a row with
// k contiguous; `base` at (n 0, k 0)
__device__ __forceinline__ void frag_b(uint32_t b[2], const bf16* base, int ld) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  b[0] = ld32(base + g * ld + 2 * t);
  b[1] = ld32(base + g * ld + 2 * t + 8);
}

// two adjacent 16 x 8 accumulators (k columns 0-7 and 8-15) as one A fragment
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4],
                                         const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// rows [row0, row0 + ROWS) of a (rows, D) bf16 matrix into shared memory,
// 16 bytes per load, row stride ld; rows past `rows` read as zeros
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* __restrict__ src,
                                          int row0, int rows) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreadsMma) {
    const int r = i / kVec;
    const int c = (i - r * kVec) * 8;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < rows)
      val = *reinterpret_cast<const int4*>(src + static_cast<size_t>(row0 + r) * D + c);
    *reinterpret_cast<int4*>(dst + r * ld + c) = val;
  }
}

// the same rows stored transposed: dst[d * ld + r] = src[row0 + r][d]
template <int D, int ROWS>
__device__ __forceinline__ void load_rows_t(bf16* dst, int ld, const bf16* __restrict__ src,
                                            int row0, int rows) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreadsMma) {
    const int r = i / D;
    const int d = i - r * D;
    dst[d * ld + r] = row0 + r < rows ? src[static_cast<size_t>(row0 + r) * D + d]
                                      : __float2bfloat16(0.f);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, int s_q, int s_kv, int rep, int causal,
              float sm_scale) {
  constexpr int LD = D + 8, LDT = kTile + 8, KS = D / 16, NT = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + kTile * LD;
  bf16* svt = sk + kTile * LD;  // V transposed: (D, kTile)

  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int offset = s_kv - s_q;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bf16* kb = k + static_cast<size_t>(bh / rep) * s_kv * D;
  const bf16* vb = v + static_cast<size_t>(bh / rep) * s_kv * D;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_rows<D, kTile>(sq, LD, q + static_cast<size_t>(bh) * s_q * D, q0, s_q);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) frag_a(qa[ks], sq + warp * 16 * LD + ks * 16, LD);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int n_kv = kv_tiles(q0, s_q, s_kv, causal);
  for (int tile = 0; tile < n_kv; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();
    load_rows<D, kTile>(sk, LD, kb, k0, s_kv);
    load_rows_t<D, kTile>(svt, LDT, vb, k0, s_kv);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[2];
        frag_b(b, sk + n * 8 * LD + ks * 16, LD);
        mma16816(s[n], qa[ks], b);
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * sm_scale;
        if (kj >= s_kv) x = -INFINITY;  // past a ragged end
        else if (causal && kj > row[e >> 1] + offset) x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = __expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b[2];
        frag_b(b, svt + n * 8 * LDT + kk * 16, LDT);
        mma16816(acc[n], pa, b);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (row[h] >= s_q) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    bf16* orow = o + (static_cast<size_t>(bh) * s_q + row[h]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    if (t == 0) lse[static_cast<size_t>(bh) * s_q + row[h]] = m[h] + logf(l[h]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
flash_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ o,
             const bf16* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ delta_out, bf16* __restrict__ dq, int s_q,
             int s_kv, int rep, int causal, float sm_scale) {
  constexpr int LD = D + 8, LDT = kTile + 8, KS = D / 16, NT = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + kTile * LD;
  bf16* sk = sdo + kTile * LD;
  bf16* sv = sk + kTile * LD;
  bf16* skt = sv + kTile * LD;  // K transposed: (D, kTile)
  float* srow = reinterpret_cast<float*>(skt + D * LDT);  // lse, delta

  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int offset = s_kv - s_q;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const size_t qbase = static_cast<size_t>(bh) * s_q * D;
  const bf16* kb = k + static_cast<size_t>(bh / rep) * s_kv * D;
  const bf16* vb = v + static_cast<size_t>(bh / rep) * s_kv * D;

  load_rows<D, kTile>(sq, LD, q + qbase, q0, s_q);
  load_rows<D, kTile>(sdo, LD, dout + qbase, q0, s_q);
  // delta = rowsum(dO o O) in fp32: two threads per row
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int qi = q0 + r;
    float part = 0.f;
    if (qi < s_q) {
      const bf16* orow = o + qbase + static_cast<size_t>(qi) * D;
      const bf16* drow = dout + qbase + static_cast<size_t>(qi) * D;
      for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d)
        part += __bfloat162float(orow[d]) * __bfloat162float(drow[d]);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      srow[r] = qi < s_q ? lse[static_cast<size_t>(bh) * s_q + qi] : 0.f;
      srow[kTile + r] = part;
      if (qi < s_q) delta_out[static_cast<size_t>(bh) * s_q + qi] = part;
    }
  }
  __syncthreads();
  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};
  const float row_lse[2] = {srow[rl[0]], srow[rl[1]]};
  const float row_delta[2] = {srow[kTile + rl[0]], srow[kTile + rl[1]]};

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_kv = kv_tiles(q0, s_q, s_kv, causal);
  for (int tile = 0; tile < n_kv; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();
    load_rows<D, kTile>(sk, LD, kb, k0, s_kv);
    load_rows<D, kTile>(sv, LD, vb, k0, s_kv);
    load_rows_t<D, kTile>(skt, LDT, kb, k0, s_kv);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t aq[4], ado[4];
      frag_a(aq, sq + warp * 16 * LD + ks * 16, LD);
      frag_a(ado, sdo + warp * 16 * LD + ks * 16, LD);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b[2];
        frag_b(b, sk + n * 8 * LD + ks * 16, LD);
        mma16816(s[n], aq, b);
        frag_b(b, sv + n * 8 * LD + ks * 16, LD);
        mma16816(dp[n], ado, b);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + rl[e >> 1];
        const int kj = k0 + n * 8 + 2 * t + (e & 1);
        float p = 0.f;
        if (qi < s_q && kj < s_kv) {
          const float sc = (causal && kj > qi + offset) ? kNegInf : s[n][e] * sm_scale;
          p = __expf(sc - row_lse[e >> 1]);
        }
        s[n][e] = p * (dp[n][e] - row_delta[e >> 1]);  // dS
      }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t da[4];
      acc_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b[2];
        frag_b(b, skt + n * 8 * LDT + kk * 16, LDT);
        mma16816(acc[n], da, b);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + rl[h];
    if (qi >= s_q) continue;
    bf16* drow = dq + qbase + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(drow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(sm_scale * acc[n][2 * h], sm_scale * acc[n][2 * h + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
flash_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int s_q, int s_kv,
              int rep, int causal, float sm_scale) {
  constexpr int BQ = kTileDkvQ;
  constexpr int LD = D + 8, LDT = BQ + 8, KS = D / 16, NT = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + kTile * LD;
  bf16* sq = sv + kTile * LD;
  bf16* sdo = sq + BQ * LD;
  bf16* sqt = sdo + BQ * LD;    // Q transposed: (D, BQ)
  bf16* sdot = sqt + D * LDT;   // dO transposed: (D, BQ)
  float* srow = reinterpret_cast<float*>(sdot + D * LDT);  // lse, delta

  const int k0 = blockIdx.x * kTile;
  const int bkv = blockIdx.y;
  const int offset = s_kv - s_q;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const size_t kvbase = static_cast<size_t>(bkv) * s_kv * D;
  // this warp's kv rows within the tile
  const int kl[2] = {warp * 16 + g, warp * 16 + g + 8};

  load_rows<D, kTile>(sk, LD, k + kvbase, k0, s_kv);
  load_rows<D, kTile>(sv, LD, v + kvbase, k0, s_kv);

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  // causal: the first q step holding a row that sees key k0
  const int first_q = causal ? max(0, k0 - offset) : 0;
  for (int r = 0; r < rep; ++r) {
    const int bh = bkv * rep + r;
    const size_t qbase = static_cast<size_t>(bh) * s_q * D;
    for (int q0 = (first_q / BQ) * BQ; q0 < s_q; q0 += BQ) {
      __syncthreads();
      load_rows<D, BQ>(sq, LD, q + qbase, q0, s_q);
      load_rows<D, BQ>(sdo, LD, dout + qbase, q0, s_q);
      load_rows_t<D, BQ>(sqt, LDT, q + qbase, q0, s_q);
      load_rows_t<D, BQ>(sdot, LDT, dout + qbase, q0, s_q);
      for (int i = threadIdx.x; i < BQ; i += kThreadsMma) {
        const bool ok = q0 + i < s_q;
        srow[i] = ok ? lse[static_cast<size_t>(bh) * s_q + q0 + i] : 0.f;
        srow[BQ + i] = ok ? delta[static_cast<size_t>(bh) * s_q + q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: kv rows x q columns
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ak[4], av[4];
        frag_a(ak, sk + warp * 16 * LD + ks * 16, LD);
        frag_a(av, sv + warp * 16 * LD + ks * 16, LD);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b[2];
          frag_b(b, sq + n * 8 * LD + ks * 16, LD);
          mma16816(s[n], ak, b);
          frag_b(b, sdo + n * 8 * LD + ks * 16, LD);
          mma16816(dp[n], av, b);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = n * 8 + 2 * t + (e & 1);
          const int qi = q0 + ql;
          const int kj = k0 + kl[e >> 1];
          float p = 0.f;
          if (qi < s_q && kj < s_kv) {
            const float sc = (causal && kj > qi + offset) ? kNegInf : s[n][e] * sm_scale;
            p = __expf(sc - srow[ql]);
          }
          s[n][e] = p;                                   // P^T
          dp[n][e] = p * (dp[n][e] - srow[BQ + ql]);     // dS^T
        }
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t pa[4], da[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t b[2];
          frag_b(b, sdot + n * 8 * LDT + kk * 16, LDT);
          mma16816(acc_v[n], pa, b);
          frag_b(b, sqt + n * 8 * LDT + kk * 16, LDT);
          mma16816(acc_k[n], da, b);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = k0 + kl[h];
    if (kj >= s_kv) continue;
    bf16* krow = dk + kvbase + static_cast<size_t>(kj) * D;
    bf16* vrow = dv + kvbase + static_cast<size_t>(kj) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(krow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(sm_scale * acc_k[n][2 * h], sm_scale * acc_k[n][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
    }
  }
}

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kPLd);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kPLd);
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kPLd);
}
template <int D> constexpr size_t fwd_mma_smem() {
  return sizeof(bf16) * (2 * kTile * (D + 8) + D * (kTile + 8));
}
template <int D> constexpr size_t dq_mma_smem() {
  return sizeof(bf16) * (4 * kTile * (D + 8) + D * (kTile + 8)) +
         sizeof(float) * 2 * kTile;
}
template <int D> constexpr size_t dkv_mma_smem() {
  return sizeof(bf16) * (2 * kTile * (D + 8) + 2 * kTileDkvQ * (D + 8) +
                         2 * D * (kTileDkvQ + 8)) +
         sizeof(float) * 2 * kTileDkvQ;
}

// every instantiation uses more than the default 48 KB of dynamic shared
// memory at D >= 64, which needs an explicit opt-in per kernel
template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// bf16 runs the tensor-core kernels, fp32 the CUDA-core ones
template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int bh_kv, int s_q, int s_kv,
                       int causal, float sm_scale, cudaStream_t st) {
  const dim3 grid((s_q + kTile - 1) / kTile, bh);
  cudaError_t err;
  if constexpr (std::is_same_v<T, bf16>) {
    err = opt_in(flash_fwd_mma<D>, fwd_mma_smem<D>());
    if (err != cudaSuccess) return err;
    flash_fwd_mma<D><<<grid, kThreadsMma, fwd_mma_smem<D>(), st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, s_q, s_kv,
        bh / bh_kv, causal, sm_scale);
  } else {
    err = opt_in(flash_fwd<D>, fwd_smem<D>());
    if (err != cudaSuccess) return err;
    flash_fwd<D><<<grid, kThreads, fwd_smem<D>(), st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, s_q, s_kv,
        bh / bh_kv, causal, sm_scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, int bh, int bh_kv, int s_q,
                      int s_kv, int causal, float sm_scale, cudaStream_t st) {
  const dim3 grid((s_q + kTile - 1) / kTile, bh);
  cudaError_t err;
  if constexpr (std::is_same_v<T, bf16>) {
    err = opt_in(flash_dq_mma<D>, dq_mma_smem<D>());
    if (err != cudaSuccess) return err;
    flash_dq_mma<D><<<grid, kThreadsMma, dq_mma_smem<D>(), st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq),
        s_q, s_kv, bh / bh_kv, causal, sm_scale);
  } else {
    err = opt_in(flash_dq<D>, dq_smem<D>());
    if (err != cudaSuccess) return err;
    flash_dq<D><<<grid, kThreads, dq_smem<D>(), st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), s_q,
        s_kv, bh / bh_kv, causal, sm_scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int bh, int bh_kv, int s_q,
                       int s_kv, int causal, float sm_scale, cudaStream_t st) {
  const dim3 grid((s_kv + kTile - 1) / kTile, bh_kv);
  cudaError_t err;
  if constexpr (std::is_same_v<T, bf16>) {
    err = opt_in(flash_dkv_mma<D>, dkv_mma_smem<D>());
    if (err != cudaSuccess) return err;
    flash_dkv_mma<D><<<grid, kThreadsMma, dkv_mma_smem<D>(), st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), s_q, s_kv,
        bh / bh_kv, causal, sm_scale);
  } else {
    err = opt_in(flash_dkv<D>, dkv_smem<D>());
    if (err != cudaSuccess) return err;
    flash_dkv<D><<<grid, kThreads, dkv_smem<D>(), st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), s_q, s_kv, bh / bh_kv,
        causal, sm_scale);
  }
  return cudaGetLastError();
}

}  // namespace

// The plain C interface (loaded with ctypes). dtype: 0 fp32, 1 bf16; every
// pointer is a contiguous device buffer; returns the CUDA error code of the
// launch (0 on success). Head dims other than 32/48/64/128 and unknown dtypes
// return cudaErrorInvalidValue without launching.
#define TB_DISPATCH(FN, ...)                                                   \
  do {                                                                         \
    if (dtype == kF32) {                                                       \
      if (head_dim == 32) return FN<float, 32>(__VA_ARGS__);                   \
      if (head_dim == 48) return FN<float, 48>(__VA_ARGS__);                   \
      if (head_dim == 64) return FN<float, 64>(__VA_ARGS__);                   \
      if (head_dim == 128) return FN<float, 128>(__VA_ARGS__);                 \
    } else if (dtype == kBF16) {                                               \
      if (head_dim == 32) return FN<__nv_bfloat16, 32>(__VA_ARGS__);           \
      if (head_dim == 48) return FN<__nv_bfloat16, 48>(__VA_ARGS__);           \
      if (head_dim == 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__);           \
      if (head_dim == 128) return FN<__nv_bfloat16, 128>(__VA_ARGS__);         \
    }                                                                          \
    return static_cast<int>(cudaErrorInvalidValue);                            \
  } while (0)

extern "C" int tb_flash_fwd(int dtype, int head_dim, const void* q,
                            const void* k, const void* v, void* o, float* lse,
                            int bh, int bh_kv, int s_q, int s_kv, int causal,
                            float sm_scale, void* stream) {
  TB_DISPATCH(launch_fwd, q, k, v, o, lse, bh, bh_kv, s_q, s_kv, causal,
              sm_scale, static_cast<cudaStream_t>(stream));
}

extern "C" int tb_flash_dq(int dtype, int head_dim, const void* q,
                           const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, float* delta,
                           void* dq, int bh, int bh_kv, int s_q, int s_kv,
                           int causal, float sm_scale, void* stream) {
  TB_DISPATCH(launch_dq, q, k, v, o, dout, lse, delta, dq, bh, bh_kv, s_q,
              s_kv, causal, sm_scale, static_cast<cudaStream_t>(stream));
}

extern "C" int tb_flash_dkv(int dtype, int head_dim, const void* q,
                            const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dk,
                            void* dv, int bh, int bh_kv, int s_q, int s_kv,
                            int causal, float sm_scale, void* stream) {
  TB_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, bh, bh_kv, s_q,
              s_kv, causal, sm_scale, static_cast<cudaStream_t>(stream));
}

#undef TB_DISPATCH
