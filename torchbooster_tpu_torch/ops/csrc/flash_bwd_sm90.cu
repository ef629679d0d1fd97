// Flash attention backward for Hopper (sm_90a): the bf16 "sm90" route of
// B2 and B3, as wgmma kernels fed by a cp.async copy ring.
//
// Replaces the Pallas TPU kernels of torchbooster_tpu/ops/flash_attention.py
// (bound by the custom_vjp at :377-399):
//   B2 `_dq_kernel`  (:227, pallas_call :324) -> flash_dq_sm90
//   B3 `_dkv_kernel` (:265, pallas_call :351) -> flash_dkv_sm90
// for bf16 operands at head dims 48, 64 and 128 with 1 <= S_q <= S_kv. The route
// is planned before launch by `plan_flash_bwd` (ops/flash_attention.py);
// other shapes and fp32 keep the kernels of flash_attention.cu.
//
// Semantics are those kernels' (and the TPU's): q (BH, S_q, D), k/v (BH_kv,
// S_kv, D), q row b reads grouped k/v row b / rep; o and dO like q; lse and
// delta fp32 (BH, S_q). P = exp(scale S - lse) with the causal mask (-1e30
// into the scaled score before the exp; query i sees keys [0, i + S_kv -
// S_q]); keys past S_kv have probability 0 and rows past S_q are not
// written; P and dS round once to bf16 before their second product.
//   B2: delta = rowsum(dO o O) (fp32, also written for B3), dS = P o (dO V^T
//       - delta), dQ = scale dS K, written once.
//   B3: dV = sum over the group's query heads of P^T dO, dK = scale sum dS^T
//       Q, written once into the grouped rows, with no atomics.
//
// Bound. At GPT-2 small's training shape (B 8, H 12, S 1024, D 64, causal)
// B2 does 3 products and B3 4 over the 50.3 M visible (q, k) pairs: 19.3
// and 25.8 GFLOP, 19.6 and 26.1 us at 989 TFLOP/s; each reads and writes six
// 12.6 MB tensors (q, k, v, o, dO, dq for B2; q, k, v, dO, dk, dv for B3),
// 22.5 us at 3.35 TB/s. So B2 is bound by bytes and B3 by operations, by
// small margins: both sit near the card's ridge.
//
// At gpt-long's geometry (B 8, H 16 over 8 kv heads, S 8192, D 48, causal)
// the 4.30 G visible pairs make 1.24 and 1.65 TFLOP, 1,250.9 and 1,667.8 us
// at 989 TFLOP/s, against 153 and 122 us of bytes: both are bound by
// operations. At D 48 the products over D take three k16 steps and those
// whose N is D (dQ, dK, dV) run as m64n48k16: no padded work.
//
// Design. Every operand tile lives in shared memory in one layout: rows of
// 128 bytes (64 bf16 of one row; a 128-wide head is two 64-column blocks;
// a 48-wide head fills 96 bytes of each row and leaves the last two chunks
// unused), the 16-byte chunks of row r swizzled by r % 8 (SW128). wgmma reads that
// layout K-major when D is the reduction axis and MN-major (the transpose bit
// of the instruction) when the rows are, so one copy of K (B2) or of Q and dO
// (B3) serves both products that use it, and nothing is transposed as it is
// stored. A B2 CTA is two consumer warpgroups of 64 q rows (256 threads), a
// B3 CTA one warpgroup of 64 kv rows (128 threads); the tile that streams
// (K and V for B2; Q, dO, lse and delta for B3) flows through a ring of
// kStages slots filled by 16-byte cp.async copies (zero fill past the
// ragged end), kStages - 1 steps ahead of the products. The
// score products S = Q K^T and dP = dO V^T (B2), S^T = K Q^T and dP^T = V
// dO^T (B3) run from shared memory; P and dS stay in registers, re-packed
// from the fp32 accumulators into wgmma's register-A operand
// (FlashAttention-3's pattern) for dQ += dS K, dV += P^T dO, dK += dS^T Q.
// The mask runs only on tiles that cross the diagonal or the ragged end; a
// B2 warpgroup skips a step its rows cannot see. Causal B2 launches the q
// tiles that see the most keys first and B3 the kv tiles seen by the most
// queries first, so the short tiles fill the last wave.
//
// Budget per CTA (dynamic shared memory, + 1 KB alignment slack):
//   B2: Q, dO (128 x D) + kStages x (K, V (64 x D)) + lse, delta (128 fp32):
//       D 48 and 64: 32 + 3 x 16 + 1 = 81 KB; D 128: 64 + 2 x 32 + 1 = 129 KB.
//   B3: K, V (64 x D) + kStages x (Q, dO (BQ x D) + lse, delta (BQ fp32)),
//       BQ = 64 at D 48 and 64, 32 at D 128 (the dK and dV accumulators take
//       D registers a thread): D 48 and 64: 16 + 3 x 16.5 = 65.5 KB; D 128:
//       32 + 3 x 16.25 = 80.75 KB.
// (D 48 rows take 128 bytes in shared memory, as D 64's.) Several CTAs
// share an SM, so one CTA's softmax overlaps another's products: B2 two at
// D 48 and 64 (at most 128 registers a thread; one at D 128), B3 three at D
// 48 and 64 and two at D 128. On one H100 these beat the other
// layouts tried (B2 as one-warpgroup CTAs, three or four an SM; B3 as
// two-warpgroup CTAs, one an SM, or 32-row q steps at two an SM).
//
// The PTX helpers live in sm90_wgmma.cuh, shared with flash_fwd_sm90.cu (B1).

#include <math.h>

#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

constexpr float kNegInf = -1e30f;  // the JAX package's mask value (never -inf)
constexpr int kMaxTiles = 65535;   // grid.y limit: q tiles (B2), kv tiles (B3)

// ------------------------------------------------------------------ B2
template <int D>
struct DqCfg {
  static constexpr int kThreads = 256;  // two consumer warpgroups
  static constexpr int kBQ = 128;       // q rows a CTA, 64 a warpgroup
  static constexpr int kBK = 64;        // kv rows a ring step
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr int kTileQ = kBQ * kRowBytes<D>;  // bytes of Q (or dO)
  static constexpr int kTileK = kBK * kRowBytes<D>;  // bytes of K (or V) a step
  static constexpr int kSmem = 2 * kTileQ + kStages * 2 * kTileK + 2 * kBQ * 4 + 1024;
  // D 48 and 64: two CTAs an SM (128 registers a thread), so one CTA's
  // softmax runs while the other's products do
  static constexpr int kCtasPerSm = D <= 64 ? 2 : 1;
};

// grid (BH, q tiles); DqCfg<D>::kThreads threads and kSmem dynamic shared
// memory
template <int D>
__global__ void __launch_bounds__(DqCfg<D>::kThreads, DqCfg<D>::kCtasPerSm)
flash_dq_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ o,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta_out, bf16* __restrict__ dq, int s_q, int s_kv,
              int rep, int causal, float sm_scale) {
  using C = DqCfg<D>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK, kStages = C::kStages, kNT = C::kThreads;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t pad = ((raw_s + 1023u) & ~1023u) - raw_s;  // SW128 wants 1 KB
  const uint32_t s_qt = raw_s + pad;
  const uint32_t s_do = s_qt + C::kTileQ;
  const uint32_t s_ring = s_do + C::kTileQ;
  float* rows = reinterpret_cast<float*>(smem_raw + pad + 2 * C::kTileQ +
                                         kStages * 2 * C::kTileK);  // lse, delta

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int bh = blockIdx.x;
  const int n_qt = (s_q + kBQ - 1) / kBQ;
  // causal: the q tiles that see the most keys launch first
  const int qt = static_cast<int>(blockIdx.y);
  const int q0 = (causal ? n_qt - 1 - qt : qt) * kBQ;
  const int offset = s_kv - s_q;
  const size_t qbase = static_cast<size_t>(bh) * s_q * D;
  const bf16* kb = k + static_cast<size_t>(bh / rep) * s_kv * D;
  const bf16* vb = v + static_cast<size_t>(bh / rep) * s_kv * D;

  // the visible kv steps: up to the last key seen by the tile's last row
  int n_kv = (s_kv + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, (min(q0 + kBQ, s_q) - 1 + offset) / kBK + 1);

  auto load_stage = [&](int j, int slot) {
    const uint32_t st = s_ring + slot * 2 * C::kTileK;
    load_tile<D, kBK, kNT>(st, kb, j * kBK, s_kv);
    load_tile<D, kBK, kNT>(st + C::kTileK, vb, j * kBK, s_kv);
  };
  // Q and dO stay resident; they ride in the first copy group with step 0
  load_tile<D, kBQ, kNT>(s_qt, q + qbase, q0, s_q);
  load_tile<D, kBQ, kNT>(s_do, dout + qbase, q0, s_q);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kv) load_stage(s, s);
    cp_async_commit();
  }

  // delta = rowsum(dO o O) in fp32, 16-byte loads, two threads a row
  {
    const int r = tid >> 1, half = tid & 1, qi = q0 + r;
    float part = 0.f;
    if (qi < s_q) {
      const uint4* o4 = reinterpret_cast<const uint4*>(o + qbase + static_cast<size_t>(qi) * D +
                                                       half * (D / 2));
      const uint4* d4 = reinterpret_cast<const uint4*>(dout + qbase +
                                                       static_cast<size_t>(qi) * D + half * (D / 2));
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint4 a = o4[c], b = d4[c];
        const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[e]));
          const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv[e]));
          part = fmaf(fa.x, fb.x, part);
          part = fmaf(fa.y, fb.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      rows[r] = qi < s_q ? lse[static_cast<size_t>(bh) * s_q + qi] : 0.f;
      rows[kBQ + r] = part;
      if (qi < s_q) delta_out[static_cast<size_t>(bh) * s_q + qi] = part;
    }
  }
  __syncthreads();
  // this thread's two accumulator rows (lane / 4 and lane / 4 + 8 of its warp)
  const int qw = q0 + wg * 64;  // first q row of this warpgroup
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int rl = wg * 64 + warp * 16 + g + 8 * j;
    row_lse[j] = rows[rl];
    row_delta[j] = rows[kBQ + rl];
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step j landed
    fence_proxy_async();
    // every copy of step j is visible, and both warpgroups are done with
    // step j - 1, whose slot the next load reuses
    __syncthreads();
    if (j + kStages - 1 < n_kv) load_stage(j + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();
    const int kv0 = j * kBK;
    // every key of the step lies past this warpgroup's last row
    if (causal && kv0 > qw + 63 + offset) continue;
    const uint32_t s_k = s_ring + (j % kStages) * 2 * C::kTileK;
    const uint32_t s_v = s_k + C::kTileK;

    // S = Q K^T and dP = dO V^T (64 x 64 a warpgroup), D the reduction axis
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk >> 2) * kBQ * 128 + wg * 64 * 128 + (kk & 3) * 32;
      const uint32_t b_off = (kk >> 2) * kBK * 128 + (kk & 3) * 32;
      wgmma_ss<64, 0>(s, desc_k(s_qt + a_off), desc_k(s_k + b_off));
      wgmma_ss<64, 0>(dp, desc_k(s_do + a_off), desc_k(s_v + b_off));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);

    // dS = P o (dP - delta), P = exp(scale S - lse); the mask only where the
    // step crosses the diagonal or the ragged end of the keys
    const bool edge = (causal && kv0 + kBK - 1 > qw + offset) || kv0 + kBK > s_kv;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * i + 2 * jj + e;
          float sc = s[x] * sm_scale;
          float p;
          if (edge) {
            const int kj = kv0 + 8 * i + 2 * t + e;
            const int qi = qw + warp * 16 + g + 8 * jj;
            if (causal && kj > qi + offset) sc = kNegInf;
            p = kj < s_kv ? __expf(sc - row_lse[jj]) : 0.f;
          } else {
            p = __expf(sc - row_lse[jj]);
          }
          s[x] = p * (dp[x] - row_delta[jj]);
        }
    uint32_t da[4][4];
    acc_to_frag<64>(da, s);

    // dQ += dS K: the same K tile, read MN-major (the kv rows reduce)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D, 1>(acc, da[kk], desc_mn(s_k + kk * 16 * 128, kBK * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frag(da);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int qi = qw + warp * 16 + g + 8 * jj;
    if (qi >= s_q) continue;
    bf16* drow = dq + qbase + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * i + 2 * t) = __floats2bfloat162_rn(
          sm_scale * acc[4 * i + 2 * jj], sm_scale * acc[4 * i + 2 * jj + 1]);
  }
}

// ------------------------------------------------------------------ B3
template <int D>
struct DkvCfg {
  static constexpr int kThreads = 128;           // one consumer warpgroup
  static constexpr int kBKV = 64;                // kv rows a CTA
  static constexpr int kBQ = D <= 64 ? 64 : 32;  // q rows a ring step
  static constexpr int kStages = 3;
  // several CTAs an SM, so one CTA's softmax overlaps another's products
  static constexpr int kCtasPerSm = D <= 64 ? 3 : 2;
  static constexpr int kTileKV = kBKV * kRowBytes<D>;  // bytes of K (or V)
  static constexpr int kTileQ = kBQ * kRowBytes<D>;    // bytes of Q (or dO) a step
  static constexpr int kSmem =
      2 * kTileKV + kStages * (2 * kTileQ + 2 * kBQ * 4) + 1024;
};

// grid (BH_kv, kv tiles); DkvCfg<D>::kThreads threads and kSmem dynamic
// shared memory
template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads, DkvCfg<D>::kCtasPerSm)
flash_dkv_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int s_q, int s_kv, int rep,
               int causal, float sm_scale) {
  using C = DkvCfg<D>;
  constexpr int kBKV = C::kBKV, kBQ = C::kBQ, kStages = C::kStages, kNT = C::kThreads;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t pad = ((raw_s + 1023u) & ~1023u) - raw_s;  // SW128 wants 1 KB
  const uint32_t s_kt = raw_s + pad;
  const uint32_t s_vt = s_kt + C::kTileKV;
  const uint32_t s_ring = s_vt + C::kTileKV;
  float* rows_all = reinterpret_cast<float*>(smem_raw + pad + 2 * C::kTileKV +
                                             kStages * 2 * C::kTileQ);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kBKV;  // causal: tile 0, seen by most queries, first
  const int offset = s_kv - s_q;
  const size_t kvbase = static_cast<size_t>(bkv) * s_kv * D;

  // the sweep: for each of the rep query heads of the group, the q steps from
  // the first holding a row that sees key k0 (k0 < S_kv, so n_q >= 1)
  const int qt0 = causal ? max(0, k0 - offset) / kBQ : 0;
  const int n_q = (s_q + kBQ - 1) / kBQ - qt0;
  const int n_steps = rep * n_q;

  auto load_stage = [&](int j, int slot) {
    const int r = j / n_q;
    const int q0 = (qt0 + j - r * n_q) * kBQ;
    const int bh = bkv * rep + r;
    const size_t qbase = static_cast<size_t>(bh) * s_q * D;
    const uint32_t st = s_ring + slot * 2 * C::kTileQ;
    load_tile<D, kBQ, kNT>(st, q + qbase, q0, s_q);
    load_tile<D, kBQ, kNT>(st + C::kTileQ, dout + qbase, q0, s_q);
    float* rw = rows_all + slot * 2 * kBQ;
    for (int i = tid; i < 2 * kBQ; i += kNT) {
      const int ii = i % kBQ;
      const bool ok = q0 + ii < s_q;
      const float* src =
          (i < kBQ ? lse : delta) + static_cast<size_t>(bh) * s_q + (ok ? q0 + ii : 0);
      cp_async4(smem_u32(rw + i), src, ok ? 4 : 0);
    }
  };
  // K and V stay resident; they ride in the first copy group with step 0
  load_tile<D, kBKV, kNT>(s_kt, k + kvbase, k0, s_kv);
  load_tile<D, kBKV, kNT>(s_vt, v + kvbase, k0, s_kv);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_stage(s, s);
    cp_async_commit();
  }

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  fence_acc(acc_k);
  fence_acc(acc_v);

  for (int j = 0; j < n_steps; ++j) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step j landed
    fence_proxy_async();
    // every copy of step j is visible, and the warpgroup is done with step
    // j - 1, whose slot the next load reuses
    __syncthreads();
    if (j + kStages - 1 < n_steps) load_stage(j + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();
    const int r = j / n_q;
    const int q0 = (qt0 + j - r * n_q) * kBQ;
    const int slot = j % kStages;
    const uint32_t s_q_st = s_ring + slot * 2 * C::kTileQ;
    const uint32_t s_do_st = s_q_st + C::kTileQ;
    const float* rl = rows_all + slot * 2 * kBQ;  // lse [kBQ], delta [kBQ]

    // S^T = K Q^T and dP^T = V dO^T (64 kv x kBQ q), D reduces
    float s[kBQ / 2], dp[kBQ / 2];
#pragma unroll
    for (int i = 0; i < kBQ / 2; ++i) s[i] = dp[i] = 0.f;
    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk >> 2) * kBKV * 128 + (kk & 3) * 32;
      const uint32_t b_off = (kk >> 2) * kBQ * 128 + (kk & 3) * 32;
      wgmma_ss<kBQ, 0>(s, desc_k(s_kt + a_off), desc_k(s_q_st + b_off));
      wgmma_ss<kBQ, 0>(dp, desc_k(s_vt + a_off), desc_k(s_do_st + b_off));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);

    // P^T = exp(scale S^T - lse) and dS^T = P^T o (dP^T - delta), lse and
    // delta per column (query). The mask only on steps that cross the
    // diagonal. Keys past S_kv need none: their dK / dV rows are not
    // written. Rows past S_q add nothing: their Q, dO, lse and delta load
    // as zeros, so P^T dO and dS^T Q vanish there.
    const bool edge = causal && k0 + kBKV - 1 > q0 + offset;
#pragma unroll
    for (int i = 0; i < kBQ / 8; ++i) {
      const float2 l2 = *reinterpret_cast<const float2*>(rl + 8 * i + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(rl + kBQ + 8 * i + 2 * t);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * i + 2 * jj + e;
          float sc = s[x] * sm_scale;
          if (edge) {
            const int kj = k0 + warp * 16 + g + 8 * jj;
            const int qi = q0 + 8 * i + 2 * t + e;
            if (kj > qi + offset) sc = kNegInf;
          }
          const float p = __expf(sc - (e ? l2.y : l2.x));
          s[x] = p;
          dp[x] = p * (dp[x] - (e ? d2.y : d2.x));
        }
    }
    uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
    acc_to_frag<kBQ>(pa, s);
    acc_to_frag<kBQ>(da, dp);

    // dV += P^T dO and dK += dS^T Q: the same dO and Q tiles, read MN-major
    // (the q rows reduce)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      wgmma_rs<D, 1>(acc_v, pa[kk], desc_mn(s_do_st + kk * 16 * 128, kBQ * 128));
      wgmma_rs<D, 1>(acc_k, da[kk], desc_mn(s_q_st + kk * 16 * 128, kBQ * 128));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc_v);
    fence_acc(acc_k);
    fence_frag(pa);
    fence_frag(da);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int kj = k0 + warp * 16 + g + 8 * jj;
    if (kj >= s_kv) continue;
    bf16* krow = dk + kvbase + static_cast<size_t>(kj) * D;
    bf16* vrow = dv + kvbase + static_cast<size_t>(kj) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int x = 4 * i + 2 * jj;
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * i + 2 * t) =
          __floats2bfloat162_rn(sm_scale * acc_k[x], sm_scale * acc_k[x + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * i + 2 * t) =
          __floats2bfloat162_rn(acc_v[x], acc_v[x + 1]);
    }
  }
}

// ------------------------------------------------------- descriptor probe
// One warpgroup, one tile, for the card tests of the two operand forms the
// kernels above rest on. a, w (64 x 64) and b (64 x N) bf16 row-major, N 48,
// 64 or 128 (N 48: six chunks of each 128-byte row, D 48's dQ, dK and dV
// products); c (64 x N) fp32. mode 0: c = a b, with b read MN-major (the
// transpose bit).
// mode 1: c = bf16(a w^T) b, the first product K-major from shared memory,
// its accumulator re-packed as the register-A operand of the second.
template <int N>
__global__ void __launch_bounds__(128)
wgmma_probe(const bf16* __restrict__ a, const bf16* __restrict__ w,
            const bf16* __restrict__ b, float* __restrict__ c, int mode) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t s_a = raw_s + (((raw_s + 1023u) & ~1023u) - raw_s);
  const uint32_t s_w = s_a + 64 * 128;
  const uint32_t s_b = s_w + 64 * 128;
  load_tile<64, 64, 128>(s_a, a, 0, 64);
  load_tile<64, 64, 128>(s_w, w, 0, 64);
  load_tile<N, 64, 128>(s_b, b, 0, 64);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);
  if (mode == 0) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<N, 1>(acc, desc_k(s_a + kk * 32), desc_mn(s_b + kk * 16 * 128, 64 * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  } else {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<64, 0>(s, desc_k(s_a + kk * 32), desc_k(s_w + kk * 32));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    uint32_t pa[4][4];
    acc_to_frag<64>(pa, s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<N, 1>(acc, pa[kk], desc_mn(s_b + kk * 16 * 128, 64 * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frag(pa);
  }
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        c[(warp * 16 + g + 8 * jj) * N + 8 * i + 2 * t + e] = acc[4 * i + 2 * jj + e];
}

// ------------------------------------------------------------------ launch
template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, void* dq, int bh,
                      int bh_kv, int s_q, int s_kv, int causal, float sm_scale,
                      cudaStream_t st) {
  using C = DqCfg<D>;
  cudaError_t err = set_smem(flash_dq_sm90<D>, C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s_q + C::kBQ - 1) / C::kBQ);
  flash_dq_sm90<D><<<grid, C::kThreads, C::kSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), s_q, s_kv, bh / bh_kv, causal, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int bh,
                       int bh_kv, int s_q, int s_kv, int causal, float sm_scale,
                       cudaStream_t st) {
  using C = DkvCfg<D>;
  cudaError_t err = set_smem(flash_dkv_sm90<D>, C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh_kv, (s_kv + C::kBKV - 1) / C::kBKV);
  flash_dkv_sm90<D><<<grid, C::kThreads, C::kSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s_q, s_kv, bh / bh_kv, causal, sm_scale);
  return cudaGetLastError();
}

// what both kernels take: the route `plan_flash_bwd` calls "sm90"
bool shape_ok(int head_dim, int bh, int bh_kv, int s_q, int s_kv) {
  return (head_dim == 48 || head_dim == 64 || head_dim == 128) && bh > 0 && bh_kv > 0 &&
         bh % bh_kv == 0 && s_q >= 1 && s_q <= s_kv && (s_kv + 63) / 64 <= kMaxTiles;
}

}  // namespace

// The plain C interface (loaded with ctypes). Every pointer is a contiguous
// device buffer: q, k, v, o, dout, dq, dk, dv bf16 and 16-byte aligned; lse
// and delta fp32 (bh, s_q). A shape or pointer the kernels do not take (see
// shape_ok) returns cudaErrorInvalidValue without launching; otherwise the
// launch's CUDA error code (0 on success).
extern "C" int tb_flash_dq_sm90(int head_dim, const void* q, const void* k, const void* v,
                                const void* o, const void* dout, const float* lse,
                                float* delta, void* dq, int bh, int bh_kv, int s_q, int s_kv,
                                int causal, float sm_scale, void* stream) {
  if (!shape_ok(head_dim, bh, bh_kv, s_q, s_kv) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o) || !aligned16(dout) || !aligned16(dq))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 48)
    return static_cast<int>(launch_dq<48>(q, k, v, o, dout, lse, delta, dq, bh, bh_kv, s_q,
                                          s_kv, causal, sm_scale, st));
  if (head_dim == 64)
    return static_cast<int>(launch_dq<64>(q, k, v, o, dout, lse, delta, dq, bh, bh_kv, s_q,
                                          s_kv, causal, sm_scale, st));
  return static_cast<int>(launch_dq<128>(q, k, v, o, dout, lse, delta, dq, bh, bh_kv, s_q,
                                         s_kv, causal, sm_scale, st));
}

extern "C" int tb_flash_dkv_sm90(int head_dim, const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 void* dk, void* dv, int bh, int bh_kv, int s_q, int s_kv,
                                 int causal, float sm_scale, void* stream) {
  if (!shape_ok(head_dim, bh, bh_kv, s_q, s_kv) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout) || !aligned16(dk) || !aligned16(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 48)
    return static_cast<int>(launch_dkv<48>(q, k, v, dout, lse, delta, dk, dv, bh, bh_kv, s_q,
                                           s_kv, causal, sm_scale, st));
  if (head_dim == 64)
    return static_cast<int>(launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, bh_kv, s_q,
                                           s_kv, causal, sm_scale, st));
  return static_cast<int>(launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, bh_kv, s_q,
                                          s_kv, causal, sm_scale, st));
}

// tb_wgmma_probe: the descriptor probe above, one CTA, n 48, 64 or 128.
extern "C" int tb_wgmma_probe(int mode, int n, const void* a, const void* w, const void* b,
                              float* c, void* stream) {
  if ((mode != 0 && mode != 1) || (n != 48 && n != 64 && n != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = 2 * 64 * 128 + 64 * 128 * ((n + 63) / 64) + 1024;
  const bf16 *pa = static_cast<const bf16*>(a), *pw = static_cast<const bf16*>(w),
             *pb = static_cast<const bf16*>(b);
  if (n == 48)
    wgmma_probe<48><<<1, 128, smem, st>>>(pa, pw, pb, c, mode);
  else if (n == 64)
    wgmma_probe<64><<<1, 128, smem, st>>>(pa, pw, pb, c, mode);
  else
    wgmma_probe<128><<<1, 128, smem, st>>>(pa, pw, pb, c, mode);
  return static_cast<int>(cudaGetLastError());
}
