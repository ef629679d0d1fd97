// Flash attention forward for Hopper (sm_90a): the bf16 "sm90" route of B1,
// a wgmma kernel fed by a cp.async copy ring.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// torchbooster_tpu/ops/flash_attention.py (:104, pallas_call :180) for bf16
// operands at head dims 64 and 128 with 1 <= S_q <= S_kv. The route is
// planned before launch by `plan_flash_fwd` (ops/flash_attention.py); D 32,
// S_q > S_kv and fp32 keep flash_fwd_mma / flash_fwd of flash_attention.cu.
//
// Semantics are those kernels' (and the TPU's): q (BH, S_q, D), k/v (BH_kv,
// S_kv, D), q row b reads grouped k/v row b / rep; o like q; lse fp32 (BH,
// S_q). Scores are scale q K^T in fp32; the causal mask writes -1e30 into
// the scaled score before the running max (query i sees keys [0, i + S_kv -
// S_q]: queries align to the last keys); keys past a ragged S_kv have
// probability 0 and rows past S_q are not written; P rounds once to bf16
// before P V; o = (sum P V) / l in bf16 and lse = m + log l, written once.
//
// Bound. At GPT-2 small's training shape (B 8, H 12, S 1024, D 64, causal)
// the two products over the 50.4 M visible (q, k) pairs are 12.9 GFLOP,
// 13.0 us at 989 TFLOP/s; q, k, v and o are 12.6 MB each and lse 0.4 MB,
// 15.1 us at 3.35 TB/s. So B1 is bound by bytes by a small margin, and the
// 50.4 M exponentials (about 14 us on the SFUs) cost as much as the products:
// the softmax has to overlap the tensor cores.
//
// Design. Q, K and V tiles live in shared memory in the SW128 layout of
// sm90_wgmma.cuh (rows of 128 bytes, a 128-wide head as two 64-column
// blocks). A CTA is two consumer warpgroups of 64 q rows (256 threads); Q is
// loaded once, K and V stream through a ring of kStages slots of 64 kv rows
// filled by 16-byte cp.async copies (zero fill past the ragged end),
// kStages - 1 steps ahead of the products. Each step:
//   S = Q K^T       wgmma, both operands K-major from shared memory;
//   softmax         in registers on the accumulator layout: sm_scale log2(e)
//                   folded into one multiply, the row max over the 4 lanes
//                   of a row with shfl_xor 1 and 2, O rescaled, exp2;
//   O += P V        P re-packed from the accumulator as wgmma's register-A
//                   operand, V read MN-major through the transpose bit, so
//                   nothing is transposed as it is stored.
// The mask runs only on steps that cross the diagonal or the ragged end; a
// warpgroup skips a step its rows cannot see. Causal q tiles that see the
// most keys launch first, so the short tiles fill the last wave. At D 64 two
// CTAs share an SM (at most 128 registers a thread), so one CTA's softmax
// runs while the other's products do; at D 128 the 64-float O accumulator
// allows one. Each warpgroup runs its steps in lockstep (products, softmax,
// products, each awaited): issuing S_{j+1} before P_j V_j so that the
// softmax overlaps the warpgroup's own product (FlashAttention-3's
// intra-warpgroup overlap) was slower on one H100 at both head dims, with
// 128 and 184 registers a thread.
//
// Budget per CTA (dynamic shared memory, + 1 KB alignment slack):
//   Q (128 x D) + kStages x (K, V (64 x D)):
//   D 64: 16 + 3 x 16 = 64 KB; D 128: 32 + 3 x 32 = 128 KB.

#include <math.h>

#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

constexpr float kNegInf = -1e30f;  // the JAX package's mask value (never -inf)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxTiles = 65535;  // grid.y limit (q tiles)

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct FwdCfg {
  static constexpr int kThreads = 256;  // two consumer warpgroups
  static constexpr int kBQ = 128;       // q rows a CTA, 64 a warpgroup
  static constexpr int kBK = 64;        // kv rows a ring step
  static constexpr int kStages = 3;
  static constexpr int kTileQ = kBQ * D * 2;  // bytes of Q
  static constexpr int kTileK = kBK * D * 2;  // bytes of K (or V) a step
  static constexpr int kSmem = kTileQ + kStages * 2 * kTileK + 1024;
  static constexpr int kCtasPerSm = D == 64 ? 2 : 1;
};

// grid (BH, q tiles); FwdCfg<D>::kThreads threads and kSmem dynamic shared
// memory
template <int D>
__global__ void __launch_bounds__(FwdCfg<D>::kThreads, FwdCfg<D>::kCtasPerSm)
flash_fwd_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
               int s_q, int s_kv, int rep, int causal, float sm_scale) {
  using C = FwdCfg<D>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK, kStages = C::kStages, kNT = C::kThreads;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t s_qt = raw_s + (((raw_s + 1023u) & ~1023u) - raw_s);  // SW128 wants 1 KB
  const uint32_t s_ring = s_qt + C::kTileQ;

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
  // Q stays resident; it rides in the first copy group with step 0
  load_tile<D, kBQ, kNT>(s_qt, q + qbase, q0, s_q);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kv) load_stage(s, s);
    cp_async_commit();
  }

  // this thread's two accumulator rows (lane / 4 and lane / 4 + 8 of its warp)
  const int qw = q0 + wg * 64;  // first q row of this warpgroup
  const int row[2] = {qw + warp * 16 + g, qw + warp * 16 + g + 8};
  const float scale2 = sm_scale * kLog2e;  // scores in log2 units
  // running max (log2 units) and sum of each row; every row sees key 0 (S_q
  // <= S_kv), which step 0 holds, so m is finite from step 0 on
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
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

    // S = Q K^T (64 x 64 a warpgroup), D the reduction axis
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk >> 2) * kBQ * 128 + wg * 64 * 128 + (kk & 3) * 32;
      const uint32_t b_off = (kk >> 2) * kBK * 128 + (kk & 3) * 32;
      wgmma_ss<64, 0>(s, desc_k(s_qt + a_off), desc_k(s_k + b_off));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);

    // scaled scores; the mask only where the step crosses the diagonal or
    // the ragged end of the keys (-inf there: probability exactly 0)
    const bool edge = (causal && kv0 + kBK - 1 > qw + offset) || kv0 + kBK > s_kv;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * i + 2 * jj + e;
          float sc = s[x] * scale2;
          if (edge) {
            const int kj = kv0 + 8 * i + 2 * t + e;
            if (kj >= s_kv)
              sc = -INFINITY;
            else if (causal && kj > row[jj] + offset)
              sc = kNegInf;
          }
          s[x] = sc;
          mx[jj] = fmaxf(mx[jj], sc);
        }
    float corr[2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      mx[jj] = fmaxf(mx[jj], __shfl_xor_sync(0xffffffffu, mx[jj], 1));
      mx[jj] = fmaxf(mx[jj], __shfl_xor_sync(0xffffffffu, mx[jj], 2));
      corr[jj] = ex2(m[jj] - mx[jj]);
      m[jj] = mx[jj];
      l[jj] *= corr[jj];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * i + 2 * jj + e;
          s[x] = ex2(s[x] - m[jj]);
          l[jj] += s[x];
        }
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        acc[4 * i + 2 * jj] *= corr[jj];
        acc[4 * i + 2 * jj + 1] *= corr[jj];
      }
    uint32_t pa[4][4];
    acc_to_frag<64>(pa, s);

    // O += P V: the V tile read MN-major (the kv rows reduce)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D, 1>(acc, pa[kk], desc_mn(s_v + kk * 16 * 128, kBK * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frag(pa);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    l[jj] += __shfl_xor_sync(0xffffffffu, l[jj], 1);
    l[jj] += __shfl_xor_sync(0xffffffffu, l[jj], 2);
    if (row[jj] >= s_q) continue;
    const float inv = 1.f / l[jj];
    bf16* orow = o + qbase + static_cast<size_t>(row[jj]) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + 2 * t) =
          __floats2bfloat162_rn(acc[4 * i + 2 * jj] * inv, acc[4 * i + 2 * jj + 1] * inv);
    if (t == 0) lse[static_cast<size_t>(bh) * s_q + row[jj]] = m[jj] * kLn2 + logf(l[jj]);
  }
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                       int bh_kv, int s_q, int s_kv, int causal, float sm_scale,
                       cudaStream_t st) {
  using C = FwdCfg<D>;
  cudaError_t err = set_smem(flash_fwd_sm90<D>, C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s_q + C::kBQ - 1) / C::kBQ);
  flash_fwd_sm90<D><<<grid, C::kThreads, C::kSmem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, s_q, s_kv, bh / bh_kv, causal, sm_scale);
  return cudaGetLastError();
}

// what the kernel takes: the route `plan_flash_fwd` calls "sm90"
bool shape_ok(int head_dim, int bh, int bh_kv, int s_q, int s_kv) {
  return (head_dim == 64 || head_dim == 128) && bh > 0 && bh_kv > 0 && bh % bh_kv == 0 &&
         s_q >= 1 && s_q <= s_kv && (s_kv + 63) / 64 <= kMaxTiles;
}

}  // namespace

// The plain C interface (loaded with ctypes). q, k, v, o are contiguous bf16
// device buffers, 16-byte aligned; lse fp32 (bh, s_q). A shape or pointer
// the kernel does not take (see shape_ok) returns cudaErrorInvalidValue
// without launching; otherwise the launch's CUDA error code (0 on success).
extern "C" int tb_flash_fwd_sm90(int head_dim, const void* q, const void* k, const void* v,
                                 void* o, float* lse, int bh, int bh_kv, int s_q, int s_kv,
                                 int causal, float sm_scale, void* stream) {
  if (!shape_ok(head_dim, bh, bh_kv, s_q, s_kv) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return static_cast<int>(
        launch_fwd<64>(q, k, v, o, lse, bh, bh_kv, s_q, s_kv, causal, sm_scale, st));
  return static_cast<int>(
      launch_fwd<128>(q, k, v, o, lse, bh, bh_kv, s_q, s_kv, causal, sm_scale, st));
}
