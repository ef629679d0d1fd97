// Paged flash-decode for Hopper (sm_90a): the "sm90" route of B4.
//
// Replaces the Pallas TPU kernel `_paged_kernel`
// (torchbooster_tpu/ops/paged_attention.py:70, pallas_call :274) for bf16
// queries over a bf16 pool, or over an int8 pool with bf16 per-(token, head)
// scales, at head dims 32, 64 and 128, page sizes 16-128 (a multiple of 16)
// and at most 64 query rows (rep x S) per kv head. The route is planned
// before launch by `plan_paged` (ops/paged_attention.py), and this file
// checks the same before it launches; fp32 queries or pools and every other
// shape keep the CUDA-core kernels of paged_attention.cu ("simt").
//
// Semantics are those of paged_attention.cu and of the TPU kernel: q (slots,
// S, H, Dh), one layer's pool (P, ps, H_kv, Dh), the compacted live-page walk
// work_pages (W,), work_refs (W, lanes), work_pos (W,), lengths (slots,), an
// optional tree_vis (slots, S, S). Query head h reads kv head h / rep. A
// page token at position pos is visible to query row j of slot s iff pos <=
// lengths[s] + j (decode and linear verify), or, with tree_vis, iff pos <=
// lengths[s] or the draft node pos - lengths[s] is an ancestor-or-self of
// node j. The mask gates the probabilities (a fully masked lane adds l = 0
// and no NaN) and masked scores are -1e30. Output (slots, S, H, Dh) bf16;
// rows of slots no entry references are zeros. Live entries come first in
// the walk (BlockTables.kernel_args): the walk ends at the first entry whose
// lanes are all empty, and no entry after it is read.
//
// Bound. Decode reads every visible K/V byte once and does about 4 flops per
// element, far below the card's ~295 flop/byte ridge, so the bound is the
// live pages' bytes over 3.35 TB/s. Everything below keeps those bytes in
// flight over all SMs with no wasted rounds:
//
//   Copies. A work item is (live entry, kv head). Its page tile, page_size
//   token rows of Dh values at a stride of H_kv * Dh, arrives in shared
//   memory by one TMA tensor copy (cp.async.bulk.tensor, completing on an
//   mbarrier with complete_tx; two at 256-byte rows) in its storage type:
//   bf16 or int8, never widened in shared memory. The tensor map views one
//   layer pool as (Dh, H_kv, pages x page_size); it is encoded per call on
//   the host through cuTensorMapEncodeTiled, which the runtime hands out
//   (cudaGetDriverEntryPoint), so nothing links libcuda. Tiles land in the
//   TMA's 128/64/32-byte swizzle (tile_off), so ldmatrix rows hit distinct
//   banks. One 1-D bulk copy per token row was tried first, and starting
//   129 small copies an item held the walk: pass 1 took 15.3 us at the
//   smoke's timed shape against 9.9 us with the tensor map (chip_smoke.py
//   phase kernel, one H100 80GB HBM3 at 700 W, before the other changes
//   below). The query rows
//   ride the same barrier as 1-D bulk copies; the int8 scales (2 bytes a
//   token at a stride of 2 H_kv bytes, not 16-byte aligned) are loaded by
//   the threads with plain loads while the tile lands.
//   Walk. Persistent CTAs, as many as fit on the card (the SM count is read
//   once; four an SM at Dh <= 64, so GPT-2 small's 444 live items of the
//   timed shape all start at once); CTA b takes items b, b + grid, ... in
//   that fixed order, through a two-slot ring: the next item's tile is in
//   flight while the current one is computed. A CTA stops at its first item
//   on an all-empty entry; the host never learns the live count, so a
//   captured decode step stays valid.
//   Products. mma.sync m16n8k16 bf16 with fp32 accumulation, operands from
//   shared memory by ldmatrix (K rows as B; V rows through .trans). S = Q K^T
//   takes all of the item's query rows (every lane's rep x S rows, padded to
//   16) as A; O = P V takes P rounded to bf16, as B1 does. The four warps
//   split the page's tokens in 16-token blocks, not the rows, so every warp
//   works at MHA decode (one row); per-warp (m, l, O) combine through shared
//   memory in warp order. Scores are kept in log2 units (sm_scale log2 e
//   folded into one multiply, ex2), m_part too. This is not wgmma: its
//   64-row M would pad the 1-16 rows of a decode item 4-64x, and operations
//   are not the bound here.
//   int8 without widening: an int8 value is exact in bf16 (|v| <= 127), so K
//   enters the product as stored (converted in registers) and each token's
//   K scale multiplies its score in fp32; V's scale folds into P before P V.
//   Merge. One warp per (slot, j, head) scans the entries 32 at a time with
//   __ballot_sync over work_refs, then combines the matching partials in
//   ascending entry order with 16-byte reads of o_part (8 in flight).
//   It is launched with programmatic dependent launch, so its launch and its
//   scan of work_refs overlap pass 1; griddepcontrol.wait orders its reads
//   of the partials after pass 1. No floating-point atomics: two calls on
//   the same inputs agree bit for bit.
//
// Shared memory per CTA: two ring slots of K and V tiles (2 page_size Dh elt
// bytes each) and of up to 64 query rows (2 Dh + 16 bytes), the warps' (m, l,
// O) for one 16-row tile, the page's scales and the items' lane lists. bf16,
// page 64, Dh 64, one lane: 55.6 KB (four CTAs an SM); the largest case, Dh
// 128 bf16 at page 128 with 64 query rows, 198 KB.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <math.h>

#include "sm90_wgmma.cuh"

namespace {

using namespace sm90;

constexpr float kNegInf = -1e30f;  // the JAX package's mask value (never -inf)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;                  // ring slots
constexpr int kTokBlock = 16;               // tokens of one P V k step
constexpr int kMinPage = 16, kMaxPage = 128;
constexpr int kBlocksPerWarp = kMaxPage / kTokBlock / kWarps;  // 2
constexpr int kMaxRowsPerHead = 64;         // rep x S
constexpr int kMaxLanes = 1023;             // lanes x 64 rows stay below 2^16 (row_of)
constexpr int kQCap = 64;                   // query rows a ring slot holds
constexpr int kMeta = 8;                    // ints of an item's header
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 16;
constexpr int kScan = 4;                    // 32-entry chunks a merge warp scans at once

enum DType { kBF16 = 1, kI8 = 2 };  // the wrapper's pool dtype codes

struct Params {
  CUtensorMap map_k, map_v;  // the layer pool as (Dh, H_kv, pages x page_size)
  const bf16* q;
  const void* pool_k;
  const void* pool_v;
  const bf16* scale_k;
  const bf16* scale_v;
  const int* work_pages;
  const int* work_refs;
  const int* work_pos;
  const int* lengths;
  const int* tree_vis;
  bf16* out;
  float* o_part;
  float* m_part;
  float* l_part;
  int n_slots, s_q, n_heads, kv_heads, page_size, n_pages, n_w, n_lanes, rep, qcap;
  unsigned magic_rows, magic_s;  // division by rep x S and by S (row_of)
  float scale_log2;              // sm_scale log2(e): scores in log2 units
};

// byte offsets into the dynamic shared memory, from its first 1024-byte
// boundary (the swizzled tiles' alignment)
struct Layout {
  int qrow, stage, v, q, qstage, comb, ml, scale, meta, bar, total;
};

__host__ __device__ inline Layout make_layout(int d, int elt, int ps, int qcap, int n_lanes) {
  Layout L;
  L.stage = 2 * ps * d * elt;  // a slot's K and V tiles, a multiple of 1024 bytes
  L.v = ps * d * elt;
  L.qrow = d * 2 + 16;  // a 16-byte pad: ldmatrix rows fall on distinct banks
  L.q = kStages * L.stage;  // then each slot's query rows
  L.qstage = qcap * L.qrow;
  L.comb = L.q + kStages * L.qstage;                // float [warps][16][d + 4]
  L.ml = L.comb + kWarps * 16 * (d + 4) * 4;         // float [warps][16][2]
  L.scale = L.ml + kWarps * 16 * 2 * 4;             // float [2][ps]
  L.meta = L.scale + 2 * ps * 4;  // int [stages][kMeta]; slots, lanes, lengths [stages][n_lanes]
  L.bar = (L.meta + (kStages * kMeta + 3 * kStages * n_lanes) * 4 + 7) & ~7;
  L.total = L.bar + kStages * 8 + 1024;  // + slack to align the base
  return L;
}

// The tensor map's swizzled tile: row r of a K or V tile (RB = Dh x elt
// bytes) in 128-byte column blocks of ps rows (one when RB <= 128); within a
// block's row of W = min(RB, 128) bytes, 16-byte chunk c sits at chunk c ^
// ((r W / 128) mod W / 16) — the 128B, 64B and 32B swizzles of the TMA.
// Byte offset of byte b of row r:
template <int RB>
__device__ __forceinline__ int tile_off(int ps, int r, int b) {
  constexpr int W = RB < 128 ? RB : 128;
  const int sw = ((r * W) >> 7) & (W / 16 - 1);
  return (b >> 7) * ps * W + r * W + ((((b & 127) >> 4) ^ sw) << 4) + (b & 15);
}

// ------------------------------------------------------------------- PTX
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// `bytes` (a multiple of 16) from global to shared, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two int8 values (low byte first) as a bf16 pair, exactly
__device__ __forceinline__ uint32_t i8x2(int lo, int hi) {
  return pack_bf16(static_cast<float>(static_cast<int8_t>(lo)),
                   static_cast<float>(static_cast<int8_t>(hi)));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// n / d for n, d < 2^16 as one multiply-high by magic = ceil(2^32 / d)
// (0 for d = 1)
__host__ __device__ inline unsigned div_magic(unsigned d) {
  return d == 1 ? 0u : static_cast<unsigned>(((1ull << 32) + d - 1) / d);
}

__device__ __forceinline__ int fast_div(int n, unsigned magic) {
  return magic ? static_cast<int>(__umulhi(static_cast<unsigned>(n), magic)) : n;
}

// row R of an item's query rows: lane c of the entry, query head h and
// position j (each lane's rep x S rows, j fastest)
__device__ __forceinline__ void row_of(const Params& p, int g, int R, int& c, int& h, int& j) {
  c = fast_div(R, p.magic_rows);
  const int x = R - c * p.rep * p.s_q;
  const int r = fast_div(x, p.magic_s);
  j = x - r * p.s_q;
  h = g * p.rep + r;
}

__device__ __forceinline__ bool visible(int pos, int len, int j, int s_q, const int* tv_row) {
  if (tv_row == nullptr) return pos <= len + j;
  const int off = pos - len;  // draft offset: ancestors-or-self of node j only
  return off <= 0 || (off < s_q && tv_row[off] != 0);
}

// ---------------------------------------------------------------- pass 1
// ELT: bytes of a stored K/V value (2 bf16, 1 int8)
template <int D, int ELT>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 4 : 2) paged_partials_sm90(const __grid_constant__ Params p) {
  pdl_launch_dependents();  // every CTA of this grid is resident: the merge may launch
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ps = p.page_size, S = p.s_q, rs = p.rep * p.s_q;
  const Layout L = make_layout(D, ELT, ps, p.qcap, p.n_lanes);
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;  // mma fragment row group / column pair
  const int n_items = p.n_w * p.kv_heads;
  int* meta = reinterpret_cast<int*>(smem + L.meta);  // n, page, pos, kv head, entry
  int* mslot = meta + kStages * kMeta;                // [stage][n_lanes] holder slots
  int* mlane = mslot + kStages * p.n_lanes;           // [stage][n_lanes] their lanes
  int* mlen = mlane + kStages * p.n_lanes;            // [stage][n_lanes] their lengths
  float* comb = reinterpret_cast<float*>(smem + L.comb);
  float* comb_ml = reinterpret_cast<float*>(smem + L.ml);
  float* ksc = reinterpret_cast<float*>(smem + L.scale);
  float* vsc = ksc + ps;
  const uint32_t bar0 = smem_u32(smem + L.bar);
  const uint32_t sbase = smem_u32(smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    fence_mbar_init();
  } else if (threadIdx.x == 32) {
    prefetch_map(&p.map_k);
    prefetch_map(&p.map_v);
  }
  __syncthreads();

  // warp 0: start the copies of this CTA's k-th item into ring slot k %
  // kStages and publish its header; a dead item (an all-empty entry) ends
  // the walk, and every later item is published empty. The entry's page,
  // position and lanes are read together: one round trip before the copies
  bool walking = true;
  auto fetch = [&](int k) {
    const int s = k % kStages;
    const int i = blockIdx.x + k * gridDim.x;
    walking = walking && i < n_items;
    const int w = walking ? i / p.kv_heads : 0;
    int aux = 0;
    if (walking && lane < 2) aux = lane == 0 ? p.work_pages[w] : p.work_pos[w];
    int cnt = 0;
    for (int r0 = 0; walking && r0 < p.n_lanes; r0 += 32) {
      const int r = r0 + lane;
      const int sl = r < p.n_lanes ? p.work_refs[static_cast<size_t>(w) * p.n_lanes + r] : -1;
      const unsigned b = __ballot_sync(0xffffffffu, sl >= 0);
      if (sl >= 0) {
        const int at = cnt + __popc(b & ((1u << lane) - 1u));
        mslot[s * p.n_lanes + at] = sl;
        mlane[s * p.n_lanes + at] = r;
      }
      cnt += __popc(b);
    }
    walking = walking && cnt > 0;
    if (!walking) {
      if (lane == 0) meta[s * kMeta] = 0;
      return;
    }
    const int g = i - w * p.kv_heads;
    const int page = __shfl_sync(0xffffffffu, aux, 0);
    const int pos = __shfl_sync(0xffffffffu, aux, 1);
    if (lane == 0) {
      meta[s * kMeta + 0] = cnt;
      meta[s * kMeta + 1] = page;
      meta[s * kMeta + 2] = pos;
      meta[s * kMeta + 3] = g;
      meta[s * kMeta + 4] = w;
    }
    const int nq = min(cnt * rs, p.qcap);
    const uint32_t bar = bar0 + 8 * s;
    if (lane == 0) mbar_expect_tx(bar, 2u * ps * D * ELT + nq * D * 2u);
    __syncwarp();  // the lane lists above are read below
    const uint32_t st = sbase + s * L.stage;
    constexpr int kBox = D * ELT < 128 ? D : 128 / ELT;  // elements of a box row
    if (lane < D / kBox) {  // the page's K and V tiles: one box per 128-byte column block
      const uint32_t off = lane * ps * kBox * ELT;
      tma_load_3d(st + off, &p.map_k, bar, lane * kBox, g, page * ps);
      tma_load_3d(st + L.v + off, &p.map_v, bar, lane * kBox, g, page * ps);
    }
    for (int r = lane; r < nq; r += 32) {
      int c, h, j;
      row_of(p, g, r, c, h, j);
      const int slot = mslot[s * p.n_lanes + c];
      bulk_copy(sbase + L.q + s * L.qstage + r * L.qrow,
                p.q + ((static_cast<size_t>(slot) * S + j) * p.n_heads + h) * D, D * 2, bar);
    }
    for (int c = lane; c < cnt; c += 32) mlen[s * p.n_lanes + c] = p.lengths[mslot[s * p.n_lanes + c]];
  };

  if (warp == 0)
    for (int k = 0; k < kStages - 1; ++k) fetch(k);

  for (int k = 0;; ++k) {
    __syncthreads();  // slot (k - 1) % kStages is free; item k's header is visible
    if (warp == 0) fetch(k + kStages - 1);
    const int s = k % kStages;
    const int cnt = meta[s * kMeta];
    if (cnt == 0) break;
    const int page = meta[s * kMeta + 1], pos0 = meta[s * kMeta + 2] * ps;
    const int g = meta[s * kMeta + 3], w = meta[s * kMeta + 4];
    if (ELT == 1 && threadIdx.x < ps) {  // int8: the page's scales, while the tile lands
      const size_t at = (static_cast<size_t>(page) * ps + threadIdx.x) * p.kv_heads + g;
      ksc[threadIdx.x] = __bfloat162float(p.scale_k[at]) * p.scale_log2;
      vsc[threadIdx.x] = __bfloat162float(p.scale_v[at]);
    }
    mbar_wait(bar0 + 8 * s, (k / kStages) & 1);
    if (ELT == 1) __syncthreads();
    const uint32_t sk = sbase + s * L.stage, sv = sk + L.v, sq = sbase + L.q + s * L.qstage;
    const unsigned char* pk = smem + s * L.stage;
    const unsigned char* pv = pk + L.v;
    const int rows = cnt * rs;
    const int* lanes_of = mlane + s * p.n_lanes;
    const int* slots_of = mslot + s * p.n_lanes;
    const int* lens_of = mlen + s * p.n_lanes;

    for (int rg = 0; rg < rows; rg += p.qcap) {
      const int nr = min(p.qcap, rows - rg);
      if (rg > 0) {  // more rows than a slot holds: restage the query rows
        __syncthreads();
        for (int idx = threadIdx.x; idx < nr * (D / 8); idx += kThreads) {
          const int r = idx / (D / 8), ch = idx - r * (D / 8);
          int c, h, j;
          row_of(p, g, rg + r, c, h, j);
          const bf16* src =
              p.q + ((static_cast<size_t>(slots_of[c]) * S + j) * p.n_heads + h) * D + ch * 8;
          *reinterpret_cast<uint4*>(smem + L.q + s * L.qstage + r * L.qrow + ch * 16) =
              *reinterpret_cast<const uint4*>(src);
        }
        fence_proxy_async();  // before a later copy rewrites these rows
        __syncthreads();
      }
      for (int mt = 0; mt < nr; mt += 16) {
        // A: this tile's 16 query rows (rows past nr are never written out)
        uint32_t qa[D / 16][4];
        {
          const int mi = lane >> 3;
          const uint32_t a = sq + (mt + (mi & 1) * 8 + (lane & 7)) * L.qrow + (mi >> 1) * 16;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qa[kk], a + kk * 32);
        }
        // the two rows this thread holds: gr and gr + 8
        int rlen[2], rj[2];
        const int* rtv[2];
        bool rok[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rl = mt + gr + 8 * hh;
          rok[hh] = rl < nr;
          const int R = rg + (rok[hh] ? rl : 0);
          int c, h;
          row_of(p, g, R, c, h, rj[hh]);
          const int slot = slots_of[c];
          rlen[hh] = lens_of[c];
          rtv[hh] = p.tree_vis ? p.tree_vis + (static_cast<size_t>(slot) * S + rj[hh]) * S : nullptr;
        }

        // S = Q K^T over this warp's token blocks, masked and scaled
        float sc[kBlocksPerWarp][2][4];
        float mrow[2] = {kNegInf, kNegInf};
        uint32_t vis = 0;
#pragma unroll
        for (int bi = 0; bi < kBlocksPerWarp; ++bi) {
          const int blk = warp + bi * kWarps;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[bi][nt][e] = 0.f;
          if (blk * kTokBlock >= ps) continue;
          const int tok0 = blk * kTokBlock;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t b[4];
            if constexpr (ELT == 2) {
              const int mi = lane >> 3;
              ldsm_x4(b, sk + tile_off<D * ELT>(ps, tok0 + (mi >> 1) * 8 + (lane & 7),
                                                 kk * 32 + (mi & 1) * 16));
            } else {
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                const unsigned char* at =
                    pk + tile_off<D * ELT>(ps, tok0 + nt * 8 + gr, kk * 16 + 2 * tq);
                b[2 * nt] = i8x2(at[0], at[1]);
                b[2 * nt + 1] = i8x2(at[8], at[9]);
              }
            }
            mma16816(sc[bi][0], qa[kk], b[0], b[1]);
            mma16816(sc[bi][1], qa[kk], b[2], b[3]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hh = e >> 1, tok = tok0 + nt * 8 + 2 * tq + (e & 1);
              const bool v = rok[hh] && visible(pos0 + tok, rlen[hh], rj[hh], S, rtv[hh]);
              const float x = sc[bi][nt][e] * (ELT == 1 ? ksc[tok] : p.scale_log2);
              sc[bi][nt][e] = v ? x : kNegInf;
              mrow[hh] = fmaxf(mrow[hh], sc[bi][nt][e]);
              vis |= static_cast<uint32_t>(v) << (bi * 8 + nt * 4 + e);
            }
        }
        float lrow[2] = {0.f, 0.f};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mrow[hh] = fmaxf(mrow[hh], __shfl_xor_sync(0xffffffffu, mrow[hh], 1));
          mrow[hh] = fmaxf(mrow[hh], __shfl_xor_sync(0xffffffffu, mrow[hh], 2));
        }

        // O = P V: P gated by the mask, rounded to bf16 as the A operand
        float o[D / 8][4];
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
        for (int bi = 0; bi < kBlocksPerWarp; ++bi) {
          const int blk = warp + bi * kWarps;
          if (blk * kTokBlock >= ps) continue;
          const int tok0 = blk * kTokBlock;
          float pr[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hh = e >> 1;
              const float x = ((vis >> (bi * 8 + nt * 4 + e)) & 1u)
                                  ? ex2(sc[bi][nt][e] - mrow[hh])
                                  : 0.f;
              lrow[hh] += x;
              pr[nt][e] = ELT == 1 ? x * vsc[tok0 + nt * 8 + 2 * tq + (e & 1)] : x;
            }
          const uint32_t a[4] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[0][2], pr[0][3]),
                                 pack_bf16(pr[1][0], pr[1][1]), pack_bf16(pr[1][2], pr[1][3])};
#pragma unroll
          for (int nd = 0; nd < D / 16; ++nd) {
            uint32_t b[4];
            if constexpr (ELT == 2) {
              const int mi = lane >> 3;
              ldsm_x4_t(b, sv + tile_off<D * ELT>(ps, tok0 + (mi & 1) * 8 + (lane & 7),
                                                   nd * 32 + (mi >> 1) * 16));
            } else {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int c = nd * 16 + half * 8 + gr, t0 = tok0 + 2 * tq;
                const auto at = [&](int t) { return pv[tile_off<D * ELT>(ps, t, c)]; };
                b[2 * half] = i8x2(at(t0), at(t0 + 1));
                b[2 * half + 1] = i8x2(at(t0 + 8), at(t0 + 9));
              }
            }
            mma16816(o[2 * nd], a, b[0], b[1]);
            mma16816(o[2 * nd + 1], a, b[2], b[3]);
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          lrow[hh] += __shfl_xor_sync(0xffffffffu, lrow[hh], 1);
          lrow[hh] += __shfl_xor_sync(0xffffffffu, lrow[hh], 2);
        }

        // this warp's (m, l, O) into shared memory, then all four combined
        // per row in warp order into the item's partials
        float* cw = comb + warp * 16 * (D + 4);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<float2*>(cw + gr * (D + 4) + n * 8 + 2 * tq) =
              make_float2(o[n][0], o[n][1]);
          *reinterpret_cast<float2*>(cw + (gr + 8) * (D + 4) + n * 8 + 2 * tq) =
              make_float2(o[n][2], o[n][3]);
        }
        if (tq == 0) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            comb_ml[(warp * 16 + gr + 8 * hh) * 2] = mrow[hh];
            comb_ml[(warp * 16 + gr + 8 * hh) * 2 + 1] = lrow[hh];
          }
        }
        __syncthreads();
        {
          const int row = threadIdx.x >> 3, part = threadIdx.x & 7;
          if (mt + row < nr) {
            float mw[kWarps], m = kNegInf, l = 0.f;
#pragma unroll
            for (int v = 0; v < kWarps; ++v) {
              mw[v] = comb_ml[(v * 16 + row) * 2];
              m = fmaxf(m, mw[v]);
            }
#pragma unroll
            for (int v = 0; v < kWarps; ++v) {
              mw[v] = ex2(mw[v] - m);
              l += comb_ml[(v * 16 + row) * 2 + 1] * mw[v];
            }
            const int R = rg + mt + row;
            int c, h, j;
            row_of(p, g, R, c, h, j);
            const size_t base =
                ((static_cast<size_t>(w) * p.n_lanes + lanes_of[c]) * p.n_heads + h) * S + j;
#pragma unroll
            for (int q4 = 0; q4 < D / 32; ++q4) {
              const int col = part * (D / 8) + q4 * 4;
              float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
              for (int v = 0; v < kWarps; ++v) {
                const float4 x4 =
                    *reinterpret_cast<const float4*>(comb + (v * 16 + row) * (D + 4) + col);
                acc.x += x4.x * mw[v];
                acc.y += x4.y * mw[v];
                acc.z += x4.z * mw[v];
                acc.w += x4.w * mw[v];
              }
              *reinterpret_cast<float4*>(p.o_part + base * D + col) = acc;
            }
            if (part == 0) {
              p.m_part[base] = m;
              p.l_part[base] = l;
            }
          }
        }
        __syncthreads();  // the combine buffer is free for the next tile
      }
    }
  }
}

// ----------------------------------------------------------------- merge
// one warp per output row (slot, j, head): the matching partials of the
// live entries, combined in ascending entry order, eight at a time with
// their loads in flight together. work_refs is an input, so the scan of
// the first kScan chunks runs before griddepcontrol.wait; only the partials
// wait for pass 1.
template <int D>
__global__ void __launch_bounds__(kThreads) paged_merge_sm90(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const int S = p.s_q, H = p.n_heads;
  if (row >= p.n_slots * S * H) return;
  const int slot = row / (S * H), j = (row / H) % S, h = row % H;
  const bool has_d = lane < D / 4;

  float m = kNegInf, l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  bool ended = false;
  for (int base = 0; base < p.n_w && !ended; base += 32 * kScan) {
    // which of the next kScan chunks' entries are live, and in which lane
    // this slot sits: every load in flight together
    bool live[kScan];
    int hit[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      live[u] = false;
      hit[u] = -1;
    }
    for (int r = 0; r < p.n_lanes; ++r) {
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        const int e = base + 32 * u + lane;
        const int sl = e < p.n_w ? p.work_refs[static_cast<size_t>(e) * p.n_lanes + r] : -1;
        live[u] |= sl >= 0;
        if (sl == slot) hit[u] = r;
      }
    }
    pdl_wait();  // pass 1's partials are complete and visible
    float mi[kScan], li[kScan];
    unsigned match[kScan];
    unsigned long long idx[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int e = base + 32 * u + lane;
      const unsigned dead = __ballot_sync(0xffffffffu, e < p.n_w && !live[u]);
      const unsigned before = dead ? (1u << (__ffs(dead) - 1)) - 1u : 0xffffffffu;
      match[u] = ended ? 0u : __ballot_sync(0xffffffffu, hit[u] >= 0) & before;
      ended = ended || dead != 0u || e - lane + 32 >= p.n_w;
      // this lane's matching partial, if any: its row in (W, lanes, H, S)
      idx[u] = ((static_cast<unsigned long long>(e) * p.n_lanes + (hit[u] < 0 ? 0 : hit[u])) * H +
                h) * S + j;
      mi[u] = kNegInf;
      li[u] = 0.f;
      if ((match[u] >> lane) & 1u) {
        mi[u] = p.m_part[idx[u]];
        li[u] = p.l_part[idx[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      while (match[u]) {
        int ks[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          ks[v] = match[u] ? __ffs(match[u]) - 1 : -1;
          match[u] &= match[u] - 1u;
        }
        float4 ov[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const unsigned long long ix = __shfl_sync(0xffffffffu, idx[u], ks[v] < 0 ? 0 : ks[v]);
          ov[v] = (ks[v] >= 0 && has_d)
                      ? *reinterpret_cast<const float4*>(p.o_part + ix * D + 4 * lane)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        float mu[8], lu[8], mb = m;
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          mu[v] = __shfl_sync(0xffffffffu, mi[u], ks[v] < 0 ? 0 : ks[v]);
          lu[v] = __shfl_sync(0xffffffffu, li[u], ks[v] < 0 ? 0 : ks[v]);
          if (ks[v] >= 0) mb = fmaxf(mb, mu[v]);
        }
        const float a = ex2(m - mb);
        l *= a;
        o.x *= a;
        o.y *= a;
        o.z *= a;
        o.w *= a;
        m = mb;
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          if (ks[v] < 0) break;
          const float wv = ex2(mu[v] - m);
          l += lu[v] * wv;
          o.x += ov[v].x * wv;
          o.y += ov[v].y * wv;
          o.z += ov[v].z * wv;
          o.w += ov[v].w * wv;
        }
      }
    }
  }
  if (has_d) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    uint2 packed;
    packed.x = pack_bf16(o.x * inv, o.y * inv);
    packed.y = pack_bf16(o.z * inv, o.w * inv);
    *reinterpret_cast<uint2*>(p.out + static_cast<size_t>(row) * D + 4 * lane) = packed;
  }
}

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, fetched once through the
// runtime (no libcuda link)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// one layer pool (pages, ps, H_kv, Dh) as a 3-D map (Dh, H_kv, pages x ps)
// whose box is one 128-byte column block (or the whole row) of one kv head's
// ps token rows, swizzled to the row width
bool encode_pool(CUtensorMap* map, const void* pool, int elt, int d, int kv_heads, int ps,
                 int n_pages) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int row = d * elt, box = row < 128 ? d : 128 / elt;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(kv_heads),
                              static_cast<cuuint64_t>(n_pages) * ps};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row),
                                 static_cast<cuuint64_t>(row) * kv_heads};
  const cuuint32_t boxes[3] = {static_cast<cuuint32_t>(box), 1, static_cast<cuuint32_t>(ps)};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = row >= 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : row == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, elt == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(pool), dims, strides, boxes, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// per device: the SM count, read once; per instantiation and device: the
// shared memory opted in and the CTAs an SM holds at that size
int sm_count(int dev) {
  static int count[kMaxDevices] = {};
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

template <int D, int ELT>
cudaError_t launch(Params& p, cudaStream_t st) {
  const Layout L = make_layout(D, ELT, p.page_size, p.qcap, p.n_lanes);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  if (!encode_pool(&p.map_k, p.pool_k, ELT, D, p.kv_heads, p.page_size, p.n_pages) ||
      !encode_pool(&p.map_v, p.pool_v, ELT, D, p.kv_heads, p.page_size, p.n_pages))
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  static int opted[kMaxDevices] = {}, occ_bytes[kMaxDevices] = {}, occ[kMaxDevices] = {};
  auto kernel = paged_partials_sm90<D, ELT>;
  if (L.total > opted[dev]) {
    err = set_smem(kernel, L.total);
    if (err != cudaSuccess) return err;
    opted[dev] = L.total;
  }
  if (occ_bytes[dev] != L.total) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[dev], kernel, kThreads, L.total);
    if (err != cudaSuccess) return err;
    occ_bytes[dev] = L.total;
  }
  const long long items = static_cast<long long>(p.n_w) * p.kv_heads;
  const long long fit = static_cast<long long>(occ[dev] > 0 ? occ[dev] : 1) * sm_count(dev);
  const int grid = static_cast<int>(items < fit ? (items > 0 ? items : 1) : fit);
  kernel<<<grid, kThreads, L.total, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.n_slots * p.s_q * p.n_heads + kWarps - 1) / kWarps);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_merge_sm90<D>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The invariants plan_paged routes on; anything else is refused before
// launch with cudaErrorInvalidValue.
extern "C" int tb_paged_attention_sm90(
    int kv_dtype, const void* q, const void* pool_k, const void* pool_v, const void* scale_k,
    const void* scale_v, const int* work_pages, const int* work_refs, const int* work_pos,
    const int* lengths, const int* tree_vis, void* out, float* o_part, float* m_part,
    float* l_part, int n_slots, int s_q, int n_heads, int kv_heads, int head_dim, int page_size,
    int n_pages, int n_w, int n_lanes, float sm_scale, void* stream) {
  const bool int8 = kv_dtype == kI8;
  if ((kv_dtype != kBF16 && !int8) || (int8 && (scale_k == nullptr || scale_v == nullptr)) ||
      (head_dim != 32 && head_dim != 64 && head_dim != 128) || page_size % kTokBlock != 0 ||
      page_size < kMinPage || page_size > kMaxPage || kv_heads < 1 || n_heads % kv_heads != 0 ||
      s_q < 1 || (n_heads / kv_heads) * s_q > kMaxRowsPerHead || n_slots < 1 || n_lanes < 1 ||
      n_lanes > kMaxLanes ||
      n_pages < 1 || n_w < 0 || !aligned16(q) || !aligned16(pool_k) || !aligned16(pool_v) || !aligned16(out) ||
      !aligned16(o_part))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.pool_k = pool_k;
  p.pool_v = pool_v;
  p.scale_k = static_cast<const bf16*>(scale_k);
  p.scale_v = static_cast<const bf16*>(scale_v);
  p.work_pages = work_pages;
  p.work_refs = work_refs;
  p.work_pos = work_pos;
  p.lengths = lengths;
  p.tree_vis = tree_vis;
  p.out = static_cast<bf16*>(out);
  p.o_part = o_part;
  p.m_part = m_part;
  p.l_part = l_part;
  p.n_slots = n_slots;
  p.s_q = s_q;
  p.n_heads = n_heads;
  p.kv_heads = kv_heads;
  p.page_size = page_size;
  p.n_pages = n_pages;
  p.n_w = n_w;
  p.n_lanes = n_lanes;
  p.rep = n_heads / kv_heads;
  const int rows = n_lanes * p.rep * s_q;
  p.qcap = rows >= kQCap ? kQCap : (rows + 15) / 16 * 16;
  p.magic_rows = div_magic(p.rep * s_q);
  p.magic_s = div_magic(s_q);
  p.scale_log2 = sm_scale * 1.4426950408889634f;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32) return static_cast<int>(int8 ? launch<32, 1>(p, st) : launch<32, 2>(p, st));
  if (head_dim == 64) return static_cast<int>(int8 ? launch<64, 1>(p, st) : launch<64, 2>(p, st));
  return static_cast<int>(int8 ? launch<128, 1>(p, st) : launch<128, 2>(p, st));
}
