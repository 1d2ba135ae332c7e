// Flash attention backward for Hopper (sm_90a): GQA, bf16, full sequences
// (the training step), causal or not, at (q/k, v) head dims (128, 128),
// (64, 64) and (80, 80) (B4; 80 is HuBERT-XLarge's, bidirectional) and
// (192, 128) (B4m: DeepSeek-V3's MLA, nope 128 + rope 64, v 128).  fp32
// at every pair, and bf16 at (16, 16), take flash_attention_bwd_mma.cu
// (B4f) instead.
//
// The JAX package has no backward kernel: it differentiates
// repro/models/attention.py:flash_ref (the plain version of the Pallas
// forward, repro/kernels/flash_attention/kernel.py:flash_fwd_pallas), so
// the TPU gets its backward from XLA.  This is that backward as kernels:
// from q, k (B, S, H or Hkv, HDK), v (B, S, Hkv, HDV), the forward's
// output o and its gradient do (B, S, H, HDV) and the forward's row
// logsumexp lse (B, H, S, fp32, natural log; the TMA + wgmma forward
// writes it when asked), it computes dq, dk, dv in bf16 with fp32
// accumulation:
//   P = exp(scale q k^T - lse), dP = do v^T, D = rowsum(do o),
//   dS = P (dP - D), dq = scale dS k, dk = scale dS^T q, dv = P^T do.
//
// What bounds it on an H100: operations.  Five products of the forward's
// size where the forward has two (causal, B 2, S 4096, 32 heads: 0.69
// TFLOP of causal pairs, 0.69 ms at 989 TFLOP/s), against 0.2 GB of bytes.
// At (128, 128) these kernels do seven (S and dP twice, so that dq needs
// no atomics): 0.97 ms at that rate.  At (192, 128), B 1, S 4096, 128
// heads: a causal pair costs 2 (192 + 128 + 128 + 192 + 192) flops for
// the five products, 1.79 TFLOP, 1.81 ms; here the kernels do the five
// and move dS through device memory instead of recomputing S and dP:
// 2.2 GB of bf16 tiles written and read once, 1.3 ms of bytes at 3.35
// TB/s, spread over both passes.
//
// Precision: P and dS are rounded to bf16 as the A operands of their
// products, as the forward rounds P for P v; the dS^T tiles that carry dS
// to the dQ pass at (192, 128) are those same bf16 values.
//
// Determinism: every sum is taken by one block in a fixed order (dk and dv
// over the group's query heads and query tiles, dq over the key tiles), so
// dq, dk and dv are the same bits on every run; no atomics.
//
// Design at (128, 128) (B4): three kernels.
//   1. bwd_prep_kernel: one warp a row (b, h, position) writes
//      lse2 = lse log2(e) and D = rowsum(do o) into an fp32 workspace of
//      two (B, H, S64) arrays, S64 = S rounded up to 64; positions past S
//      get lse2 = +inf and D = 0, so P = 2^(s - lse2) is 0 there and the
//      other kernels copy a 64-position slice without bounds.
//   2. bwd_dkdv_kernel: one block per (128-key tile, KV head, batch row),
//      the heaviest (first, causal) key tiles first.  Warp-specialised as
//      the forward's flash_wgmma_kernel: warpgroup 2 is the producer, one
//      thread of which loads K and V once (TMA, 4-D tensor maps, 64-column
//      boxes with 128-byte swizzle) and streams the 64-query tiles of q and
//      do, with their lse2 and D slices (bulk copies), for each of the G
//      query heads and each query tile from the diagonal on (causal),
//      through a ring of STAGES stages with full / empty mbarriers.
//      Warpgroups 0 and 1 own 64 keys each and, per stage:
//        S^T = K q^T and dP^T = V do^T (wgmma m64n64k16, both operands
//          K-major in shared memory),
//        P^T in fp32 registers while dP^T is still in flight (the causal
//          mask only on the tiles that cross the diagonal), rounded to
//          bf16 and repacked as A fragments,
//        dv += P^T do (wgmma m64n128k16, A from registers, do read
//          N-major through the transpose bit) in flight while
//          dS^T = P^T (dP^T - D) is formed the same way, then
//          dk += dS^T q.
//      dk and dv stay in registers (128 a thread at (128, 128)) over the
//      whole group and are written once.
//   3. bwd_dq_kernel: one block per (128-query tile, query head, batch
//      row), the heaviest (last, causal) query tiles first.  The producer
//      loads q and do once and streams 128-key tiles of K and V up to the
//      diagonal through a 2-stage ring; warpgroups 0 and 1 own 64 queries
//      each and compute S = q K^T and dP = do V^T (wgmma m64n128k16, SS),
//      P while dP is in flight, dS (masks on the diagonal tile and on keys
//      past S), then dq += dS K (RS, K through the transpose bit); dq is
//      written once.
// A warpgroup computes every tile its loop visits, also one wholly above
// the diagonal (masked to 0): a branch around the products made ptxas
// serialise them (C7520), which cost more than the few masked tiles.
// Registers: setmaxnreg gives each consumer thread 240 and the producer 24
// (384 threads, one block an SM at 195 KB of shared memory at (128, 128));
// ptxas reports no spills.
// (64, 64) is the same kernels' own instantiation: q / K rows of one
// 64-column box, dk and dv 32 fp32 a thread, 97 KB of shared memory.
// (80, 80) runs the same kernels on the same (128, 128) tiles: the tensor
// maps have the operands' true width, so a row is two 64-column boxes,
// the second zero-filled past column 80 by TMA; every product runs at 128
// (37.5% of each multiplies zeros), and dq, dk, dv store 80 columns a row
// (Bwd::hdk, hdv).  The prep kernel's rowsum(do o) loops over HDV / 2
// bf16 pairs a warp, for 128 and 80 alike.
//
// Design at (192, 128) (B4m): the q and K rows are three 64-column boxes,
// do and V two, and dk alone holds 96 fp32 a thread, so B4's dK/dV block
// (dk and dv of 64 keys in each warpgroup, 160 registers before any
// product of a stage) does not fit at 64-query stages.  The prep kernel,
// then:
//   2m. bwd_dkdv_split_kernel: one block per (64-key tile, KV head, batch
//      row), head-major (the tiles of a head adjacent, the heaviest
//      first, so the blocks in flight share a head's q/do stream in L2).
//      The producer streams 64-query stages of q and do (40 KB, 3
//      stages).  The two consumer warpgroups split the work by role over
//      the same 64 keys: warpgroup 0 forms S^T = K q^T (wgmma m64n64k16,
//      K's A fragments held in registers, q K-major), P^T (ex2.approx),
//      hands P^T (fp32) to warpgroup 1 through shared memory (two buffers
//      under named barriers) and holds dv += P^T do (m64n128k16); warpgroup
//      1 forms dP^T = V do^T (V's fragments in registers), dS^T = P^T
//      (dP^T - D), holds dk += dS^T q (m64n192k16) and writes the bf16
//      dS^T tile to shared memory (128-byte swizzle), from where one thread
//      stores it by TMA into the dS workspace.  Each warpgroup issues the
//      next stage's first product right behind this stage's last.  The
//      products balance: 64 x 64 x 192 + 64 x 128 x 64 multiply-adds a
//      stage in each warpgroup.
//   3m. bwd_dq_gemm_kernel: one block per (128-query tile, head, batch
//      row), head-major, heaviest first; warpgroup w owns 64 queries and
//      adds dq += dS K over the key tiles up to its diagonal, in order,
//      from 4 stages of a 64-key K tile and the two warpgroups' dS^T tiles
//      (wgmma m64n192k16, dS read M-major and K N-major through the
//      transpose bits): no exp and no recomputed S or dP, so two of the
//      seven products are gone.
// What a 64-key block costs: each q/do tile is streamed once per 64 keys
// (twice B4's traffic from L2 a key); a 2-block cluster that multicast
// each stage to both key tiles of a pair was tried and ran slower.
// Not yet: the dK/dV pass is the larger part; a persistent schedule would
// hide each block's prologue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_wgmma.cuh"
#include "hopper_tma.cuh"
#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int CONSUMERS = 2;                 // warpgroups of 64 rows
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int ROWS = 64 * CONSUMERS;         // resident rows a block
constexpr int RES_BOX = ROWS * 128;          // 64 columns x 128 rows: 16 KB
constexpr int PAD = 64;                      // workspace rows pad to this
constexpr float LOG2E = 1.4426950408889634f;

// B4's tile shapes and shared memory at (128, 128): q / K rows are BK
// 64-column boxes, do / V rows BV.  The dK/dV pass streams STREAM
// queries a stage through STAGES stages; the dQ pass KT keys a stage
// through DQ_STAGES.  (192, 128) runs bwd_dkdv_split_kernel and
// bwd_dq_gemm_kernel, with SplitCfg and GemmCfg.
template <int HDK, int HDV>
struct Cfg {
  static_assert(HDK == HDV && (HDK == 128 || HDK == 64),
                "B4's kernels: (128, 128) or (64, 64) tiles");
  static constexpr int BK = HDK / 64, BV = HDV / 64;
  static constexpr int STREAM = 64;
  static constexpr int STAGES = 4;
  static constexpr int KT = 128;
  static constexpr int DQ_STAGES = 2;
  static constexpr int RES_BYTES = (BK + BV) * RES_BOX;
  static constexpr int STR_BOX = STREAM * 128;
  static constexpr int STR_STAGE = (BK + BV) * STR_BOX;
  static constexpr int KT_BOX = KT * 128;
  static constexpr int KT_STAGE = (BK + BV) * KT_BOX;
  static constexpr int RING = STAGES * STR_STAGE > DQ_STAGES * KT_STAGE
                                  ? STAGES * STR_STAGE
                                  : DQ_STAGES * KT_STAGE;
  static constexpr int STAT_BYTES = 2 * STREAM * 4;   // lse2 and D of a tile
  static constexpr int MAX_STAGES = STAGES > DQ_STAGES ? STAGES : DQ_STAGES;
  static constexpr int BAR_BYTES = 8 * (1 + 2 * MAX_STAGES);
  static constexpr int SMEM_BYTES =
      1024 + RES_BYTES + RING + STAGES * STAT_BYTES + BAR_BYTES;
  static_assert(SMEM_BYTES <= 232448, "above a block's shared memory");
  static_assert(STREAM % 16 == 0 && KT % 16 == 0 && ROWS % KT == 0,
                "tiles of whole k16 slices");
};

// bwd_dkdv_split_kernel: 64 keys a block (K and V resident), 64-query
// stages of q, do and their lse2 and D through STAGES stages, two
// buffers of P^T (fp32, 32 values a consumer thread) handed from the
// warpgroup that forms it to the one that forms dS^T, and two dS^T tiles
// (bf16, 128-byte swizzle) on their way out by TMA.
template <int HDK, int HDV>
struct SplitCfg {
  static constexpr int BK = HDK / 64, BV = HDV / 64;
  static constexpr int ROWS = 64;                     // keys; queries a stage
  static constexpr int BOX = ROWS * 128;              // 64 rows x 64 columns
  static constexpr int RES_BYTES = (BK + BV) * BOX;   // K and V
  static constexpr int STAGE = (BK + BV) * BOX;       // q and do
  static constexpr int STAGES = 3;
  static constexpr int EXCH = 32 * 128 * 4;           // one P^T buffer
  static constexpr int DS_BOX = BOX;                  // one dS^T tile, bf16
  static constexpr int STAT_BYTES = 2 * ROWS * 4;
  static constexpr int BAR_BYTES = 8 * (1 + 2 * STAGES);
  static constexpr int SMEM_BYTES = 1024 + RES_BYTES + STAGES * STAGE +
                                    2 * DS_BOX + 2 * EXCH +
                                    STAGES * STAT_BYTES + BAR_BYTES;
  static_assert(SMEM_BYTES <= 232448, "above a block's shared memory");
};

struct Bwd {
  const bf16 *o, *dout;
  const float* lse;          // (B, H, S)
  float* ws;                 // lse2 then D, each (B, H, S64)
  bf16 *dq, *dk, *dv;
  bf16* ds;                  // (192, 128): dS^T tiles, n_tri a (b, h)
  int B, S, S64, H, Hkv, G;
  int hdk, hdv;              // the operands' head dims (row lengths)
  int n_tri;                 // 64 x 64 tiles of dS a (b, h)
  float scale, scale_log2;
  long long ws_half;         // B * H * S64
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory: 1024-aligned resident tiles, the ring, the stats, the
// barriers (one-shot, full[stages], empty[stages]).
template <typename C>
struct Smem {
  uint32_t res, ring, stats, bar, full0, empty0;
  __device__ explicit Smem(unsigned char* raw) {
    const uint32_t base = (smem_u32(raw) + 1023) & ~1023u;
    res = base;
    ring = res + C::RES_BYTES;
    stats = ring + C::RING;
    bar = stats + C::STAGES * C::STAT_BYTES;
    full0 = bar + 8;
    empty0 = full0 + 8 * C::MAX_STAGES;
  }
  __device__ void init(int stages) const {
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      for (int s = 0; s < stages; ++s) {
        mbar_init(full0 + 8 * s, 1);
        mbar_init(empty0 + 8 * s, CONSUMERS * 4);   // one arrival per warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// K-major operand descriptor for k step kk (16 columns) of a tile of
// 64-column boxes `box` bytes apart.
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int kk, int box) {
  return desc_sw128(tile + (kk / 4) * box + (kk % 4) * 32, 16, 1024);
}

// N-major B descriptor for k step kk (16 rows) of a tile of 64-column
// boxes `box` bytes apart.
__device__ __forceinline__ uint64_t ndesc(uint32_t tile, int kk, int box) {
  return desc_sw128(tile + kk * 2048, box, 1024);
}

// The A fragments (registers) of k16 slice kk of a 64-row tile of
// 128-byte-swizzled 64-column boxes `box` bytes apart, as TMA wrote it:
// this warp's 16 rows, by ldmatrix.
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], uint32_t tile,
                                       int kk, int box) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32 % 4;
  const int r = 16 * w + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int j = 2 * kk + (lane >> 4);          // 16-byte piece of the row
  ldsm_x4(a, tile + (j / 8) * box + r * 128 + (((j % 8) ^ (r & 7)) << 4));
}

// Write 64 rows x N of an fp32 accumulator (m64nN layout), times `mul`,
// as bf16 rows at dst(r) for each row r of the warpgroup below `limit`
// (r counted from the warpgroup's first row `r0`); only the first `cols`
// columns (a multiple of 8) where the row is shorter than the tile.
template <int N, typename RowPtr>
__device__ __forceinline__ void store_acc(const float (&acc)[N / 2],
                                          float mul, int r0, int limit,
                                          RowPtr dst, int cols = N) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32 % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 16 * warp + lane / 4 + 8 * i;
    if (r >= limit) continue;
    bf16* p = dst(r) + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      if (8 * j < cols)
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) = __floats2bfloat162_rn(
            acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
  }
}

// HDV: the v head dim, 128, 80 or 64; lane l sums the bf16 pairs l, l + 32,
// ... below HDV / 2.
template <int HDV>
__global__ void __launch_bounds__(256) bwd_prep_kernel(const Bwd a) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= a.ws_half) return;
  const int lane = threadIdx.x % 32;
  const int s = static_cast<int>(row % a.S64);
  const long long bh = row / a.S64;               // b * H + h
  float sum = 0.f, lse2 = INFINITY;
  if (s < a.S) {
    const int h = static_cast<int>(bh % a.H);
    const long long b = bh / a.H;
    const long long at = ((b * a.S + s) * a.H + h) * HDV;
    const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(a.o + at);
    const auto* d2 = reinterpret_cast<const __nv_bfloat162*>(a.dout + at);
#pragma unroll
    for (int i = lane; i < HDV / 2; i += 32) {
      const float2 o = __bfloat1622float2(o2[i]);
      const float2 d = __bfloat1622float2(d2[i]);
      sum += o.x * d.x + o.y * d.y;
    }
    sum = warp_sum(sum);
    lse2 = a.lse[bh * a.S + s] * LOG2E;
  }
  if (lane == 0) {
    a.ws[row] = lse2;
    a.ws[a.ws_half + row] = sum;
  }
}

template <int HDK, int HDV, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_do,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, const Bwd a) {
  using C = Cfg<HDK, HDV>;
  constexpr int STREAM = C::STREAM, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const Smem<C> sm(smem_raw);
  const int per = a.Hkv * a.B;
  const int kt = static_cast<int>(blockIdx.x / per);   // heaviest first
  const int hkv = static_cast<int>(blockIdx.x % per) % a.Hkv;
  const int b = static_cast<int>(blockIdx.x % per) / a.Hkv;
  const int k0 = kt * ROWS;
  const int n_qt = (a.S + STREAM - 1) / STREAM;
  const int qt0 = CAUSAL ? k0 / STREAM : 0;
  const uint32_t k_u = sm.res, v_u = sm.res + C::BK * RES_BOX;
  sm.init(STAGES);

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer: one thread loads K, V once and keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(sm.bar, C::RES_BYTES);
#pragma unroll
      for (int x = 0; x < C::BK; ++x)
        tma_load_4d(k_u + x * RES_BOX, &map_k, sm.bar, x * 64, hkv, k0, b);
#pragma unroll
      for (int x = 0; x < C::BV; ++x)
        tma_load_4d(v_u + x * RES_BOX, &map_v, sm.bar, x * 64, hkv, k0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int h = hkv * a.G; h < (hkv + 1) * a.G; ++h) {
        const float* st = a.ws + (static_cast<long long>(b) * a.H + h) * a.S64;
        for (int qt = qt0; qt < n_qt; ++qt) {
          mbar_wait(sm.empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = sm.full0 + 8 * stage;
          const uint32_t q_u = sm.ring + stage * C::STR_STAGE;
          const uint32_t s_u = sm.stats + stage * C::STAT_BYTES;
          mbar_expect_tx(full, C::STR_STAGE + C::STAT_BYTES);
#pragma unroll
          for (int x = 0; x < C::BK; ++x)
            tma_load_4d(q_u + x * C::STR_BOX, &map_q, full, x * 64, h,
                        qt * STREAM, b);
#pragma unroll
          for (int x = 0; x < C::BV; ++x)
            tma_load_4d(q_u + (C::BK + x) * C::STR_BOX, &map_do, full,
                        x * 64, h, qt * STREAM, b);
          bulk_load(s_u, st + qt * STREAM, STREAM * 4, full);
          bulk_load(s_u + STREAM * 4, st + a.ws_half + qt * STREAM,
                    STREAM * 4, full);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x % 32, tq = lane % 4;
    const int kw0 = k0 + 64 * wg;                      // first key here
    const int key_r = kw0 + 16 * (threadIdx.x / 32 % 4) + lane / 4;
    const uint32_t ka = k_u + wg * 64 * 128, va = v_u + wg * 64 * 128;
    const float* stats = reinterpret_cast<const float*>(
        smem_raw + (sm.stats - smem_u32(smem_raw)));
    float dk[HDK / 2], dv[HDV / 2];
#pragma unroll
    for (int i = 0; i < HDK / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) dv[i] = 0.f;
    mbar_wait(sm.bar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < a.G * (n_qt - qt0); ++it) {
      const int q0 = (qt0 + it % (n_qt - qt0)) * STREAM;
      mbar_wait(sm.full0 + 8 * stage, phase);
      const uint32_t q_u = sm.ring + stage * C::STR_STAGE;
      const uint32_t do_u = q_u + C::BK * C::STR_BOX;
      const float* lse2 = stats + stage * 2 * STREAM;
      const float* dl = lse2 + STREAM;
      // S^T = K q^T, dP^T = V do^T: 64 keys x STREAM queries; value 4 j + e
      // at key key_r + 8 (e / 2), query q0 + 8 j + 2 tq + e % 2.
      float s[STREAM / 2], dp[STREAM / 2];
#pragma unroll
      for (int i = 0; i < STREAM / 2; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDK / 16; ++kk)
        wgmma_ss<STREAM>(s, kdesc(ka, kk, RES_BOX),
                         kdesc(q_u, kk, C::STR_BOX));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HDV / 16; ++kk)
        wgmma_ss<STREAM>(dp, kdesc(va, kk, RES_BOX),
                         kdesc(do_u, kk, C::STR_BOX));
      wgmma_commit();
      // P^T (in place of S^T) while dP^T is in flight, in bf16 A
      // fragments of 16-query slices.
      wgmma_wait<1>();
      fence_regs(s);
      const bool diag = CAUSAL && kw0 + 63 > q0;
      uint32_t pa[STREAM / 16][4], da[STREAM / 16][4];
#pragma unroll
      for (int kk = 0; kk < STREAM / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int qi = 16 * kk + 8 * (e / 4) + 2 * tq + (e & 1);
          float v = exp2f(fmaf(s[8 * kk + e], a.scale_log2, -lse2[qi]));
          if (diag && key_r + 8 * ((e >> 1) & 1) > q0 + qi) v = 0.f;
          s[8 * kk + e] = v;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      }
      // dv += P^T do, in flight while dS^T is computed.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < STREAM / 16; ++kk)
        wgmma_rs<HDV>(dv, pa[kk], ndesc(do_u, kk, C::STR_BOX));
      wgmma_commit();
      wgmma_wait<1>();                             // dP^T has landed
      fence_regs(dp);
#pragma unroll
      for (int kk = 0; kk < STREAM / 16; ++kk) {
        float ds[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int qi = 16 * kk + 8 * (e / 4) + 2 * tq + (e & 1);
          ds[e] = s[8 * kk + e] * (dp[8 * kk + e] - dl[qi]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = pack_bf16(ds[2 * r], ds[2 * r + 1]);
      }
      // dk += dS^T q (scaled at the end).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < STREAM / 16; ++kk)
        wgmma_rs<HDK>(dk, da[kk], ndesc(q_u, kk, C::STR_BOX));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      if (lane == 0) mbar_arrive(sm.empty0 + 8 * stage);
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    const long long row0 = static_cast<long long>(b) * a.S * a.Hkv + hkv;
    store_acc<HDK>(dk, a.scale, kw0, a.S, [&](int r) {
      return a.dk + (row0 + static_cast<long long>(r) * a.Hkv) * a.hdk;
    }, a.hdk);
    store_acc<HDV>(dv, 1.f, kw0, a.S, [&](int r) {
      return a.dv + (row0 + static_cast<long long>(r) * a.Hkv) * a.hdv;
    }, a.hdv);
  }
}

// 2^x on ex2.approx.ftz (max relative error 2^-22; results below 2^-126
// flush to 0): the (192, 128) kernels' decay, where exp2f's slower path
// costs a tenth of the dQ pass.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Index of the 64 x 64 tile (query tile qt, key tile kt) among a (b, h)'s
// n_tri stored dS^T tiles: the causal triangle row by row, or the square.
__device__ __forceinline__ long long ds_tile(const Bwd& a, int b, int h,
                                             int qt, int kt, bool causal) {
  const int t = causal ? qt * (qt + 1) / 2 + kt : qt * (a.S64 / 64) + kt;
  return (static_cast<long long>(b) * a.H + h) * a.n_tri + t;
}

// Named barriers of the P^T hand-off, buffer b: P_FULL + b (filled),
// P_EMPTY + b (read); both consumer warpgroups take part.
constexpr int P_FULL = 1, P_EMPTY = 3, PAIR = 2 * 128;
// Warpgroup 1's own barrier around the dS^T tile it stores.
constexpr int DS_FREE = 5;

template <int HDK, int HDV, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_split_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_ds,
                      const Bwd a) {
  using C = SplitCfg<HDK, HDV>;
  constexpr int R = C::ROWS, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_u = smem_u32(smem_raw);
  const uint32_t base = (raw_u + 1023) & ~1023u;
  const uint32_t k_u = base, v_u = base + C::BK * C::BOX;
  const uint32_t ring = base + C::RES_BYTES;
  const uint32_t dsb_u = ring + STAGES * C::STAGE;
  const uint32_t exch_u = dsb_u + 2 * C::DS_BOX;
  const uint32_t stats_u = exch_u + 2 * C::EXCH;
  const uint32_t bar = stats_u + STAGES * C::STAT_BYTES;
  const uint32_t full0 = bar + 8, empty0 = full0 + 8 * STAGES;
  float* exch = reinterpret_cast<float*>(smem_raw + (exch_u - raw_u));
  const float* stats =
      reinterpret_cast<const float*>(smem_raw + (stats_u - raw_u));
  // Head-major, the heaviest (first, causal) key tiles of a head first:
  // the blocks in flight share their head's q/do stream in L2.
  const int n_t = (a.S + R - 1) / R;
  const int kt = static_cast<int>(blockIdx.x % n_t);
  const int hb = static_cast<int>(blockIdx.x / n_t);
  const int hkv = hb % a.Hkv, b = hb / a.Hkv;
  const int k0 = kt * R;
  const int qt0 = CAUSAL ? kt : 0;
  const int iters = a.G * (n_t - qt0);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONSUMERS * 4);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer: one thread loads K, V once and keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(bar, C::RES_BYTES);
#pragma unroll
      for (int x = 0; x < C::BK; ++x)
        tma_load_4d(k_u + x * C::BOX, &map_k, bar, x * 64, hkv, k0, b);
#pragma unroll
      for (int x = 0; x < C::BV; ++x)
        tma_load_4d(v_u + x * C::BOX, &map_v, bar, x * 64, hkv, k0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int h = hkv * a.G; h < (hkv + 1) * a.G; ++h) {
        const float* st = a.ws + (static_cast<long long>(b) * a.H + h) * a.S64;
        for (int qt = qt0; qt < n_t; ++qt) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t q_u = ring + stage * C::STAGE;
          const uint32_t s_u = stats_u + stage * C::STAT_BYTES;
          mbar_expect_tx(full, C::STAGE + C::STAT_BYTES);
#pragma unroll
          for (int x = 0; x < C::BK; ++x)
            tma_load_4d(q_u + x * C::BOX, &map_q, full, x * 64, h, qt * R, b);
#pragma unroll
          for (int x = 0; x < C::BV; ++x)
            tma_load_4d(q_u + (C::BK + x) * C::BOX, &map_do, full, x * 64, h,
                        qt * R, b);
          bulk_load(s_u, st + qt * R, R * 4, full);
          bulk_load(s_u + R * 4, st + a.ws_half + qt * R, R * 4, full);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }
  // ---- consumers, both over the block's 64 keys: warpgroup 0 forms
  // S^T = K q^T and P^T and holds dv += P^T do; warpgroup 1 forms dP^T =
  // V do^T and dS^T = P^T (dP^T - D) and holds dk += dS^T q.  Value
  // 4 j + e of a thread's 64 x 64 tile is key key_r + 8 (e / 2), query
  // q0 + 8 j + 2 tq + e % 2, in both.  Each warpgroup issues the next
  // stage's first product right behind this stage's last, so its tensor
  // work queues back to back while it does the elementwise work.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128, lane = tid % 32, tq = lane % 4;
  const int key_r = k0 + 16 * (tid / 32) + lane / 4;
  mbar_wait(bar, 0);
  const long long row0 = static_cast<long long>(b) * a.S * a.Hkv + hkv;
  const auto q_of = [&](int st) { return ring + st * C::STAGE; };
  const auto release = [&](int st) { mbar_arrive(empty0 + 8 * st); };
  const auto do_of = [&](int st) { return q_of(st) + C::BK * C::BOX; };
  if (wg == 0) {
    // K's A fragments stay in registers: S^T reads only q from shared
    // memory.
    uint32_t kf[HDK / 16][4];
#pragma unroll
    for (int kk = 0; kk < HDK / 16; ++kk) ldsm_a(kf[kk], k_u, kk, C::BOX);
    float dv[HDV / 2], s[R / 2];
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) dv[i] = 0.f;
    const auto issue_s = [&](int st) {
#pragma unroll
      for (int i = 0; i < R / 2; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDK / 16; ++kk)
        wgmma_rs_n64_kmajor(s, kf[kk], kdesc(q_of(st), kk, C::BOX));
      wgmma_commit();
    };
    int stage = 0;
    uint32_t phase = 0;
    if (iters > 0) {
      mbar_wait(full0, 0);
      issue_s(0);
    }
    for (int it = 0; it < iters; ++it) {
      const int q0 = (qt0 + it % (n_t - qt0)) * R;
      const float* lse2 = stats + stage * 2 * R;
      wgmma_wait<0>();                   // S^T of this stage, dv of the last
      fence_regs(s);
      fence_regs(dv);
      if (it > 0 && lane == 0)
        release(stage == 0 ? STAGES - 1 : stage - 1);
      // P^T; only the tile on the diagonal masks (q0 >= k0 on every tile
      // a causal block streams).
      const bool diag = CAUSAL && q0 == k0;
#pragma unroll
      for (int i = 0; i < R / 2; ++i) {
        const int qi = 8 * (i / 4) + 2 * tq + (i & 1);
        float v = ex2_approx(fmaf(s[i], a.scale_log2, -lse2[qi]));
        if (diag && key_r + 8 * ((i >> 1) & 1) > q0 + qi) v = 0.f;
        s[i] = v;
      }
      // Hand P^T over (the buffer of two stages ago must have been read).
      const int buf = it & 1;
      if (it >= 2) named_sync(P_EMPTY + buf, PAIR);
      float* ex = exch + buf * (C::EXCH / 4);
#pragma unroll
      for (int i = 0; i < R / 2; ++i) ex[i * 128 + tid] = s[i];
      named_arrive(P_FULL + buf, PAIR);
      uint32_t pa[R / 16][4];
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk)
        wgmma_rs<HDV>(dv, pa[kk], ndesc(do_of(stage), kk, C::BOX));
      wgmma_commit();
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
      if (it + 1 < iters) {
        mbar_wait(full0 + 8 * stage, phase);
        issue_s(stage);
      }
    }
    wgmma_wait<0>();
    fence_regs(dv);
    if (iters > 0 && lane == 0) release(stage == 0 ? STAGES - 1 : stage - 1);
    // The last two buffers' reads complete the P_EMPTY barriers' uses.
    for (int it = iters > 2 ? iters - 2 : 0; it < iters; ++it)
      named_sync(P_EMPTY + (it & 1), PAIR);
    store_acc<HDV>(dv, 1.f, k0, a.S, [&](int r) {
      return a.dv + (row0 + static_cast<long long>(r) * a.Hkv) * HDV;
    });
  } else {
    uint32_t vf[HDV / 16][4];                    // V's A fragments
#pragma unroll
    for (int kk = 0; kk < HDV / 16; ++kk) ldsm_a(vf[kk], v_u, kk, C::BOX);
    float dk[HDK / 2], dp[R / 2];
#pragma unroll
    for (int i = 0; i < HDK / 2; ++i) dk[i] = 0.f;
    const auto issue_dp = [&](int st) {
#pragma unroll
      for (int i = 0; i < R / 2; ++i) dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDV / 16; ++kk)
        wgmma_rs_n64_kmajor(dp, vf[kk], kdesc(do_of(st), kk, C::BOX));
      wgmma_commit();
    };
    int stage = 0;
    uint32_t phase = 0;
    if (iters > 0) {
      mbar_wait(full0, 0);
      issue_dp(0);
    }
    for (int it = 0; it < iters; ++it) {
      const float* dl = stats + stage * 2 * R + R;
      // P^T from warpgroup 0 while dP^T (and the last dk) are in flight.
      const int buf = it & 1;
      named_sync(P_FULL + buf, PAIR);
      const float* ex = exch + buf * (C::EXCH / 4);
      float p[R / 2];
#pragma unroll
      for (int i = 0; i < R / 2; ++i) p[i] = ex[i * 128 + tid];
      named_arrive(P_EMPTY + buf, PAIR);
      wgmma_wait<0>();                   // dP^T of this stage, dk of the last
      fence_regs(dp);
      fence_regs(dk);
      if (it > 0 && lane == 0)
        release(stage == 0 ? STAGES - 1 : stage - 1);
      uint32_t da[R / 16][4];
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk) {
        float ds[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = 8 * kk + e;
          const int qi = 8 * (i / 4) + 2 * tq + (i & 1);
          ds[e] = p[i] * (dp[i] - dl[qi]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = pack_bf16(ds[2 * r], ds[2 * r + 1]);
      }
      // dS^T for the dQ pass: written into a swizzled tile in shared
      // memory (rows = keys, 64 queries of 128 bytes), then stored by TMA
      // by one thread; the tile's previous store must have read it.
      {
        const int it_h = it / (n_t - qt0), h = hkv * a.G + it_h;
        const int qt = qt0 + it % (n_t - qt0);
        const uint32_t tile_u = dsb_u + buf * C::DS_BOX;
        if (tid == 0) bulk_wait_read<1>();
        named_sync(DS_FREE, 128);
        const int kr = key_r - k0;
#pragma unroll
        for (int kk = 0; kk < R / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = kr + 8 * (r & 1);
            const int col = 16 * kk + 8 * (r >> 1) + 2 * tq;   // element
            st_shared_u32(tile_u + row * 128 +
                              ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2,
                          da[kk][r]);
          }
        fence_proxy_async();
        named_sync(DS_FREE, 128);
        if (tid == 0) {
          tma_store_4d(&map_ds, tile_u, 0, 0,
                       static_cast<int>(ds_tile(a, b, h, qt, kt, CAUSAL) * R),
                       0);
          bulk_commit();
        }
      }
      // dk += dS^T q (scaled at the end).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk)
        wgmma_rs<HDK>(dk, da[kk], ndesc(q_of(stage), kk, C::BOX));
      wgmma_commit();
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
      if (it + 1 < iters) {
        mbar_wait(full0 + 8 * stage, phase);
        issue_dp(stage);
      }
    }
    wgmma_wait<0>();
    fence_regs(dk);
    if (iters > 0 && lane == 0) release(stage == 0 ? STAGES - 1 : stage - 1);
    if (tid == 0) bulk_wait<0>();          // the dS^T stores have landed
    store_acc<HDK>(dk, a.scale, k0, a.S, [&](int r) {
      return a.dk + (row0 + static_cast<long long>(r) * a.Hkv) * HDK;
    });
  }
}

// bwd_dq_gemm_kernel's stages: a 64-key tile of K and the two 64 x 64
// dS^T tiles of the block's two query tiles.
template <int HDK>
struct GemmCfg {
  static constexpr int BK = HDK / 64;
  static constexpr int ROWS = 64;
  static constexpr int BOX = ROWS * 128;              // 64 rows x 64 columns
  static constexpr int K_BYTES = BK * BOX;
  static constexpr int STAGE = K_BYTES + CONSUMERS * BOX;
  static constexpr int STAGES = 4;
  static constexpr int BAR_BYTES = 8 * 2 * STAGES;
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE + BAR_BYTES;
  static_assert(SMEM_BYTES <= 232448, "above a block's shared memory");
};

// dq = scale dS K at (192, 128) from the dS^T tiles the dK/dV pass
// stored: a block per 128 queries of a head (head-major, the heaviest,
// last, causal tiles of a head first), warpgroup w owns query tile
// 2 QT + w and adds dS K over the key tiles up to its diagonal in order
// (wgmma m64n192k16 with dS read M-major and K N-major, both through
// their transpose bits).  No exp, no recomputed S or dP.
template <int HDK, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_gemm_kernel(const __grid_constant__ CUtensorMap map_ds,
                   const __grid_constant__ CUtensorMap map_k, const Bwd a) {
  using C = GemmCfg<HDK>;
  constexpr int R = C::ROWS, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + STAGES * C::STAGE;
  const uint32_t empty0 = full0 + 8 * STAGES;
  const int n_t = (a.S + R - 1) / R;               // 64-row tiles
  const int n_big = (a.S + 2 * R - 1) / (2 * R);   // 128-query tiles
  const int big = n_big - 1 - static_cast<int>(blockIdx.x % n_big);
  const int hb = static_cast<int>(blockIdx.x / n_big);
  const int h = hb % a.H, b = hb / a.H, hkv = h / a.G;
  const int n_kt = CAUSAL ? min(2 * big + 2, n_t) : n_t;
  // Warpgroup w's query tile and whether it reads key tile t.
  const auto active = [&](int w, int t) {
    const int qt = 2 * big + w;
    return qt < n_t && (!CAUSAL || t <= qt);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONSUMERS * 4);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_kt; ++t) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = full0 + 8 * stage;
        const uint32_t k_u = base + stage * C::STAGE;
        uint32_t bytes = C::K_BYTES;
        for (int w = 0; w < CONSUMERS; ++w) bytes += active(w, t) ? C::BOX : 0;
        mbar_expect_tx(full, bytes);
#pragma unroll
        for (int x = 0; x < C::BK; ++x)
          tma_load_4d(k_u + x * C::BOX, &map_k, full, x * 64, hkv, t * R, b);
        for (int w = 0; w < CONSUMERS; ++w)
          if (active(w, t))
            tma_load_4d(k_u + C::K_BYTES + w * C::BOX, &map_ds, full, 0, 0,
                        static_cast<int>(
                            ds_tile(a, b, h, 2 * big + w, t, CAUSAL) * R),
                        0);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int lane = threadIdx.x % 32;
  float dq[HDK / 2];
#pragma unroll
  for (int i = 0; i < HDK / 2; ++i) dq[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  // Each tile's products are waited for behind the next tile's, so the
  // stage is released one tile late.
  for (int t = 0; t < n_kt; ++t) {
    mbar_wait(full0 + 8 * stage, phase);
    const uint32_t k_u = base + stage * C::STAGE;
    if (active(wg, t)) {
      const uint32_t ds_u = k_u + C::K_BYTES + wg * C::BOX;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk)
        wgmma_ss_n192_tt(dq, ndesc(ds_u, kk, C::BOX), ndesc(k_u, kk, C::BOX));
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(dq);
    if (t > 0 && lane == 0)
      mbar_arrive(empty0 + 8 * (stage == 0 ? STAGES - 1 : stage - 1));
    if (++stage == STAGES) { stage = 0; phase ^= 1; }
  }
  wgmma_wait<0>();
  fence_regs(dq);
  const int qw0 = (2 * big + wg) * R;
  const long long row0 = static_cast<long long>(b) * a.S * a.H + h;
  store_acc<HDK>(dq, a.scale, qw0, a.S, [&](int r) {
    return a.dq + (row0 + static_cast<long long>(r) * a.H) * HDK;
  });
}

template <int HDK, int HDV, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_do,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v, const Bwd a) {
  using C = Cfg<HDK, HDV>;
  constexpr int KT = C::KT, DQ_STAGES = C::DQ_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const Smem<C> sm(smem_raw);
  const int n_qt = (a.S + ROWS - 1) / ROWS;
  const int per = a.H * a.B;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / per);  // heaviest first
  const int h = static_cast<int>(blockIdx.x % per) % a.H;
  const int b = static_cast<int>(blockIdx.x % per) / a.H;
  const int hkv = h / a.G;
  const int q0 = qt * ROWS;
  const int n_kt = CAUSAL ? (q0 + ROWS) / KT : (a.S + KT - 1) / KT;
  const uint32_t q_u = sm.res, do_u = sm.res + C::BK * RES_BOX;
  sm.init(DQ_STAGES);

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer: one thread loads q, do once and keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(sm.bar, C::RES_BYTES);
#pragma unroll
      for (int x = 0; x < C::BK; ++x)
        tma_load_4d(q_u + x * RES_BOX, &map_q, sm.bar, x * 64, h, q0, b);
#pragma unroll
      for (int x = 0; x < C::BV; ++x)
        tma_load_4d(do_u + x * RES_BOX, &map_do, sm.bar, x * 64, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_kt; ++t) {
        mbar_wait(sm.empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = sm.full0 + 8 * stage;
        const uint32_t k_u = sm.ring + stage * C::KT_STAGE;
        mbar_expect_tx(full, C::KT_STAGE);
#pragma unroll
        for (int x = 0; x < C::BK; ++x)
          tma_load_4d(k_u + x * C::KT_BOX, &map_k, full, x * 64, hkv, t * KT,
                      b);
#pragma unroll
        for (int x = 0; x < C::BV; ++x)
          tma_load_4d(k_u + (C::BK + x) * C::KT_BOX, &map_v, full, x * 64,
                      hkv, t * KT, b);
        if (++stage == DQ_STAGES) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // ---- consumers: 64 queries each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x % 32, tq = lane % 4;
    const int qw0 = q0 + 64 * wg;                      // first query here
    const int row_r = qw0 + 16 * (threadIdx.x / 32 % 4) + lane / 4;
    // This thread's rows row_r and row_r + 8: lse2 and D.
    float lse2[2], dl[2];
    const long long st = (static_cast<long long>(b) * a.H + h) * a.S64;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row_r + 8 * i;
      lse2[i] = r < a.S ? a.ws[st + r] : INFINITY;
      dl[i] = r < a.S ? a.ws[a.ws_half + st + r] : 0.f;
    }
    const uint32_t qa = q_u + wg * 64 * 128, doa = do_u + wg * 64 * 128;
    float dq[HDK / 2];
#pragma unroll
    for (int i = 0; i < HDK / 2; ++i) dq[i] = 0.f;
    mbar_wait(sm.bar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_kt; ++t) {
      const int k0 = t * KT;
      mbar_wait(sm.full0 + 8 * stage, phase);
      const uint32_t k_u = sm.ring + stage * C::KT_STAGE;
      const uint32_t v_u = k_u + C::BK * C::KT_BOX;
      // S = q K^T, dP = do V^T: 64 queries x KT keys; value 4 j + e at
      // query row_r + 8 (e / 2), key k0 + 8 j + 2 tq + e % 2.
      float s[KT / 2], dp[KT / 2];
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDK / 16; ++kk)
        wgmma_ss<KT>(s, kdesc(qa, kk, RES_BOX), kdesc(k_u, kk, C::KT_BOX));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HDV / 16; ++kk)
        wgmma_ss<KT>(dp, kdesc(doa, kk, RES_BOX), kdesc(v_u, kk, C::KT_BOX));
      wgmma_commit();
      // P (in place of S) while dP is in flight; masks on the diagonal
      // tile (a tile wholly above it gives P = 0) and on keys past S.
      wgmma_wait<1>();
      fence_regs(s);
      const bool mask = (CAUSAL && k0 + KT - 1 > qw0) || k0 + KT > a.S;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = (e >> 1) & 1;
          const int key = k0 + 16 * kk + 8 * (e / 4) + 2 * tq + (e & 1);
          float v = exp2f(fmaf(s[8 * kk + e], a.scale_log2, -lse2[i]));
          if (mask && (key >= a.S || (CAUSAL && key > row_r + 8 * i)))
            v = 0.f;
          s[8 * kk + e] = v;
        }
      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t da[KT / 16][4];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        float ds[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          ds[e] = s[8 * kk + e] * (dp[8 * kk + e] - dl[(e >> 1) & 1]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = pack_bf16(ds[2 * r], ds[2 * r + 1]);
      }
      // dq += dS K (scaled at the end).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_rs<HDK>(dq, da[kk], ndesc(k_u, kk, C::KT_BOX));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      if (lane == 0) mbar_arrive(sm.empty0 + 8 * stage);
      if (++stage == DQ_STAGES) { stage = 0; phase ^= 1; }
    }
    const long long row0 = static_cast<long long>(b) * a.S * a.H + h;
    store_acc<HDK>(dq, a.scale, qw0, a.S, [&](int r) {
      return a.dq + (row0 + static_cast<long long>(r) * a.H) * a.hdk;
    }, a.hdk);
  }
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long blocks, int smem, cudaStream_t s,
           const Args&... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The tensor maps and the two main kernels of the tiles (HDK, HDV).  The
// maps have the operands' own head dims (a.hdk, a.hdv): at (80, 80) a row
// is two 64-column boxes of the (128, 128) tiles, zero-filled past column
// 80 by TMA, and the outputs' rows are 80 long.
template <int HDK, int HDV>
int run(const void* q, const void* k, const void* v, const long long (&ks)[3],
        const long long (&vs)[3], const Bwd& a, bool causal, int parts,
        cudaStream_t s) {
  const int B = a.B, S = a.S, H = a.H, Hkv = a.Hkv;
  const int hk = a.hdk, hv = a.hdv;
  const long long sq = static_cast<long long>(H) * hk;
  const long long sdo = static_cast<long long>(H) * hv;
  if constexpr (HDK == 192) {
    // dK/dV: 64-row boxes of q, do (streamed) and K, V (resident); dQ: K
    // again and the dS^T tiles, rows of 64 queries.
    using SC = SplitCfg<HDK, HDV>;
    constexpr int R = SC::ROWS;
    const long long ds_rows = static_cast<long long>(B) * H * a.n_tri * R;
    CUtensorMap m[4], m_ds;
    int err = make_map_4d(&m[0], q, HDK, H, S, B, HDK, sq, S * sq, 1, R);
    if (!err)
      err = make_map_4d(&m[1], a.dout, HDV, H, S, B, HDV, sdo, S * sdo, 1, R);
    if (!err)
      err = make_map_4d(&m[2], k, HDK, Hkv, S, B, ks[0], ks[1], ks[2], 1, R);
    if (!err)
      err = make_map_4d(&m[3], v, HDV, Hkv, S, B, vs[0], vs[1], vs[2], 1, R);
    if (!err)
      err = make_map_4d(&m_ds, a.ds, R, 1, static_cast<int>(ds_rows), 1, R,
                        R, ds_rows * R, 1, R);
    if (err) return err;
    const long long n_t = (S + R - 1) / R;
    if (parts & 2)
      err = launch(causal ? bwd_dkdv_split_kernel<HDK, HDV, true>
                          : bwd_dkdv_split_kernel<HDK, HDV, false>,
                   n_t * Hkv * B, SC::SMEM_BYTES, s, m[0], m[1], m[2], m[3],
                   m_ds, a);
    if (err || !(parts & 4)) return err;
    return launch(causal ? bwd_dq_gemm_kernel<HDK, true>
                         : bwd_dq_gemm_kernel<HDK, false>,
                  (n_t + 1) / 2 * H * B, GemmCfg<HDK>::SMEM_BYTES, s, m_ds,
                  m[2], a);
  } else {
    using C = Cfg<HDK, HDV>;
    // dkdv streams STREAM queries and holds ROWS keys; dq holds ROWS
    // queries and streams KT keys.
    CUtensorMap m_dkdv[4], m_dq[4];
    int err = make_map_4d(&m_dkdv[0], q, hk, H, S, B, hk, sq, S * sq, 1,
                          C::STREAM);
    if (!err)
      err = make_map_4d(&m_dkdv[1], a.dout, hv, H, S, B, hv, sdo, S * sdo,
                        1, C::STREAM);
    if (!err)
      err = make_map_4d(&m_dkdv[2], k, hk, Hkv, S, B, ks[0], ks[1], ks[2], 1,
                        ROWS);
    if (!err)
      err = make_map_4d(&m_dkdv[3], v, hv, Hkv, S, B, vs[0], vs[1], vs[2], 1,
                        ROWS);
    if (!err)
      err = make_map_4d(&m_dq[0], q, hk, H, S, B, hk, sq, S * sq, 1, ROWS);
    if (!err)
      err = make_map_4d(&m_dq[1], a.dout, hv, H, S, B, hv, sdo, S * sdo, 1,
                        ROWS);
    if (!err)
      err = make_map_4d(&m_dq[2], k, hk, Hkv, S, B, ks[0], ks[1], ks[2], 1,
                        C::KT);
    if (!err)
      err = make_map_4d(&m_dq[3], v, hv, Hkv, S, B, vs[0], vs[1], vs[2], 1,
                        C::KT);
    if (err) return err;
    const long long tiles = (S + ROWS - 1) / ROWS;
    if (parts & 2)
      err = launch(causal ? bwd_dkdv_kernel<HDK, HDV, true>
                          : bwd_dkdv_kernel<HDK, HDV, false>,
                   tiles * Hkv * B, C::SMEM_BYTES, s, m_dkdv[0], m_dkdv[1],
                   m_dkdv[2], m_dkdv[3], a);
    if (err || !(parts & 4)) return err;
    return launch(causal ? bwd_dq_kernel<HDK, HDV, true>
                         : bwd_dq_kernel<HDK, HDV, false>,
                  tiles * H * B, C::SMEM_BYTES, s, m_dq[0], m_dq[1], m_dq[2],
                  m_dq[3], a);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  q, dq: (B, S, H, hdk); o, do:
// (B, S, H, hdv); k, dk: (B, S, Hkv, hdk); v, dv: (B, S, Hkv, hdv); all
// bf16 and contiguous; (hdk, hdv) is (64, 64), (80, 80), (128, 128) or
// (192, 128).
// lse:
// (B, H, S) fp32 from the forward; ws: an fp32 workspace of 2 B H S64
// floats, S64 = S rounded up to 64 (16-byte aligned); ds, at (192, 128)
// only (else null): a bf16 workspace of B H n_tri 64 x 64 tiles, n_tri =
// n (n + 1) / 2 causal, n^2 not, n = S64 / 64.  Launches the
// kernels that `parts` names (1: prep, 2: dK/dV, 4: dQ; 7 all three, the
// backward; the others time a kernel alone, on a workspace an earlier
// prep filled) on `stream`, does not synchronise, and returns the first
// failure's code (0 = launched; 1000 and up: a tensor map could not be
// made).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* ws, void* dq, void* dk,
    void* dv, void* ds, int B, int S, int H, int Hkv, int hdk, int hdv,
    int causal, float scale, int parts, long long skh, long long sks,
    long long skb, long long svh, long long svs, long long svb,
    void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv || B > 65535 ||
      !((hdk == 64 && hdv == 64) || (hdk == 80 && hdv == 80) ||
        (hdk == 128 && hdv == 128) || (hdk == 192 && hdv == 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  Bwd a;
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.ws = static_cast<float*>(ws);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.ds = static_cast<bf16*>(ds);
  a.B = B;
  a.S = S;
  a.S64 = (S + PAD - 1) / PAD * PAD;
  const int n_t = a.S64 / PAD;
  a.n_tri = causal ? n_t * (n_t + 1) / 2 : n_t * n_t;
  if (hdk == 192 && (ds == nullptr ||
                     static_cast<long long>(B) * H * a.n_tri * 64 >
                         0x7FFFFFFFLL))
    return static_cast<int>(cudaErrorInvalidValue);
  a.H = H;
  a.Hkv = Hkv;
  a.G = H / Hkv;
  a.hdk = hdk;
  a.hdv = hdv;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  a.ws_half = static_cast<long long>(B) * H * a.S64;
  // The prep kernel first: the runtime's launch makes the device's primary
  // context current on this thread (autograd runs a backward on a thread
  // of its own), which the tensor-map encoder needs.
  // A prep-less call (parts without 1) makes the context current with a
  // runtime call of its own.
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned prep_blocks = static_cast<unsigned>((a.ws_half + 7) / 8);
  if ((parts & 1) && hdv == 80)
    bwd_prep_kernel<80><<<prep_blocks, 256, 0, s>>>(a);
  else if ((parts & 1) && hdv == 64)
    bwd_prep_kernel<64><<<prep_blocks, 256, 0, s>>>(a);
  else if (parts & 1)
    bwd_prep_kernel<128><<<prep_blocks, 256, 0, s>>>(a);
  else
    cudaFree(nullptr);
  const int err = static_cast<int>(cudaGetLastError());
  if (err || !(parts & 6)) return err;
  const long long ks[3] = {skh, sks, skb}, vs[3] = {svh, svs, svb};
  if (hdk == 192) return run<192, 128>(q, k, v, ks, vs, a, causal != 0, parts, s);
  if (hdk == 64) return run<64, 64>(q, k, v, ks, vs, a, causal != 0, parts, s);
  return run<128, 128>(q, k, v, ks, vs, a, causal != 0, parts, s);
}
