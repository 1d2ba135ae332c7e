// The grouped FFN's backward in fp32 for Hopper (sm_90a): B1-B3 of
// grouped_gemm.cu (bf16, TMA + wgmma) for fp32 operands, the trainer's
// default dtype.
//
// No pallas_call: XLA differentiates the einsums around
// repro/kernels/grouped_gemm/kernel.py:154 (grouped_swiglu_pallas) and
// :184 (grouped_matmul_pallas), repro/moe/expert.py:102-105, at any dtype.
// Per expert slot g, with rows [0, min(rows[g], M)) valid (rows read on
// the device):
//   mode 0, dgrad (B2f): out = x w^T (+ x2 w2^T), x (G, M, K), w (G, N, K)
//     K-contiguous (the slot buffers as kept: dact = dy w2^T, dx = dh w1^T
//     + dg w3^T);
//   mode 1, SwiGLU backward (B1f): h = x w1, g = x w3 recomputed, then
//     dh = dact g s (1 + h (1 - s)), dg = dact h s with s = sigmoid(h);
//     x (G, M, K), w1 / w3 (G, K, N), dact (G, M, N);
//   mode 2, wgrad (B3f): out = x[:rows]^T d[:rows], (G, K, N), the sum over
//     each slot's valid rows only.
// Rows past a slot's count are never read (their loads are zero-filled,
// so NaN there reaches no product) and come out of modes 0 and 1 as exact
// zeros up to the count rounded up to 128; past that, zeros when
// zero_padded (the public call) or unwritten (the autograd backward, whose
// readers select the valid rows).
//
// What bounds them on an H100: at GLM-4.5-Air's full width (K 4096, N
// 1408; 8192 tokens at top-8, 65,536 routed rows) the products, 3 x 2 x
// 65536 x 4096 x 1408 flops a product in 3xTF32, 4.6 ms each at the data
// sheet's 495 TFLOP/s TF32; at the reduced configurations' widths (D 64,
// F 32) latency: the kernels take 8-22 us of device time (CUDA-graph
// replays, PERF.md) for under a microsecond of products, and a call's host
// work takes longer again.
//
// Arithmetic: 3xTF32 (tf32_planes.cuh): a b = a_lo b_hi + a_hi b_lo +
// a_hi b_hi, each product about 2^-20 of its size.  The tensor core
// truncates as it accumulates, so each 128-deep chunk of the contraction
// (4 stages of 32) is summed in fresh registers, the small terms
// (a_lo b_hi + a_hi b_lo) apart from the large ones, and both are added
// to the fp32 accumulator.  Every sum in a fixed order, no atomics: the
// same bits on every run.
//
// Design: products on TF32 wgmma (m64n128k8: A from registers, B's hi and
// lo planes from shared memory; the SwiGLU's h and g side by side in
// one), warp specialised and persistent.
//   * One block an SM, 384 threads: warpgroups 0 and 1 run the products
//     of a 128-row tile, 64 rows each (accumulator, big and small sums:
//     192 registers a thread, setmaxnreg 232); warpgroup 2 (40 registers)
//     loads and splits.  Each block builds the schedule from `rows` in
//     shared memory (a scan over the slots) and takes items b, b + grid,
//     ...: modes 0 and 1 only the 128-row tiles that hold rows (slot-major,
//     the column tile, then the row tile fastest: the blocks running
//     together share a weight panel); mode 2 every (slot, 128-row tile of
//     K, 128-column tile of N), and where those are fewer than the SMs
//     (the reduced widths) each slot's valid rows in `chunk`-row pieces
//     whose partial sums land in a workspace and are added in chunk order
//     by a second kernel (deterministic, no atomics).
//   * A stage is 32 contraction values.  The loading warpgroup lands the
//     stage's A (x's tile, fp32) into one of three operand sets and its B
//     into one of three landing tiles (Feed: rows of 256 and 512 bytes by
//     one bulk copy each, rows of 128 bytes by 16-byte cp.async pieces),
//     then splits B into hi and lo K-major planes with the 128-byte swizzle
//     beside A in the set: mode 0's w rows as they are, mode 1's w1 / w3
//     (K x N, N-contiguous) and mode 2's d transposed, since TF32 wgmma has
//     no transpose bit.  Rows past a count or an edge are zero-filled or
//     zeroed, never read, so NaN there reaches no product.  mbarriers:
//     landed (the loads' arrivals and bytes), full (split), empty (the
//     products done with a set).
//   * The products read each k8 step's A fragment from x's landed rows
//     (ldmatrix; mode 2's from x's rows, which hold the contraction) and
//     split it in registers: A never goes through planes, whose writes and
//     wgmma reads were a third of the stage's shared-memory traffic.  A
//     k8 step's three products are a commit group and the step before is
//     waited for, so two steps queue on the tensor cores.  After an item's
//     last stage its epilogue (mode 1: the SwiGLU's gradient from dact,
//     read here) stores it from registers.
//
// Not yet: the SwiGLU backward takes 1.3x the dgrad's time a stage at
// GLM-4.5-Air's full width, not for its transposed B (w1 and w3 read into
// registers and x split instead measured the same: PERF.md); TMA stores;
// the public call's zero pass reads the slots' counts one after another
// (9 us of device time at the reduced widths; reading them into shared
// memory in parallel first measured 12-21% slower at full width, the
// products' code no longer the same: PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grouped_common.cuh"
#include "hopper_tma.cuh"
#include "tf32_planes.cuh"
#include "warp_mma.cuh"

namespace {

constexpr int CONSUMERS = 256;   // two warpgroups of products
constexpr int THREADS = CONSUMERS + 128;   // and one that loads and splits
constexpr int BM = 128;          // output rows a tile, 64 a warpgroup
constexpr int KT = 32;           // contraction a stage: one plane row
constexpr int PLANE = BM * KT;   // floats of a 128-row plane (16 KB)
constexpr int MAX_G = 512;       // slots the schedule holds
constexpr int NS = 3;            // operand sets in the ring
constexpr int NL = 3;            // landed B tiles in flight
constexpr int CHUNK = 4;         // stages summed in one set of registers

// Shared memory, in floats: NS operand sets, each the B operand's hi and
// lo planes (128 rows x 32, K-major with the 128-byte swizzle: 32 KB) and
// the A operand in fp32 as it landed (modes 0 and 1: x's 128 rows x 32;
// mode 2: x's 32 rows x 128 columns of K); then NL landing tiles of B
// (mode 0: w's 128 rows x 32; mode 1: w1's and w3's 32 rows x 64 columns;
// mode 2: d's 32 rows x 128 columns); the mbarriers; the schedule's prefix
// sums.  Landed rows are padded by 4 floats, so the fragment and split
// reads of 8 or 32 rows hit distinct banks.  Planes on 1024 bytes: the dynamic shared memory starts on 1024,
// as the TMA kernels' swizzled tiles of grouped_gemm.cu take it.
template <int MODE>
struct Lay {
  static constexpr int BNO = MODE == 1 ? 64 : 128;   // columns a product
  static constexpr int B_HI = 0, B_LO = PLANE, A = 2 * PLANE;
  static constexpr int LD_A = MODE == 2 ? BM + 4 : KT + 4;
  static constexpr int A_ROWS = MODE == 2 ? KT : BM;
  static constexpr int SET = (A + A_ROWS * LD_A + 255) / 256 * 256;
  static constexpr int LD_B = MODE == 0 ? KT + 4 : BNO + 4;
  static constexpr int B_ROWS = MODE == 0 ? BM : MODE == 1 ? 2 * KT : KT;
  static constexpr int LAND = (B_ROWS * LD_B + 63) / 64 * 64;
  static constexpr int LAND0 = NS * SET, BARS = LAND0 + NL * LAND;
  static constexpr int PRE = BARS + 2 * (2 * NS + NL);   // the mbarriers
  static constexpr int BYTES = PRE * 4 + (MAX_G + 1) * 4;
  static_assert(BYTES <= 232448, "above a block's shared memory");
};

struct Args {
  const float *a, *a2, *b, *b2, *dact;
  float *out, *out2, *ws;
  const long long* rows;            // null: M for every slot
  int G, M, K, N;
  long long sag, sar, sbg, sbr;     // a (and a2), b (and b2): slot, row
  int second;                       // mode 0: add a2 b2^T
  int zero_padded;                  // modes 0, 1: zero rows past the tiles
  int chunk;                        // mode 2: rows a partial sum, 0 whole
  int nch;                          // mode 2: ceil(M / chunk)
};

// Where the block stands in its stream of stages: the item, its slot,
// the stage and the item's stage count (valid while item < total).  The
// item's coordinates are recomputed from the schedule where needed
// (Sched::where), so three cursors cost a dozen registers beside the
// 192 of the accumulators.
struct Cursor {
  int item, g, stage, ns;
};

// An item's coordinates.
struct Item {
  int cnt;    // the slot's valid rows
  int r0;     // modes 0, 1: first output row; mode 2: first contracted row
  int c0;     // first output column
  int k0;     // mode 2: first output row (of K)
  int m_end;  // mode 2: end of the contracted rows
  int chunk;  // mode 2: the chunk's index
};

template <int MODE>
struct Sched {
  const int* pre;     // items before slot g, G + 1 entries
  int total, nk, kt_n, nt_n;

  __device__ int items_of(int cnt, int chunk) const {
    if constexpr (MODE == 2) {
      const int ch = chunk ? (cnt + chunk - 1) / chunk : 1;
      return ch * kt_n * nt_n;
    } else {
      return (cnt + BM - 1) / BM * nt_n;
    }
  }

  __device__ Item where(const Cursor& c, const Args& p) const {
    const int local = c.item - pre[c.g];
    Item it;
    it.cnt = valid_rows(p.rows, c.g, p.M);
    if constexpr (MODE == 2) {
      const int per = kt_n * nt_n, rem = local % per;
      it.chunk = local / per;
      it.k0 = rem / nt_n * BM;
      it.c0 = rem % nt_n * Lay<MODE>::BNO;
      it.r0 = p.chunk ? it.chunk * p.chunk : 0;
      it.m_end = p.chunk ? min(it.r0 + p.chunk, it.cnt) : it.cnt;
    } else {
      const int mt = (it.cnt + BM - 1) / BM;
      it.r0 = local % mt * BM;
      it.c0 = local / mt * Lay<MODE>::BNO;
      it.k0 = it.m_end = it.chunk = 0;
    }
    return it;
  }

  // Cursor at stage 0 of `item` (< total): the last slot g with
  // pre[g] <= item, and the item's stage count.
  __device__ void decode(Cursor& c, const Args& p) const {
    int lo = 0, hi = p.G;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (pre[mid] <= c.item) lo = mid; else hi = mid;
    }
    c.g = lo;
    c.stage = 0;
    if constexpr (MODE == 2) {
      const Item it = where(c, p);
      c.ns = max(1, (it.m_end - it.r0 + KT - 1) / KT);
    } else {
      c.ns = MODE == 0 && p.second ? 2 * nk : nk;
    }
  }

  __device__ Cursor start(int item, const Args& p) const {
    Cursor c{item, 0, 0, 0};
    if (item < total) decode(c, p);
    return c;
  }

  __device__ void advance(Cursor& c, const Args& p) const {
    if (c.item >= total || ++c.stage < c.ns) return;
    c.item += gridDim.x;
    if (c.item < total) decode(c, p);
  }
};

// How each operand lands: rows of 512 or 256 bytes (mode 2's x and d
// rows of 128 columns, mode 1's w1 and w3 rows of 64) by one bulk copy a
// row; rows of 128 bytes (32 contraction values: modes 0 and 1's x, mode
// 0's w) by 16-byte cp.async pieces, since bulk copies of 128 bytes, two
// hundred a stage, kept the copy engine from feeding the products.
template <int MODE>
struct Feed {
  static constexpr bool A_BULK = MODE == 2, B_BULK = MODE != 0;
};

// Transaction bytes on an mbarrier without an arrival, and the arrival of
// the executing thread once its cp.async pieces have landed.
__device__ __forceinline__ void mbar_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(bar) : "memory");
}

// The stage's loads by the loading warpgroup: A into its operand set, B
// into a landing tile, all completing on the landing tile's mbarrier
// (each loading thread arrives once its pieces have landed; the bulk
// copies add their bytes).  What lies past a count or an edge is
// zero-filled (cp.async) or zeroed (past a bulk row's bytes), never read.
template <int MODE>
__device__ __forceinline__ void load_stage(float* set, float* land,
                                           uint32_t bar, const Cursor& c,
                                           const Item& it, const Args& p,
                                           int nk, int tid) {
  using L = Lay<MODE>;
  using F = Feed<MODE>;
  constexpr int NT = 128;
  float* a_s = set + L::A;
  // Bulk rows: mode 2, threads 0-31 x's rows, 32-63 d's (columns k0 /
  // c0 .. + 127 of row m); mode 1, threads 0-63 w1's, then w3's rows
  // (columns c0 .. c0 + 63 of row k).
  const float* src = nullptr;
  float* dst = nullptr;
  int bytes = 0, floats = 0;
  if constexpr (MODE == 2) {
    const int j = tid % KT, m = it.r0 + c.stage * KT + j;
    const bool ok = m < it.m_end;
    if (tid < KT) {
      src = p.a + c.g * p.sag + static_cast<long long>(m) * p.sar + it.k0;
      dst = a_s + j * L::LD_A;
      bytes = ok ? 4 * min(BM, p.K - it.k0) : 0;
      floats = BM;
    } else if (tid < 2 * KT) {
      src = p.b + c.g * p.sbg + static_cast<long long>(m) * p.sbr + it.c0;
      dst = land + j * L::LD_B;
      bytes = ok ? 4 * min(BM, p.N - it.c0) : 0;
      floats = BM;
    }
  }
  const bool half = MODE == 0 && c.stage >= nk;
  const int k0 = (half ? c.stage - nk : c.stage) * KT;
  if constexpr (MODE == 1 && F::B_BULK) {
    if (tid < 2 * KT) {
      const int k = k0 + tid % KT;
      src = (tid < KT ? p.b : p.b2) + c.g * p.sbg +
            static_cast<long long>(k) * p.sbr + it.c0;
      dst = land + tid * L::LD_B;
      bytes = k < p.K ? 4 * min(L::BNO, p.N - it.c0) : 0;
      floats = L::BNO;
    }
  }
  if (dst != nullptr) {
    for (int q = bytes / 4; q < floats; q += 4)
      *reinterpret_cast<float4*>(dst + q) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (bytes > 0) {
    mbar_tx(bar, static_cast<uint32_t>(bytes));
    bulk_load(smem_u32(dst), src, static_cast<uint32_t>(bytes), bar);
  }
  // 16-byte pieces: x's rows (modes 0, 1), w's rows (mode 0), w1's and
  // w3's (mode 1 without bulk rows).
  if constexpr (!F::A_BULK) {
    const float* ag = (half ? p.a2 : p.a) + c.g * p.sag;
    for (int i = tid; i < BM * 8; i += NT) {
      const int r = i >> 3, q = i & 7, m = it.r0 + r, k = k0 + 4 * q;
      const bool ok = m < it.cnt && k < p.K;
      cp_async16(a_s + r * L::LD_A + 4 * q,
                 ok ? ag + static_cast<long long>(m) * p.sar + k : p.a,
                 ok ? 16 : 0);
    }
  }
  if constexpr (MODE == 0) {
    const float* bg = (half ? p.b2 : p.b) + c.g * p.sbg;
    for (int i = tid; i < BM * 8; i += NT) {
      const int r = i >> 3, q = i & 7, n = it.c0 + r, k = k0 + 4 * q;
      const bool ok = n < p.N && k < p.K;
      cp_async16(land + r * L::LD_B + 4 * q,
                 ok ? bg + static_cast<long long>(n) * p.sbr + k : p.b,
                 ok ? 16 : 0);
    }
  } else if constexpr (MODE == 1 && !F::B_BULK) {
    for (int i = tid; i < 2 * KT * 16; i += NT) {
      const int row = i / 16, q = i % 16 * 4, k = k0 + row % KT;
      const int n = it.c0 + q;
      const bool ok = k < p.K && n < p.N;
      const float* bg = (row < KT ? p.b : p.b2) + c.g * p.sbg;
      cp_async16(land + row * L::LD_B + q,
                 ok ? bg + static_cast<long long>(k) * p.sbr + n : p.b,
                 ok ? 16 : 0);
    }
  }
  cp_async_arrive(bar);
}

// A landed B tile split into its operand set's hi and lo planes.
template <int MODE>
__device__ __forceinline__ void split_b(const float* land, float* set,
                                        int tid) {
  using L = Lay<MODE>;
  constexpr int NT = 128;           // the loading warpgroup
  if constexpr (MODE == 0) {
    split_rows<BM>(land, L::LD_B, set + L::B_HI, set + L::B_LO, tid, NT);
  } else if constexpr (MODE == 1) {
    for (int prod = 0; prod < 2; ++prod)
      split_transposed<64>(land + prod * KT * L::LD_B, L::LD_B,
                           set + L::B_HI + prod * 64 * KT,
                           set + L::B_LO + prod * 64 * KT, tid, NT);
  } else {
    split_transposed<BM>(land, L::LD_B, set + L::B_HI, set + L::B_LO, tid,
                         NT);
  }
}

// Warpgroup wg's A fragment of k8 step kk (its 64 rows), split: value e
// at row 16 (warp % 4) + lane / 4 + 8 (e % 2), column 8 kk + lane % 4 +
// 4 (e / 2).  Modes 0 and 1 by one ldmatrix on x's landed rows (each 8 x 4
// block of fp32 is an 8 x 8 block of b16), mode 2 from x's rows, which
// hold the contraction.
template <int MODE>
__device__ __forceinline__ void a_fragment(const float* a_s, int wg, int kk,
                                           unsigned (&hi)[4],
                                           unsigned (&lo)[4]) {
  using L = Lay<MODE>;
  const int lane = threadIdx.x & 31;
  const int r0 = wg * 64 + ((threadIdx.x >> 5) & 3) * 16;
  unsigned r[4];
  if constexpr (MODE == 2) {
    const float* p = a_s + (8 * kk + (lane & 3)) * L::LD_A + r0 + lane / 4;
    r[0] = __float_as_uint(p[0]);
    r[1] = __float_as_uint(p[8]);
    r[2] = __float_as_uint(p[4 * L::LD_A]);
    r[3] = __float_as_uint(p[4 * L::LD_A + 8]);
  } else {
    const int i = lane >> 3, row = r0 + (lane & 7) + 8 * (i & 1);
    ldsm_x4(r, smem_u32(a_s + row * L::LD_A + 8 * kk + 4 * (i >> 1)));
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]), hi[e], lo[e]);
}

__device__ __forceinline__ uint64_t dsc(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// The stage's products for warpgroup wg's 64 rows: big += a_hi b_hi and
// small += a_lo b_hi + a_hi b_lo over its 4 k8 steps, both fresh unless
// `more`; A from registers (split as it is read), B's planes in shared
// memory (mode 1's 128 B rows are w1's 64 columns, then w3's: h and g in
// one product).  A k8 step's three products are a commit group, and the
// step before it is waited for (its A registers are then free), so two
// steps' products queue on the tensor cores.
template <int MODE>
__device__ __forceinline__ void stage_products(const float* set, int wg,
                                               float (&big)[64],
                                               float (&small)[64],
                                               int more) {
  using L = Lay<MODE>;
  const uint32_t bh = smem_u32(set + L::B_HI), bl = smem_u32(set + L::B_LO);
  unsigned ah[2][4], al[2][4];
#pragma unroll
  for (int kk = 0; kk < KT / 8; ++kk) {
    a_fragment<MODE>(set + L::A, wg, kk, ah[kk & 1], al[kk & 1]);
    const uint32_t o = kk * 32;
    wgmma_fence();
    wgmma_tf32_rs_n128(small, al[kk & 1], dsc(bh + o), kk | more);
    wgmma_tf32_rs_n128(small, ah[kk & 1], dsc(bl + o), 1);
    wgmma_tf32_rs_n128(big, ah[kk & 1], dsc(bh + o), kk | more);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
}

// An item's accumulator to memory.  Value 4 j + e of a thread is row
// 16 (warp % 4) + lane / 4 + 8 (e / 2) of its warpgroup's 64, column
// 8 j + 2 (lane % 4) + e % 2 (mode 1: h in values 0-31, g in 32-63, each
// over the item's 64 columns).
template <int MODE>
__device__ __forceinline__ void epilogue(const float (&acc)[64],
                                         const Cursor& c, const Item& it,
                                         const Args& p) {
  const int lane = threadIdx.x & 31;
  const int row = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 +
                  lane / 4;
  const int col = 2 * (lane & 3);
  if constexpr (MODE == 2) {
    float* base =
        p.chunk ? p.ws + (static_cast<long long>(c.g) * p.nch + it.chunk) *
                             p.K * p.N
                : p.out + static_cast<long long>(c.g) * p.K * p.N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = it.k0 + row + 8 * i;
      if (k >= p.K) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = it.c0 + 8 * j + col;
        if (n < p.N)
          *reinterpret_cast<float2*>(base + static_cast<long long>(k) * p.N +
                                     n) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
  } else {
    constexpr int NJ = Lay<MODE>::BNO / 8;
    const long long slot = static_cast<long long>(c.g) * p.M * p.N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = it.r0 + row + 8 * i;
      if (m >= p.M) continue;
      const bool valid = m < it.cnt;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = it.c0 + 8 * j + col;
        if (n >= p.N) continue;
        const long long at = slot + static_cast<long long>(m) * p.N + n;
        if constexpr (MODE == 0) {
          *reinterpret_cast<float2*>(p.out + at) =
              valid ? make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1])
                    : make_float2(0.f, 0.f);
        } else {
          float2 dh = make_float2(0.f, 0.f), dg = dh;
          if (valid) {
            const float2 da = *reinterpret_cast<const float2*>(p.dact + at);
            const float d[2] = {da.x, da.y};
            float rh[2], rg[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float h = acc[4 * j + 2 * i + e];
              const float gv = acc[32 + 4 * j + 2 * i + e];
              const float s = 1.f / (1.f + expf(-h));
              rg[e] = d[e] * h * s;
              rh[e] = d[e] * gv * s * (1.f + h * (1.f - s));
            }
            dh = make_float2(rh[0], rh[1]);
            dg = make_float2(rg[0], rg[1]);
          }
          *reinterpret_cast<float2*>(p.out + at) = dh;
          *reinterpret_cast<float2*>(p.out2 + at) = dg;
        }
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
grouped_bwd_f32_kernel(const Args p) {
  using L = Lay<MODE>;
  extern __shared__ __align__(1024) float smem[];
  // full[NS], empty[NS], landed[NL]
  const uint32_t bars = smem_u32(smem + L::BARS);
  int* pre = reinterpret_cast<int*>(smem + L::PRE);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;

  // The public call: rows from the count rounded up to 128 on, as zeros
  // (no item writes them).
  if (MODE != 2 && p.zero_padded) {
    const int n4 = p.N / 4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g = 0; g < p.G; ++g) {
      const int r0 =
          min(p.M, (valid_rows(p.rows, g, p.M) + BM - 1) / BM * BM);
      const long long n = static_cast<long long>(p.M - r0) * n4;
      const long long base = (static_cast<long long>(g) * p.M + r0) * p.N;
      for (long long i = static_cast<long long>(blockIdx.x) * THREADS + tid;
           i < n; i += static_cast<long long>(gridDim.x) * THREADS) {
        const long long at = base + i / n4 * p.N + i % n4 * 4;
        *reinterpret_cast<float4*>(p.out + at) = z;
        if (MODE == 1) *reinterpret_cast<float4*>(p.out2 + at) = z;
      }
    }
  }

  // The schedule: the items before each slot.
  Sched<MODE> sc{pre, 0, (p.K + KT - 1) / KT, (p.K + BM - 1) / BM,
                 (p.N + L::BNO - 1) / L::BNO};
  for (int g = tid; g < p.G; g += THREADS)
    pre[g + 1] = sc.items_of(valid_rows(p.rows, g, p.M), p.chunk);
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(bars + 8 * s, 128);              // full: the splitters
      mbar_init(bars + 8 * (NS + s), CONSUMERS); // empty: the products
    }
    for (int s = 0; s < NL; ++s)
      mbar_init(bars + 8 * (2 * NS + s), 128);   // landed: the loaders'
                                                 // arrivals and bytes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < 32) {
    int carry = 0;
    for (int base = 0; base < p.G; base += 32) {
      int v = base + lane < p.G ? pre[base + lane + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (base + lane < p.G) pre[base + lane + 1] = v + carry;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) pre[0] = 0;
  }
  __syncthreads();
  sc.total = pre[p.G];
  auto set = [&](int t) { return smem + (t % NS) * L::SET; };
  const uint32_t full = bars, empty = bars + 8 * NS;

  if (wg == 2) {
    // ---- loads and splits: stage t's B split into operand set t % NS
    // beside its A once its landing tile has landed; then the loads of
    // stage t + NL - 1, after the products of the stage that last used
    // their set.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int ptid = tid - CONSUMERS;
    auto land = [&](int t) { return smem + L::LAND0 + (t % NL) * L::LAND; };
    auto lbar = [&](int t) { return bars + 8 * (2 * NS + t % NL); };
    Cursor sp = sc.start(blockIdx.x, p), ld = sp;
    for (int i = 0; i < NL - 1 && ld.item < sc.total; ++i) {
      load_stage<MODE>(set(i), land(i), lbar(i), ld, sc.where(ld, p), p,
                       sc.nk, ptid);
      sc.advance(ld, p);
    }
    for (int t = 0; sp.item < sc.total; ++t) {
      mbar_wait(lbar(t), (t / NL) & 1);    // stage t landed
      split_b<MODE>(land(t), set(t), ptid);
      fence_proxy_async();         // the planes, for the async proxy
      mbar_arrive(full + 8 * (t % NS));
      named_sync(1, 128);          // every split of stage t done
      const int tl = t + NL - 1;
      if (ld.item < sc.total) {
        if (tl >= NS) mbar_wait(empty + 8 * (tl % NS), (tl / NS - 1) & 1);
        load_stage<MODE>(set(tl), land(tl), lbar(tl), ld, sc.where(ld, p),
                         p, sc.nk, ptid);
      }
      sc.advance(ld, p);
      sc.advance(sp, p);
    }
  } else {
    // ---- products: 64 output rows a warpgroup; a set is released once
    // its stage's products are done.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[64], big[64], small[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    Cursor cur = sc.start(blockIdx.x, p);
    int in_chunk = 0;                    // stages of the chunk summed
    for (int t = 0; cur.item < sc.total; ++t) {
      mbar_wait(full + 8 * (t % NS), (t / NS) & 1);
      stage_products<MODE>(set(t), wg, big, small, in_chunk);
      fence_proxy_async();       // x's rows read, before they are landed on
      mbar_arrive(empty + 8 * (t % NS));
      const bool last = cur.stage == cur.ns - 1;
      if (last || in_chunk == CHUNK - 1) {
        fence_regs(big);
        fence_regs(small);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += big[i] + small[i];
        in_chunk = 0;
        if (last) {
          epilogue<MODE>(acc, cur, sc.where(cur, p), p);
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        }
      } else {
        ++in_chunk;
      }
      sc.advance(cur, p);
    }
  }
}

// Mode 2 in chunks: out[g] = the sum of slot g's ceil(rows / chunk)
// partials in chunk order (zeros for a slot with none).
__global__ void __launch_bounds__(256) wgrad_sum_kernel(const Args p) {
  const long long kn4 = static_cast<long long>(p.K) * p.N / 4;
  const long long n = kn4 * p.G;
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * 256) {
    const int g = static_cast<int>(i / kn4);
    const long long e = i % kn4;
    const int cnt = valid_rows(p.rows, g, p.M);
    const int ch = (cnt + p.chunk - 1) / p.chunk;
    const float4* part = reinterpret_cast<const float4*>(p.ws) +
                         static_cast<long long>(g) * p.nch * kn4 + e;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < ch; ++c) {
      const float4 v = part[c * kn4];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    reinterpret_cast<float4*>(p.out)[i] = s;
  }
}

constexpr int MAX_DEVICES = 64;

// The current device's SM count, and each kernel's shared-memory opt-in
// made once a device: at the reduced widths the kernels take a few
// microseconds, and these calls took as long again on the host.
int prepare(int* sms) {
  static int sm_of[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (sm_of[dev] == 0) {
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    for (int m = 0; m < 3 && e == cudaSuccess; ++m)
      e = cudaFuncSetAttribute(
          m == 0 ? reinterpret_cast<const void*>(grouped_bwd_f32_kernel<0>)
          : m == 1 ? reinterpret_cast<const void*>(grouped_bwd_f32_kernel<1>)
                   : reinterpret_cast<const void*>(grouped_bwd_f32_kernel<2>),
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          m == 0 ? Lay<0>::BYTES : m == 1 ? Lay<1>::BYTES : Lay<2>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    sm_of[dev] = n;
  }
  *sms = sm_of[dev];
  return 0;
}

template <int MODE>
int launch(const Args& p, cudaStream_t s) {
  int sms = 0;
  int err = prepare(&sms);
  if (err) return err;
  grouped_bwd_f32_kernel<MODE><<<sms, THREADS, Lay<MODE>::BYTES, s>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err || MODE != 2 || p.chunk == 0) return err;
  wgrad_sum_kernel<<<4 * sms, 256, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes.  mode 0 (dgrad): a = x (G, M, K),
// a2 = x2 or null, b = w (G, N, K), b2 = w2 or null, out (G, M, N); mode 1
// (SwiGLU backward): a = x (G, M, K), b = w1, b2 = w3 (G, K, N), dact
// (G, M, N) contiguous, out = dh, out2 = dg (G, M, N); mode 2 (wgrad):
// a = x (G, M, K), b = d (G, M, N), out (G, K, N); with chunk > 0 the
// partial sums go to ws, G * ceil(M / chunk) * K * N floats (chunk a
// multiple of 32).  All fp32 with a unit-stride last dim and 16-byte
// aligned rows; outputs contiguous.  rows: a (G,) int64 device vector or
// null; G at most 512.  sag / sar and sbg / sbr: a's and b's slot and row
// strides (a2, b2 share them), elements.  zero_padded (modes 0, 1): write
// zeros in the rows from each count rounded up to 128 on.  Launches on
// `stream`, does not synchronise, returns the CUDA error code (0 =
// launched).
extern "C" int grouped_bwd_f32_launch(
    int mode, const void* a, const void* a2, const void* b, const void* b2,
    const void* dact, void* out, void* out2, void* ws, const void* rows,
    int G, int M, int K, int N, long long sag, long long sar, long long sbg,
    long long sbr, int zero_padded, int chunk, void* stream) {
  if (G < 1 || G > MAX_G || M < 0 || K < 1 || N < 1 || K % 4 || N % 4 ||
      chunk < 0 || chunk % KT || (mode == 2 && chunk && ws == nullptr) ||
      (mode == 1 && (b2 == nullptr || dact == nullptr || out2 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.a = static_cast<const float*>(a);
  p.a2 = static_cast<const float*>(a2);
  p.b = static_cast<const float*>(b);
  p.b2 = static_cast<const float*>(b2);
  p.dact = static_cast<const float*>(dact);
  p.out = static_cast<float*>(out);
  p.out2 = static_cast<float*>(out2);
  p.ws = static_cast<float*>(ws);
  p.rows = static_cast<const long long*>(rows);
  p.G = G; p.M = M; p.K = K; p.N = N;
  p.sag = sag; p.sar = sar; p.sbg = sbg; p.sbr = sbr;
  p.second = a2 != nullptr && b2 != nullptr;
  p.zero_padded = zero_padded;
  p.chunk = mode == 2 ? chunk : 0;
  p.nch = p.chunk ? (M + p.chunk - 1) / p.chunk : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 && mode != 2) return 0;
  switch (mode) {
    case 0: return launch<0>(p, s);
    case 1: return launch<1>(p, s);
    case 2: return launch<2>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
