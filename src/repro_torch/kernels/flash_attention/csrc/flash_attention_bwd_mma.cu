// Flash attention backward on mma.sync for Hopper (sm_90a): GQA, full
// sequences (the training step), causal or not; fp32 at every (q/k, v)
// head-dim pair the forward takes, (16, 16), (64, 64), (80, 80),
// (128, 128) and (192, 128) (B4f), and bf16 at (16, 16), the reduced
// configurations' width, where the bf16 forward leaves wgmma too
// (flash_attention.cu kernel 3).  The other bf16 pairs take the TMA +
// wgmma kernels of flash_attention_bwd.cu (B4, B4m).
//
// The JAX package has no backward kernel: XLA differentiates
// repro/models/attention.py:flash_ref (the plain version of the Pallas
// forward, repro/kernels/flash_attention/kernel.py:flash_fwd_pallas) at
// any width and dtype; the JAX trainer defaults to fp32, so this is the
// backward the port's trainer runs at its defaults.  From q, k (B, S, H or
// Hkv, HDK), v (B, S, Hkv, HDV), the forward's output o and its gradient
// do (B, S, H, HDV) and the forward's row logsumexp lse (B, H, S, fp32,
// natural log; the prefill kernels write it when asked) it computes dq,
// dk, dv in the operands' dtype with fp32 accumulation:
//   P = exp(scale q k^T - lse), dP = do v^T, D = rowsum(do o),
//   dS = P (dP - D), dq = scale dS k, dk = scale dS^T q, dv = P^T do.
//
// What bounds it on an H100: operations.  Five products of a (query, key)
// pair, 2 (3 HDK + 2 HDV) flops; in 3xTF32 each product is three TF32
// products, so at the data sheet's TF32 rate (495 TFLOP/s) a pair at hd
// 128 (Qwen3-0.6B's) costs 7.8 ps against 19 ps on the fp32 CUDA cores
// (the data sheet's 67 TFLOP/s); the bytes (q, k, v, o, do, lse read
// once, dq, dk, dv written once) are a few percent of that.  These
// kernels do seven products (S and dP twice, so that dq needs no
// atomics) on mma.sync.
//
// Precision (fp32): every product in 3xTF32 as the fp32 forward's
// (flash_fwd_f32_kernel): each operand split into hi + lo TF32 parts
// (warp_mma.cuh split_tf32), a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, so
// each product keeps about 2^-20 of its size.  The tensor core truncates as it
// accumulates, so S^T and dP^T keep their small terms apart from their
// large ones over the head dim, and dv, dk and dq sum each stage of
// queries or keys in fresh registers that are added to them in fp32.
// bf16 (hd 16): P and dS are rounded to bf16 as the A operands of their
// products, as B4 does.
//
// Determinism: every sum is taken in a fixed order (a warp's dk and dv
// over its head's query tiles in order, the group's heads then added in
// head order by a third kernel; dq over the key tiles in order); no
// atomics, so the same bits on every run.
//
// Design: four kernels.
//   1. bwd_prep_mma_kernel: one warp a row (b, h, position) writes lse2 =
//      lse log2(e) and D = rowsum(do o) into an fp32 workspace of two
//      (B, H, S64) arrays, S64 = S rounded up to 64 (B4's layout);
//      positions past S get lse2 = +inf and D = 0, so P is 0 there.
//   2. bwd_dkdv_mma_kernel: one block of 4 warps per (64-key tile, query
//      head, batch row), key-tile major (the heaviest, first causal tiles
//      first).  A block takes one query head, not the G heads of its KV
//      head in turn: G times the blocks, and a causal first key tile's
//      block no longer walks G whole sequences while the rest of the card
//      idles (a block a KV head is 128 blocks at B 1, S 2048, 16 / 4
//      heads: one an SM, a warp a sub-partition).  K and V of the block's keys stay
//      resident in fp32; 16 query rows of q and do a stage (with their
//      lse2 and D), from the diagonal on when causal, land by cp.async;
//      each warp owns 16 keys and per stage forms S^T = K q^T and dP^T =
//      V do^T (K's and V's fragments by ldmatrix, split in registers), P^T
//      and dS^T in registers, repacks them as A fragments (the
//      accumulator's columns permuted within each 8-key step, do and q
//      read in that order) and adds dv += P^T do and dk += dS^T q.  dk and
//      dv stay in registers over the head's queries; with G = 1 they are
//      written as the outputs, else as fp32 partials of the head into a
//      workspace (B, S, H, HDK + HDV).
//   3. bwd_group_sum_kernel (G > 1): dk = scale sum_h dk_h, dv = sum_h
//      dv_h over each KV head's G query heads, in head order.
//   4. bwd_dq_mma_kernel: one block of 4 warps per (64-query tile, query
//      head, batch row), the heaviest (last, causal) tiles first: q and do
//      resident in fp32, 16-key stages of K and V up to the diagonal; per
//      stage each warp forms S = q K^T and dP = do V^T, P, dS, then dq +=
//      dS K; dq is written once.
// The operands stay fp32 in shared memory and each warp splits the
// fragments it reads into hi and lo TF32 parts.  Split once instead (the
// landed stage as a hi plane in place and a lo plane beside, read with one
// ldmatrix a fragment) was measured at every pair (PERF.md): the
// planes double the bytes a fragment read moves, take a stage's size
// again in shared memory (8-row stages at (192, 128)) and add a block
// barrier a stage, and were slower at the pairs the paths run.
// Shared memory: rows of HD + 4 floats (fp32; HD + 8 bf16 elements at hd
// 16), so the fragments' reads hit distinct banks and every row starts on
// 16 bytes; the resident 64 rows and NBUF landed stages.
// Two blocks an SM at every pair (at most 113 KB each): two stages where
// they fit, (128, 128) 101.6 KB, one at (192, 128), 105.1 KB.
// Registers: dk and dv take HDK / 2 + HDV / 2 fp32 a thread (160 at
// (192, 128)).
//
// Not yet: the products on TF32 wgmma.  The budget is what stops them:
// TF32 wgmma reads both shared operands K-major, so the dK/dV pass would
// hold K and V as hi and lo planes (128 KB for 64 keys at (128, 128), 160
// KB at (192, 128)) beside the stage's q, do and their transposes (64 KB
// for 16 queries at (128, 128)): one block of one warpgroup an SM, and
// dk, dv, S^T and dP^T with their small terms exceed a warpgroup's
// registers at 64 queries a stage.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 16 * WARPS;       // resident keys (dK/dV) or queries (dQ)
constexpr int PAD = 64;                // workspace rows pad to this
constexpr int TWO_BLOCKS = 113 * 1024; // a block's share when two fit an SM
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;          // (B, H, S)
  float* ws;                 // lse2 then D, each (B, H, S64)
  float* part;               // G > 1: dk then dv partials, (B, S, H, HD) fp32
  void *dq, *dk, *dv;
  int B, S, S64, H, Hkv, G;
  long long skh, sks, skb, svh, svs, svb;   // k, v strides, elements
  float scale, scale_log2;
  long long ws_half;         // B * H * S64
};

// The products by operand type.  A fragments come from rows of a resident
// shared array (rows = M, the contraction along the row) or from an fp32
// accumulator of the same rows; B fragments from a landed stage, rows n
// (b_rows: X Y^T) or k (b_cols: X Y).

template <typename T>
struct Mma;

// fp32 in 3xTF32 on m16n8k8, every fragment split in registers as it is
// read.
template <>
struct Mma<float> {
  static constexpr int KS = 8;     // contraction a step
  static constexpr int PAD = 4;    // shared row padding, elements
  struct A { unsigned h[4], l[4]; };
  struct B { unsigned h[2], l[2]; };

  // Rows r0 + gid (+ 8), columns k0 + tq (+ 4): one ldmatrix (lanes
  // 8i .. 8i + 7 give rows of matrix i: rows + 8 (i % 2), columns
  // + 4 (i / 2)).
  __device__ static __forceinline__ A a_rows(const float* s, int ld, int r0,
                                             int k0) {
    const int lane = threadIdx.x % 32, i = lane >> 3;
    unsigned r[4];
    ldsm_x4(r, static_cast<unsigned>(__cvta_generic_to_shared(
                   s + (r0 + (lane & 7) + 8 * (i & 1)) * ld + k0 +
                   4 * (i >> 1))));
    A a;
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]), a.h[e], a.l[e]);
    return a;
  }
  // n = row n0 + gid, k = k0 + tq (+ 4).
  __device__ static __forceinline__ B b_rows(const float* s, int ld, int n0,
                                             int k0) {
    const int lane = threadIdx.x % 32;
    const float* p = s + (n0 + lane / 4) * ld + k0 + lane % 4;
    B b;
    split_tf32(p[0], b.h[0], b.l[0]);
    split_tf32(p[4], b.h[1], b.l[1]);
    return b;
  }
  // k = row k0 + 2 tq (+ 1), n = n0 + gid: the k order of from_acc.
  __device__ static __forceinline__ B b_cols(const float* s, int ld, int k0,
                                             int n0) {
    const int lane = threadIdx.x % 32;
    const float* p = s + (k0 + 2 * (lane % 4)) * ld + n0 + lane / 4;
    B b;
    split_tf32(p[0], b.h[0], b.l[0]);
    split_tf32(p[ld], b.h[1], b.l[1]);
    return b;
  }
  // One n8 tile of an accumulator (value e at row gid + 8 (e / 2), column
  // 2 tq + e % 2) as the A fragment of a k8 step whose column tq is 2 tq
  // and column tq + 4 is 2 tq + 1.
  __device__ static __forceinline__ A from_acc(const float (*c)[4]) {
    A a;
    split_tf32(c[0][0], a.h[0], a.l[0]);
    split_tf32(c[0][1], a.h[2], a.l[2]);
    split_tf32(c[0][2], a.h[1], a.l[1]);
    split_tf32(c[0][3], a.h[3], a.l[3]);
    return a;
  }
  __device__ static __forceinline__ void mma(float (&big)[4],
                                             float (&small)[4], const A& a,
                                             const B& b) {
    mma_3xtf32(big, small, a.h, a.l, b.h, b.l);
  }
};

__device__ __forceinline__ unsigned pack2(bf16 lo, bf16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

// bf16 on m16n8k16; `small` is not used.
template <>
struct Mma<bf16> {
  static constexpr int KS = 16;
  static constexpr int PAD = 8;
  struct A { unsigned h[4]; };
  struct B { unsigned h[2]; };

  __device__ static __forceinline__ A a_rows(const bf16* s, int ld, int r0,
                                             int k0) {
    const int lane = threadIdx.x % 32;
    const bf16* p = s + (r0 + lane / 4) * ld + k0 + 2 * (lane % 4);
    return A{{lds32(p), lds32(p + 8 * ld), lds32(p + 8), lds32(p + 8 * ld + 8)}};
  }
  __device__ static __forceinline__ B b_rows(const bf16* s, int ld, int n0,
                                             int k0) {
    const int lane = threadIdx.x % 32;
    const bf16* p = s + (n0 + lane / 4) * ld + k0 + 2 * (lane % 4);
    return B{{lds32(p), lds32(p + 8)}};
  }
  __device__ static __forceinline__ B b_cols(const bf16* s, int ld, int k0,
                                             int n0) {
    const int lane = threadIdx.x % 32;
    const bf16* p = s + (k0 + 2 * (lane % 4)) * ld + n0 + lane / 4;
    return B{{pack2(p[0], p[ld]), pack2(p[8 * ld], p[9 * ld])}};
  }
  // Two n8 tiles of an accumulator as the A fragment of one k16 step.
  __device__ static __forceinline__ A from_acc(const float (*c)[4]) {
    return A{{pack_bf16(c[0][0], c[0][1]), pack_bf16(c[0][2], c[0][3]),
              pack_bf16(c[1][0], c[1][1]), pack_bf16(c[1][2], c[1][3])}};
  }
  __device__ static __forceinline__ void mma(float (&big)[4], float (&)[4],
                                             const A& a, const B& b) {
    mma_bf16(big, a.h, b.h[0], b.h[1]);
  }
};

// Shared-memory layout for element T and head dims (HDK, HDV): ROWS
// resident rows of two operands, then NBUF landed stages of STAGE rows of
// the two streamed ones (q and do, or K and V), and each stage's lse2 and
// D (the dK/dV pass).  NBUF 2 where two blocks still fit an SM, else 1.
template <typename T, int HDK, int HDV>
struct Tiles {
  using M = Mma<T>;
  static constexpr int STAGE = 16;                        // streamed rows
  static constexpr int LDK = HDK + M::PAD, LDV = HDV + M::PAD;
  static constexpr int RES = ROWS * (LDK + LDV);          // elements
  static constexpr int STAGE_ELEMS = STAGE * (LDK + LDV);
  static constexpr int STAT_FLOATS = 2 * STAGE;           // lse2, D
  static constexpr int ELT = static_cast<int>(sizeof(T));
  static constexpr int NBUF =
      (RES + 2 * STAGE_ELEMS) * ELT + 2 * STAT_FLOATS * 4 <= TWO_BLOCKS ? 2
                                                                        : 1;
  static constexpr int BYTES =
      (RES + NBUF * STAGE_ELEMS) * ELT + NBUF * STAT_FLOATS * 4;
  static_assert(LDK * sizeof(T) % 16 == 0 && LDV * sizeof(T) % 16 == 0,
                "rows start on 16 bytes");
  static_assert(BYTES <= TWO_BLOCKS, "two blocks an SM");
};

// NROWS rows of COLS elements into rows LD apart, 16-byte cp.async pieces
// by the whole block; src(r) is row r's address, or null (zero-filled).
template <typename T, int COLS, int LD, int NROWS, typename RowPtr>
__device__ __forceinline__ void load_rows(T* dst, RowPtr src, const T* any) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int PIECES = COLS / VEC;
  static_assert(COLS % VEC == 0, "rows of whole 16-byte pieces");
  for (int i = threadIdx.x; i < NROWS * PIECES; i += THREADS) {
    const int r = i / PIECES, c = i % PIECES * VEC;
    const T* s = src(r);
    cp_async16(dst + r * LD + c, s != nullptr ? s + c : any,
               s != nullptr ? 16 : 0);
  }
}

// acc (16 x N, N / 8 tiles) += X Y: X the 16 x ST accumulator x (fp32,
// repacked as A fragments), Y ST rows of N columns of a landed stage
// (rows LD apart).  Each 8-column block sums the stage in fresh
// registers and adds them to acc in fp32.
template <typename M, typename T, int N, int LD, int ST>
__device__ __forceinline__ void add_product(float (&acc)[N / 8][4],
                                            const float (&x)[ST / 8][4],
                                            const T* y) {
  constexpr int KSTEPS = ST / M::KS;
  typename M::A xa[KSTEPS];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) xa[kk] = M::from_acc(&x[kk * M::KS / 8]);
#pragma unroll
  for (int nf = 0; nf < N / 8; ++nf) {
    float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      M::mma(big, small, xa[kk],
             M::b_cols(y, LD, kk * M::KS, nf * 8));
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nf][e] += big[e] + small[e];
  }
}

// x (16 x ST) = X Y^T over D: X 16 resident rows at x_s from row x0, Y ST
// rows of a landed stage, all LD apart; large and small terms
// apart (xs), summed into x at the end.
template <typename M, typename T, int D, int LD, int ST>
__device__ __forceinline__ void product_t(float (&x)[ST / 8][4],
                                          const T* x_s, int x0,
                                          const T* y) {
  float xs[ST / 8][4];
#pragma unroll
  for (int j = 0; j < ST / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = xs[j][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / M::KS; ++kd) {
    const typename M::A a = M::a_rows(x_s, LD, x0, kd * M::KS);
#pragma unroll
    for (int j = 0; j < ST / 8; ++j)
      M::mma(x[j], xs[j], a, M::b_rows(y, LD, j * 8, kd * M::KS));
  }
#pragma unroll
  for (int j = 0; j < ST / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] += xs[j][e];
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The 16 rows of a warp's accumulator (N / 8 tiles) times `mul` into rows
// dst(r) of N elements, r = r0 + gid (+ 8), those below `limit`.
template <typename T, int N, typename RowPtr>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 8][4],
                                           float mul, int r0, int limit,
                                           RowPtr dst) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + lane / 4 + 8 * i;
    if (r >= limit) continue;
    T* p = dst(r) + 2 * (lane % 4);
#pragma unroll
    for (int nf = 0; nf < N / 8; ++nf)
      store2(p + 8 * nf, acc[nf][2 * i] * mul, acc[nf][2 * i + 1] * mul);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int HDV>
__global__ void __launch_bounds__(256) bwd_prep_mma_kernel(const Args a) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (row >= a.ws_half) return;
  const int lane = threadIdx.x % 32;
  const int s = static_cast<int>(row % a.S64);
  const long long bh = row / a.S64;               // b * H + h
  float sum = 0.f, lse2 = INFINITY;
  if (s < a.S) {
    const int h = static_cast<int>(bh % a.H);
    const long long b = bh / a.H;
    const long long at = ((b * a.S + s) * a.H + h) * HDV;
    const T* o = static_cast<const T*>(a.o) + at;
    const T* d = static_cast<const T*>(a.dout) + at;
#pragma unroll
    for (int i = lane; i < HDV; i += 32) sum += to_f32(o[i]) * to_f32(d[i]);
    sum = warp_sum(sum);
    lse2 = a.lse[bh * a.S + s] * LOG2E;
  }
  if (lane == 0) {
    a.ws[row] = lse2;
    a.ws[a.ws_half + row] = sum;
  }
}

template <typename T, int HDK, int HDV, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 2)
bwd_dkdv_mma_kernel(const Args a) {
  using C = Tiles<T, HDK, HDV>;
  using M = typename C::M;
  constexpr int LDK = C::LDK, LDV = C::LDV, ST = C::STAGE, NBUF = C::NBUF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + ROWS * LDK;
  T* ring = v_s + ROWS * LDV;                  // stage st: q, then do
  float* stats = reinterpret_cast<float*>(ring + NBUF * C::STAGE_ELEMS);
  const auto* qg = static_cast<const T*>(a.q);
  const auto* kg = static_cast<const T*>(a.k);
  const auto* vg = static_cast<const T*>(a.v);
  const auto* dog = static_cast<const T*>(a.dout);

  // Key tile major, so every block of the first key tiles (the heaviest
  // when causal) starts first.
  const int per = a.H * a.B;
  const int kt = static_cast<int>(blockIdx.x / per);
  const int h = static_cast<int>(blockIdx.x % per) % a.H;
  const int b = static_cast<int>(blockIdx.x % per) / a.H;
  const int hkv = h / a.G;
  const int k0 = kt * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tq = lane % 4;
  const int kw0 = k0 + 16 * warp;              // this warp's first key

  load_rows<T, HDK, LDK, ROWS>(k_s, [&](int r) -> const T* {
    const int key = k0 + r;
    return key < a.S ? kg + b * a.skb + key * a.sks + hkv * a.skh : nullptr;
  }, kg);
  load_rows<T, HDV, LDV, ROWS>(v_s, [&](int r) -> const T* {
    const int key = k0 + r;
    return key < a.S ? vg + b * a.svb + key * a.svs + hkv * a.svh : nullptr;
  }, vg);
  const int n_qt = (a.S + ST - 1) / ST;
  const int qt0 = CAUSAL ? k0 / ST : 0;        // the diagonal's tile
  const int iters = n_qt - qt0;
  auto load_stage = [&](int st, int it) {
    const int q0 = (qt0 + it) * ST;
    T* q_s = ring + st * C::STAGE_ELEMS;
    load_rows<T, HDK, LDK, ST>(q_s, [&](int r) -> const T* {
      const int p = q0 + r;
      return p < a.S ? qg + (static_cast<long long>(b * a.S + p) * a.H + h) * HDK
                     : nullptr;
    }, qg);
    load_rows<T, HDV, LDV, ST>(q_s + ST * LDK, [&](int r) -> const T* {
      const int p = q0 + r;
      return p < a.S ? dog + (static_cast<long long>(b * a.S + p) * a.H + h) * HDV
                     : nullptr;
    }, dog);
    // lse2 and D of the stage's queries: the workspace rows are padded to
    // S64, a multiple of ST, so the slice is read whole.
    constexpr int P4 = ST / 4;
    if (threadIdx.x < 2 * P4) {
      const int half = threadIdx.x / P4, piece = threadIdx.x % P4;
      const float* src = a.ws + half * a.ws_half +
                         (static_cast<long long>(b) * a.H + h) * a.S64 + q0;
      cp_async16(stats + st * C::STAT_FLOATS + half * ST + piece * 4,
                 src + piece * 4, 16);
    }
  };
  if (iters > 0) load_stage(0, 0);
  cp_async_commit();

  float dk[HDK / 8][4], dv[HDV / 8][4];
#pragma unroll
  for (int i = 0; i < HDK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < HDV / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[i][e] = 0.f;

  for (int it = 0; it < iters; ++it) {
    const int buf = NBUF == 2 ? it & 1 : 0;
    if (NBUF == 2) {
      if (it + 1 < iters) load_stage((it + 1) & 1, it + 1);
      cp_async_commit();
      cp_async_wait<1>();            // stage it (and K, V) landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* q_s = ring + buf * C::STAGE_ELEMS;
    const int q0 = (qt0 + it) * ST;
    // A warp past S, or a causal stage wholly before its first key, adds
    // nothing.
    if (kw0 < a.S && (!CAUSAL || q0 + ST - 1 >= kw0)) {
      const T* do_s = q_s + ST * LDK;
      const float* lse2 = stats + buf * C::STAT_FLOATS;
      const float* dl = lse2 + ST;
      // S^T = K q^T and dP^T = V do^T: value e of tile j at key
      // kw0 + gid + 8 (e / 2), query q0 + 8 j + 2 tq + e % 2.
      float s[ST / 8][4], dp[ST / 8][4];
      product_t<M, T, HDK, LDK, ST>(s, k_s, 16 * warp, q_s);
      const bool diag = CAUSAL && q0 < kw0 + 15;
#pragma unroll
      for (int j = 0; j < ST / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * tq + (e & 1);
          float p = exp2f(fmaf(s[j][e], a.scale_log2, -lse2[qi]));
          if (diag && kw0 + gid + 8 * (e >> 1) > q0 + qi) p = 0.f;
          s[j][e] = p;
        }
      product_t<M, T, HDV, LDV, ST>(dp, v_s, 16 * warp, do_s);
#pragma unroll
      for (int j = 0; j < ST / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = s[j][e] * (dp[j][e] - dl[8 * j + 2 * tq + (e & 1)]);
      add_product<M, T, HDV, LDV, ST>(dv, s, do_s);    // dv += P^T do
      add_product<M, T, HDK, LDK, ST>(dk, dp, q_s);     // dk += dS^T q
    }
    __syncthreads();                 // the stage is free
    if (NBUF == 1 && it + 1 < iters) {
      load_stage(0, it + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  if (a.G == 1) {
    const long long row0 = static_cast<long long>(b) * a.S * a.Hkv + hkv;
    store_rows<T, HDK>(dk, a.scale, kw0, a.S, [&](int r) {
      return static_cast<T*>(a.dk) + (row0 + static_cast<long long>(r) * a.Hkv) * HDK;
    });
    store_rows<T, HDV>(dv, 1.f, kw0, a.S, [&](int r) {
      return static_cast<T*>(a.dv) + (row0 + static_cast<long long>(r) * a.Hkv) * HDV;
    });
  } else {
    // This head's partials, fp32, unscaled: (B, S, H, HDK) then HDV.
    const long long row0 = static_cast<long long>(b) * a.S * a.H + h;
    float* pk = a.part;
    float* pv = a.part + static_cast<long long>(a.B) * a.S * a.H * HDK;
    store_rows<float, HDK>(dk, 1.f, kw0, a.S, [&](int r) {
      return pk + (row0 + static_cast<long long>(r) * a.H) * HDK;
    });
    store_rows<float, HDV>(dv, 1.f, kw0, a.S, [&](int r) {
      return pv + (row0 + static_cast<long long>(r) * a.H) * HDV;
    });
  }
}

// dk = scale sum_h dk_h and dv = sum_h dv_h over the G query heads of each
// KV head, in head order, from the dK/dV pass's fp32 partials.
template <typename T, int HDK, int HDV>
__global__ void __launch_bounds__(256) bwd_group_sum_kernel(const Args a) {
  constexpr int K4 = HDK / 4, V4 = HDV / 4;
  const long long rows = static_cast<long long>(a.B) * a.S * a.Hkv;
  const long long n = rows * (K4 + V4);
  const float* pv = a.part + static_cast<long long>(a.B) * a.S * a.H * HDK;
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * 256) {
    const bool is_k = i < rows * K4;
    const long long j = is_k ? i : i - rows * K4;
    const int w4 = is_k ? K4 : V4;
    const long long row = j / w4;                 // (b, s) * Hkv + hkv
    const int c = static_cast<int>(j % w4) * 4;
    const int hd = is_k ? HDK : HDV;
    const float* src = (is_k ? a.part : pv) +
                       (row * a.G) * hd + c;      // heads hkv G .. hkv G + G - 1
    float4 s = *reinterpret_cast<const float4*>(src);
    for (int g = 1; g < a.G; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(src + g * hd);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    const float mul = is_k ? a.scale : 1.f;
    T* dst = static_cast<T*>(is_k ? a.dk : a.dv) + row * hd + c;
    store2(dst, s.x * mul, s.y * mul);
    store2(dst + 2, s.z * mul, s.w * mul);
  }
}

template <typename T, int HDK, int HDV, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 2)
bwd_dq_mma_kernel(const Args a) {
  using C = Tiles<T, HDK, HDV>;
  using M = typename C::M;
  constexpr int LDK = C::LDK, LDV = C::LDV, ST = C::STAGE, NBUF = C::NBUF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + ROWS * LDK;
  T* ring = do_s + ROWS * LDV;                 // stage st: K, then V
  const auto* qg = static_cast<const T*>(a.q);
  const auto* kg = static_cast<const T*>(a.k);
  const auto* vg = static_cast<const T*>(a.v);
  const auto* dog = static_cast<const T*>(a.dout);

  // Query tile major, the heaviest (last, causal) tiles first.
  const int per = a.H * a.B;
  const int n_qt = (a.S + ROWS - 1) / ROWS;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / per);
  const int h = static_cast<int>(blockIdx.x % per) % a.H;
  const int b = static_cast<int>(blockIdx.x % per) / a.H;
  const int hkv = h / a.G;
  const int q0 = qt * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tq = lane % 4;
  const int qw0 = q0 + 16 * warp;              // this warp's first query

  load_rows<T, HDK, LDK, ROWS>(q_s, [&](int r) -> const T* {
    const int p = q0 + r;
    return p < a.S ? qg + (static_cast<long long>(b * a.S + p) * a.H + h) * HDK
                   : nullptr;
  }, qg);
  load_rows<T, HDV, LDV, ROWS>(do_s, [&](int r) -> const T* {
    const int p = q0 + r;
    return p < a.S ? dog + (static_cast<long long>(b * a.S + p) * a.H + h) * HDV
                   : nullptr;
  }, dog);
  const int kv_end = CAUSAL ? min(a.S, q0 + ROWS) : a.S;
  const int n_t = (kv_end + ST - 1) / ST;
  auto load_stage = [&](int st, int t) {
    T* k_s = ring + st * C::STAGE_ELEMS;
    load_rows<T, HDK, LDK, ST>(k_s, [&](int r) -> const T* {
      const int key = t * ST + r;
      return key < a.S ? kg + b * a.skb + key * a.sks + hkv * a.skh : nullptr;
    }, kg);
    load_rows<T, HDV, LDV, ST>(k_s + ST * LDK, [&](int r) -> const T* {
      const int key = t * ST + r;
      return key < a.S ? vg + b * a.svb + key * a.svs + hkv * a.svh : nullptr;
    }, vg);
  };
  if (n_t > 0) load_stage(0, 0);
  cp_async_commit();

  // This thread's rows row_r and row_r + 8: lse2 and D.
  const int row_r = qw0 + gid;
  float lse2[2], dl[2];
  const long long st0 = (static_cast<long long>(b) * a.H + h) * a.S64;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row_r + 8 * i;
    lse2[i] = r < a.S ? a.ws[st0 + r] : INFINITY;
    dl[i] = r < a.S ? a.ws[a.ws_half + st0 + r] : 0.f;
  }
  float dq[HDK / 8][4];
#pragma unroll
  for (int i = 0; i < HDK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  for (int t = 0; t < n_t; ++t) {
    const int buf = NBUF == 2 ? t & 1 : 0;
    if (NBUF == 2) {
      if (t + 1 < n_t) load_stage((t + 1) & 1, t + 1);
      cp_async_commit();
      cp_async_wait<1>();            // stage t (and q, do) landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* k_s = ring + buf * C::STAGE_ELEMS;
    const int key0 = t * ST;
    // A warp past S, or a causal stage wholly after its last query, adds
    // nothing.
    if (qw0 < a.S && (!CAUSAL || key0 <= qw0 + 15)) {
      const T* v_s = k_s + ST * LDK;
      // S = q K^T and dP = do V^T: value e of tile j at query
      // row_r + 8 (e / 2), key key0 + 8 j + 2 tq + e % 2.
      float s[ST / 8][4], dp[ST / 8][4];
      product_t<M, T, HDK, LDK, ST>(s, q_s, 16 * warp, k_s);
      const bool mask = key0 + ST > a.S ||
                        (CAUSAL && key0 + ST - 1 > qw0);
#pragma unroll
      for (int j = 0; j < ST / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int key = key0 + 8 * j + 2 * tq + (e & 1);
          float p = exp2f(fmaf(s[j][e], a.scale_log2, -lse2[i]));
          if (mask && (key >= a.S || (CAUSAL && key > row_r + 8 * i)))
            p = 0.f;
          s[j][e] = p;
        }
      product_t<M, T, HDV, LDV, ST>(dp, do_s, 16 * warp, v_s);
#pragma unroll
      for (int j = 0; j < ST / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = s[j][e] * (dp[j][e] - dl[e >> 1]);
      add_product<M, T, HDK, LDK, ST>(dq, dp, k_s);    // dq += dS K
    }
    __syncthreads();                 // the stage is free
    if (NBUF == 1 && t + 1 < n_t) {
      load_stage(0, t + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  const long long row0 = static_cast<long long>(b) * a.S * a.H + h;
  store_rows<T, HDK>(dq, a.scale, qw0, a.S, [&](int r) {
    return static_cast<T*>(a.dq) + (row0 + static_cast<long long>(r) * a.H) * HDK;
  });
}

template <typename Kernel>
int launch_main(Kernel kernel, long long blocks, int smem, const Args& a,
                cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)   // two blocks of up to 113 KB an SM
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HDK, int HDV>
int run(const Args& a, bool causal, int parts, cudaStream_t s) {
  using C = Tiles<T, HDK, HDV>;
  if (parts & 1) {
    bwd_prep_mma_kernel<T, HDV>
        <<<static_cast<unsigned>((a.ws_half + 7) / 8), 256, 0, s>>>(a);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  const long long tiles = (a.S + ROWS - 1) / ROWS;
  if (parts & 2) {
    int err = launch_main(
        causal ? bwd_dkdv_mma_kernel<T, HDK, HDV, true>
               : bwd_dkdv_mma_kernel<T, HDK, HDV, false>,
        tiles * a.H * a.B, C::BYTES, a, s);
    if (err) return err;
    if (a.G > 1) {
      const long long n =
          static_cast<long long>(a.B) * a.S * a.Hkv * (HDK + HDV) / 4;
      const long long blocks = (n + 255) / 256;
      bwd_group_sum_kernel<T, HDK, HDV>
          <<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), 256, 0,
             s>>>(a);
      err = static_cast<int>(cudaGetLastError());
      if (err) return err;
    }
  }
  if (parts & 4)
    return launch_main(causal ? bwd_dq_mma_kernel<T, HDK, HDV, true>
                              : bwd_dq_mma_kernel<T, HDK, HDV, false>,
                       tiles * a.H * a.B, C::BYTES, a, s);
  return 0;
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype 0: fp32 at (hdk, hdv) of
// (16, 16), (64, 64), (80, 80), (128, 128) or (192, 128); 1: bf16 at
// (16, 16).  q, dq: (B, S, H, hdk); o, do: (B, S, H, hdv); k, dk:
// (B, S, Hkv, hdk); v, dv: (B, S, Hkv, hdv); q, o, do, dq, dk, dv
// contiguous, k and v read through their strides (head, position, batch;
// elements, unit-stride rows on 16 bytes).  lse: (B, H, S) fp32 from the
// forward; ws: an fp32 workspace of 2 B H S64 floats, S64 = S rounded up
// to 64 (16-byte aligned); part: where H > Hkv, an fp32 workspace of
// B S H (hdk + hdv) floats for the dK/dV pass's per-head partials (null
// otherwise; the argument list is flash_attention_bwd_launch's, whose
// `ds` this is).  Launches the kernels that `parts` names (1: prep, 2:
// dK/dV and, where H > Hkv, the group sum, 4: dQ; 7 all) on `stream`, does
// not synchronise, and returns the first failure's CUDA error code (0 =
// launched).
extern "C" int flash_attention_bwd_mma_launch(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* ws, void* dq, void* dk,
    void* dv, void* part, int B, int S, int H, int Hkv, int hdk, int hdv,
    int causal, float scale, int parts, long long skh, long long sks,
    long long skb, long long svh, long long svs, long long svb,
    void* stream) {
  const int inval = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv ||
      (H > Hkv && (parts & 2) && part == nullptr) ||
      (dtype != 0 && dtype != 1))
    return inval;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.ws = static_cast<float*>(ws);
  a.part = static_cast<float*>(part);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B;
  a.S = S;
  a.S64 = (S + PAD - 1) / PAD * PAD;
  a.H = H;
  a.Hkv = Hkv;
  a.G = H / Hkv;
  a.skh = skh; a.sks = sks; a.skb = skb;
  a.svh = svh; a.svs = svs; a.svb = svb;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  a.ws_half = static_cast<long long>(B) * H * a.S64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  if (dtype == 1)
    return hdk == 16 && hdv == 16 ? run<bf16, 16, 16>(a, c, parts, s) : inval;
  if (hdk == 192 && hdv == 128) return run<float, 192, 128>(a, c, parts, s);
  if (hdk != hdv) return inval;
  switch (hdk) {
    case 16: return run<float, 16, 16>(a, c, parts, s);
    case 64: return run<float, 64, 64>(a, c, parts, s);
    case 80: return run<float, 80, 80>(a, c, parts, s);
    case 128: return run<float, 128, 128>(a, c, parts, s);
    default: return inval;
  }
}
