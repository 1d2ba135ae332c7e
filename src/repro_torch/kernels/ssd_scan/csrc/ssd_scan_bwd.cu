// SSD intra-chunk backward for Hopper (sm_90a): the gradient of the
// quadratic term, the chunk state and the chunk decay of the Mamba-2 scan
// (B5).
//
// The JAX package has no backward kernel: XLA differentiates the plain SSD
// path around repro/kernels/ssd_scan/kernel.py ssd_intra_chunk_pallas (the
// forward this is the backward of, ssd_scan.cu here).  For each (batch b,
// chunk c, head h), with cum = cumsum(da), L[i,j] = exp(cum_i - cum_j) for
// j <= i (0 above the diagonal), CB = C B^T, W = CB * L * dt_j,
// wj = exp(cum_last - cum_j) dt_j, and the forward's y = W x,
// S = (B wj)^T x, decay = exp(cum_last), it takes dY (Q x P), dS (N x P)
// and d(decay) and gives:
//   dW   = dY x^T (j <= i),   G = dW * L * dt_j  (= d(CB)),
//   dx_j = sum_i W[i,j] dY_i + wj (B_j dS),
//   dC_i = sum_j G[i,j] B_j,  dB_j = sum_i G[i,j] C_i + wj (dS x_j),
//   ddt_j = T_j + (B_j . dS x_j) exp(cum_last - cum_j),
//           T_j = sum_i dW[i,j] CB[i,j] L[i,j],
//   dcum_i = sum_j dW W  - dt_i T_i  - (B_i . dS x_i) wi
//            (+ sum_j (B_j . dS x_j) wj + d(decay) decay at i = Q - 1),
//   dda_k = sum_{i >= k} dcum_i  (the reverse cumsum).
// (dt_i T_i is the column sum of dW W: the kernel sums dW CB L once for
// both.)  x, B, C in fp32 or bf16 (the forward's input types; dx, dB, dC
// come back in that type), dt, da, dY, dS, d(decay) fp32, all contiguous:
// x, dY (B, nc, Q, H, P), B, C (B, nc, Q, H, N), dt, da (B, nc, Q, H),
// dS (B, nc, H, N, P), d(decay) (B, nc, H).  (P, N) is (64, 16), Jamba's
// head dim and state, (64, 128), Mamba2-130M's, or (16, 16), the reduced
// configurations'; Q <= 128.
//
// What bounds it on an H100: bytes.  At Jamba-v0.1's train shape (B 1,
// T 4096: nc 32, Q 128, H 128, P 64, N 16) it reads x, B, C, dY, dS and
// the small inputs and writes dx, dB, dC, ddt, dda: 0.36 GB with bf16 x,
// B, C (0.108 ms at 3.35 TB/s), 0.56 GB with fp32 (0.168 ms).  Its
// products, the causal triangle's dW and C.B (each formed twice, once a
// pass), W^T dY, G B and G^T C, split parts included, are 68 mma.sync
// m16n8k16 a pair of 16 x 16 tiles with bf16 inputs, 36 pairs a block:
// 41 GFLOP of tensor-core work a call, 0.04 ms at 989 TFLOP/s.  But the
// mma.sync instructions, the ldmatrix loads that feed them and the
// elementwise work between (the decay, the masks, the splits) compete
// for the same issue slots and shared-memory bandwidth, so the design
// counts instructions as well as bytes.
//
// Precision: every product runs on mma.sync m16n8k16 bf16 with fp32
// accumulation.  An fp32 operand is split into hi + lo bf16 (|v - hi -
// lo| <= 2^-18 |v|): dY, dS, W, G and the chunk state's w_j B_j always,
// x, B and C with fp32 inputs; a product of two splits drops lo x lo, so
// each term keeps about 2^-17 of its size.  One bf16 rounding of dY or of
// W would cost up to 2^-9 of each term, beyond the card test's 1e-4 of
// max|ref| with fp32 inputs (tests/test_torch_ssd_scan.py models both on
// the CPU).  The decay runs on ex2.approx.ftz (2^-22; below 2^-126
// flushed to 0) and the chunk-state weights on expf.
//
// Masked entries: products are formed on whole 16 x 16 tiles, but the
// decay of an entry above the diagonal or past Q has the exponent -inf
// before ex2 (never exp of a positive exponent), so it contributes an
// exact 0; the staged rows past Q are zeros.
//
// Determinism: every sum is taken by one warp in a fixed order (the
// tensor core's, then xor shuffles over a quad, then the warps' totals in
// warp order); no atomics, so the same bits on every run.
//
// Design: one block of 4 warps per (b, c, h), 4096 blocks at the Jamba
// chunk, as the forward.  Each operand is staged once into shared memory
// as bf16 (bf16 inputs by cp.async in 16-byte pieces; fp32 ones through
// registers, split into hi and lo arrays), in rows that ldmatrix reads
// without bank conflicts (64-column rows with their 16-byte pieces
// swizzled by row, 16-column rows padded to 24): 68 KB a block with bf16
// inputs (three blocks an SM), 96 KB with fp32 (two).  The cumsum and the
// reverse cumsum are warp scans.  Warps own 16-row tiles of the triangle
// in balanced pairs (tile w and tile 7 - w, as the forward): 9 tile pairs
// each at Q 128 in both passes.
//   Row pass over i-tiles: for each j-tile j <= i, dW = dY_i x_j^T and
//     CB = C_i B_j^T in registers, then W and G; dcum's row term from the
//     accumulators; G split and repacked as the A fragment of dC_i += G B_j
//     (B_j by ldmatrix.trans).  dC_i is written when its row is done.
//   Column pass over j-tiles: for each i-tile i >= j, dW^T = x_j dY_i^T and
//     CB^T = B_j C_i^T (formed directly, not transposed), then W^T and G^T
//     split and repacked as A fragments of dx_j += W^T dY_i and dB_j +=
//     G^T C_i (dY and C by ldmatrix.trans); T_j from the accumulators.
//     Then the chunk state's terms on the same instructions: u = x_j dS^T,
//     dB_j += w_j u, B_j . u, and dx_j += (w_j B_j) dS.  dx_j and dB_j
//     are written when the column is done.
// Recomputing dW and CB in the second pass costs little on the tensor
// cores; staging W and G between the passes would not fit (4 x 32 KB as
// hi/lo bf16).  The x_j fragments of a column tile stay in registers
// across its i-tiles; with fp32 inputs (two blocks an SM) that holds
// their lo part too.
//
// At N 128 (Mamba2-130M: Q 128, 24 heads of 64, state 128, one group) the
// state-sized operands B, C and dS grow 8x: B and C rows are 128 wide
// (their 16 pieces swizzled by row within each 128-byte half), dB and dC
// hold 64 fp32 a thread, and the chunk state's u = x_j dS^T is formed 16
// columns at a time and spent at once (the same order of sums as a whole
// u).  Shared memory: 150,528 bytes with bf16 inputs and, with fp32 inputs,
// 232,448 bytes, exactly a block's limit: the staged layout above would
// be 528 bytes over, so exp(cum_last - cum_j) is recomputed by the thread
// that owns j at the end (the same expf, the same bits) rather than kept,
// and the 4 scan totals sit in arrays that are dead at each scan (T's
// before the column pass, dS's after it).  The other splits would cost
// more: halving N restages B and C and forms dW and W^T dY twice; staging
// the lo parts a pass at a time does not shrink the peak, which both
// passes need.  One block an SM at N 128 (4 warps); the launch bound asks
// for no more, so ptxas may give a thread 255 registers.
//
// Not yet: one block's loads overlap only another block's products (no
// ring inside a block), and the per-element work between the products
// (decay, mask, splits) is done twice, once a pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQ = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void *x, *Bm, *Cm;
  const float *dt, *da, *dy, *dS, *ddec;
  void *dx, *dB, *dC;
  float *ddt, *dda;
  int Q, H;
};

// A bf16 array of rows of W elements in shared memory.  64-column rows
// keep their 16-byte pieces swizzled by row (the 8 rows one ldmatrix
// phase reads at one column fall in 8 bank groups); 16-column rows are
// padded to 24 elements (48 bytes), which does the same.
// Rows of 128 elements swizzle each 128-byte half the same way.
template <int W>
struct Rows {
  static_assert(W == 16 || W == 64 || W == 128,
                "rows of 16, 64 or 128 elements");
  static constexpr int LD = W == 16 ? 24 : W;
  __host__ __device__ static constexpr int bytes(int rows) {
    return rows * LD * 2;
  }
  __device__ static __forceinline__ int off(int r, int c) {
    if constexpr (W != 16) {
      const int piece = c >> 3;
      return r * W + ((piece & ~7) << 3) + (((piece ^ r) & 7) << 3) + (c & 7);
    } else {
      return r * LD + c;
    }
  }
};

__device__ __forceinline__ unsigned saddr(const bf16* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The A fragment of m16n8k16: rows r0 .. r0 + 15, columns k0 .. k0 + 15 of
// a row-major array.
template <int W>
__device__ __forceinline__ void lda(unsigned (&a)[4], const bf16* s, int r0,
                                    int k0, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = k0 + (lane >> 4) * 8;
  ldsm_x4(a, saddr(s + Rows<W>::off(r, c)));
}

// B fragments of two n8 tiles (n0 .. n0 + 7: b[0], b[1]; n0 + 8 ..:
// b[2], b[3]) over k0 .. k0 + 15, from an array whose rows are n (k
// along the row).
template <int W>
__device__ __forceinline__ void ldb_n(unsigned (&b)[4], const bf16* s, int n0,
                                      int k0, int lane) {
  const int r = n0 + (lane & 7) + (lane >> 4) * 8;
  const int c = k0 + ((lane >> 3) & 1) * 8;
  ldsm_x4(b, saddr(s + Rows<W>::off(r, c)));
}

// The same two B fragments from an array whose rows are k (n along the
// row), by ldmatrix.trans.
template <int W>
__device__ __forceinline__ void ldb_k(unsigned (&b)[4], const bf16* s, int k0,
                                      int n0, int lane) {
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = n0 + (lane >> 4) * 8;
  ldsm_x4_trans(b, s + Rows<W>::off(r, c));
}

// c0 (n tile 0), c1 (n tile 1) += A B over one k16 step; A = ah (+ al),
// B = bh (+ bl), lo x lo dropped, the small terms first.
template <bool A_LO, bool B_LO>
__device__ __forceinline__ void mma2(float (&c0)[4], float (&c1)[4],
                                     const unsigned (&ah)[4],
                                     const unsigned (&al)[4],
                                     const unsigned (&bh)[4],
                                     const unsigned (&bl)[4]) {
  if constexpr (A_LO) {
    mma_bf16(c0, al, bh[0], bh[1]);
    mma_bf16(c1, al, bh[2], bh[3]);
  }
  if constexpr (B_LO) {
    mma_bf16(c0, ah, bl[0], bl[1]);
    mma_bf16(c1, ah, bl[2], bl[3]);
  }
  mma_bf16(c0, ah, bh[0], bh[1]);
  mma_bf16(c1, ah, bh[2], bh[3]);
}

// 2^x, max relative error 2^-22; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Inclusive prefix sum over the block's threads (thread t's v), in a
// fixed order: a warp scan, then the warps' totals in warp order.  tot:
// kWarps floats of shared memory; ends synced.
__device__ __forceinline__ float block_scan(float v, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) tot[warp] = v;
  __syncthreads();
  float before = 0.f;
  for (int w = 0; w < warp; ++w) before += tot[w];
  __syncthreads();
  return v + before;
}

// Rows [0, Qp) of a (.., Q, H, W) bf16 operand into its shared-memory
// rows by cp.async (16-byte pieces), zeros past Q.
template <int W>
__device__ void stage_bf16(bf16* dst, const bf16* __restrict__ src,
                           long long row0, long long sq, int Q, int Qp) {
  constexpr int CPR = W / 8;
  for (int e = threadIdx.x; e < Qp * CPR; e += kThreads) {
    const int q = e / CPR, c = (e % CPR) * 8;
    const bool ok = q < Q;
    cp_async16(dst + Rows<W>::off(q, c), ok ? src + row0 + q * sq + c : src,
               ok ? 16 : 0);
  }
}

// Rows [0, Qp) of an fp32 operand, split into hi and lo bf16 rows, zeros
// past Q; eight float4 loads a thread in flight before any is split.
template <int W>
__device__ void stage_split(bf16* hi, bf16* lo, const float* __restrict__ src,
                            long long row0, long long sq, int Q, int Qp) {
  constexpr int CPR = W / 4, kBatch = 8;
  const int n = Qp * CPR;
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads, q = e / CPR, c = (e % CPR) * 4;
      v[u] = e < n && q < Q
                 ? *reinterpret_cast<const float4*>(src + row0 + q * sq + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads, q = e / CPR, c = (e % CPR) * 4;
      if (e >= n) break;
      uint2 h, l;
      split_bf16x2(v[u].x, v[u].y, h.x, l.x);
      split_bf16x2(v[u].z, v[u].w, h.y, l.y);
      const int o = Rows<W>::off(q, c);
      *reinterpret_cast<uint2*>(hi + o) = h;
      *reinterpret_cast<uint2*>(lo + o) = l;
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Shared memory of a block: the operands' bf16 rows (lo parts of x, B, C
// only with fp32 inputs), then Qp floats each of cum, dt, wj, the row
// term of dcum (later dcum), T and B.u.  The kWarps scan totals of the
// cumsum take T's first floats (T is written by the column pass, later),
// those of the end's sums dS's rows (read by the column pass only).
template <int P, int N, bool F32>
struct Smem {
  bf16 *dyh, *dyl, *xh, *xl, *bh, *bl, *ch, *cl, *dsh, *dsl;
  float *cum, *dtv, *wj, *rowm, *colt, *dwj, *tot_first, *tot_last;
  __host__ __device__ static long long bytes(int Qp) {
    return (F32 ? 4LL : 3LL) * Rows<P>::bytes(Qp) +
           (F32 ? 4LL : 2LL) * Rows<N>::bytes(Qp) + 2LL * Rows<P>::bytes(N) +
           6LL * Qp * 4;
  }
  __device__ Smem(unsigned char* raw, int Qp) {
    bf16* p = reinterpret_cast<bf16*>(raw);
    const int rp = Rows<P>::bytes(Qp) / 2, rn = Rows<N>::bytes(Qp) / 2;
    dyh = p; p += rp;
    dyl = p; p += rp;
    xh = p; p += rp;
    xl = xh;
    if constexpr (F32) { xl = p; p += rp; }
    bh = p; p += rn;
    bl = bh;
    if constexpr (F32) { bl = p; p += rn; }
    ch = p; p += rn;
    cl = ch;
    if constexpr (F32) { cl = p; p += rn; }
    dsh = p; p += Rows<P>::bytes(N) / 2;
    dsl = p; p += Rows<P>::bytes(N) / 2;
    cum = reinterpret_cast<float*>(p);
    dtv = cum + Qp;
    wj = dtv + Qp;
    rowm = wj + Qp;
    colt = rowm + Qp;
    dwj = colt + Qp;
    tot_first = colt;
    tot_last = reinterpret_cast<float*>(dsh);
  }
};

template <typename T>
__device__ __forceinline__ float elem(const bf16* hi, const bf16* lo, int o) {
  if constexpr (std::is_same<T, float>::value)
    return __bfloat162float(hi[o]) + __bfloat162float(lo[o]);
  else
    return __bfloat162float(hi[o]);
}

// The row pass of i-tile it: dC_i (written), dcum's row term (rowm).
template <typename T, int P, int N>
__device__ void row_tile(const Smem<P, N, sizeof(T) == 4>& s, int it, int Q,
                         T* __restrict__ dC, long long sq) {
  constexpr bool F32 = sizeof(T) == 4;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tq = lane & 3;
  const int i0 = 16 * it, ia = i0 + gid, ib = ia + 8;
  const float cia = s.cum[ia], cib = s.cum[ib];
  // dY_i's A fragments (hi and lo) serve every j-tile of the row.
  unsigned yh[P / 16][4], yl[P / 16][4];
#pragma unroll
  for (int k = 0; k < P / 16; ++k) {
    lda<P>(yh[k], s.dyh, i0, 16 * k, lane);
    lda<P>(yl[k], s.dyl, i0, 16 * k, lane);
  }
  float dc[N / 8][4] = {};
  float rm[2] = {0.f, 0.f};
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = 16 * jt;
    float dw[2][4] = {}, cb[2][4] = {};
    unsigned bh[4], bl[4], ah[4], al[4];
#pragma unroll
    for (int k = 0; k < P / 16; ++k) {
      ldb_n<P>(bh, s.xh, j0, 16 * k, lane);
      if constexpr (F32) ldb_n<P>(bl, s.xl, j0, 16 * k, lane);
      mma2<true, F32>(dw[0], dw[1], yh[k], yl[k], bh, bl);
    }
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 16) {
      lda<N>(ah, s.ch, i0, k0, lane);
      ldb_n<N>(bh, s.bh, j0, k0, lane);
      if constexpr (F32) {
        lda<N>(al, s.cl, i0, k0, lane);
        ldb_n<N>(bl, s.bl, j0, k0, lane);
      }
      mma2<F32, F32>(cb[0], cb[1], ah, al, bh, bl);
    }
    // W and G; only a tile on the diagonal or past Q masks.
    const bool edge = jt == it || i0 + 16 > Q;
    unsigned gh[4], gl[4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int ja = j0 + 8 * u + 2 * tq, jb = ja + 1;
      const float2 cj = *reinterpret_cast<const float2*>(s.cum + ja);
      const float2 dj = *reinterpret_cast<const float2*>(s.dtv + ja);
      float e[4] = {cia - cj.x, cia - cj.y, cib - cj.x, cib - cj.y};
      if (edge) {
        const bool ra = ia < Q, rb = ib < Q;
        e[0] = ra && ja <= ia ? e[0] : -INFINITY;
        e[1] = ra && jb <= ia ? e[1] : -INFINITY;
        e[2] = rb && ja <= ib ? e[2] : -INFINITY;
        e[3] = rb && jb <= ib ? e[3] : -INFINITY;
      }
      float g[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float ld = ex2(e[v] * kLog2e) * ((v & 1) ? dj.y : dj.x);
        g[v] = dw[u][v] * ld;
        rm[v >> 1] = fmaf(dw[u][v], cb[u][v] * ld, rm[v >> 1]);
      }
      split_bf16x2(g[0], g[1], gh[2 * u], gl[2 * u]);
      split_bf16x2(g[2], g[3], gh[2 * u + 1], gl[2 * u + 1]);
    }
    // dC_i += G B_j.
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      ldb_k<N>(bh, s.bh, j0, n0, lane);
      if constexpr (F32) ldb_k<N>(bl, s.bl, j0, n0, lane);
      mma2<true, F32>(dc[n0 / 8], dc[n0 / 8 + 1], gh, gl, bh, bl);
    }
  }
  rm[0] = quad_sum(rm[0]);
  rm[1] = quad_sum(rm[1]);
  if (tq == 0) {
    s.rowm[ia] = rm[0];
    s.rowm[ib] = rm[1];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = h ? ib : ia;
    if (i >= Q) continue;
#pragma unroll
    for (int nf = 0; nf < N / 8; ++nf)
      store2(dC + i * sq + 8 * nf + 2 * tq, dc[nf][2 * h], dc[nf][2 * h + 1]);
  }
}

// The column pass of j-tile jt: dx_j and dB_j (written), T (colt) and
// B_j . u (dwj).
template <typename T, int P, int N>
__device__ void col_tile(const Smem<P, N, sizeof(T) == 4>& s, int jt, int nt,
                         int Q, T* __restrict__ dx, long long sqx,
                         T* __restrict__ dB, long long sqn) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int XP = F32 ? P / 16 : 1;         // x_j lo fragments held
  const int lane = threadIdx.x & 31, gid = lane >> 2, tq = lane & 3;
  const int j0 = 16 * jt, ja = j0 + gid, jb = ja + 8;
  const float cja = s.cum[ja], cjb = s.cum[jb];
  const float dja = s.dtv[ja], djb = s.dtv[jb];
  unsigned xh[P / 16][4], xl[XP][4];
#pragma unroll
  for (int k = 0; k < P / 16; ++k) {
    lda<P>(xh[k], s.xh, j0, 16 * k, lane);
    if constexpr (F32) lda<P>(xl[k], s.xl, j0, 16 * k, lane);
  }
  float dxa[P / 8][4] = {}, dba[N / 8][4] = {};
  float ct[2] = {0.f, 0.f};
  for (int it = jt; it < nt; ++it) {
    const int i0 = 16 * it;
    float dwt[2][4] = {}, cbt[2][4] = {};
    unsigned bh[4], bl[4], ah[4], al[4];
#pragma unroll
    for (int k = 0; k < P / 16; ++k) {
      ldb_n<P>(bh, s.dyh, i0, 16 * k, lane);
      ldb_n<P>(bl, s.dyl, i0, 16 * k, lane);
      mma2<F32, true>(dwt[0], dwt[1], xh[k], xl[F32 ? k : 0], bh, bl);
    }
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 16) {
      lda<N>(ah, s.bh, j0, k0, lane);
      ldb_n<N>(bh, s.ch, i0, k0, lane);
      if constexpr (F32) {
        lda<N>(al, s.bl, j0, k0, lane);
        ldb_n<N>(bl, s.cl, i0, k0, lane);
      }
      mma2<F32, F32>(cbt[0], cbt[1], ah, al, bh, bl);
    }
    // W^T and G^T: rows j, columns i = i0 + 8 u + 2 tq (+ 1).
    const bool edge = it == jt || i0 + 16 > Q;
    unsigned wh[4], wl[4], gh[4], gl[4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int ia = i0 + 8 * u + 2 * tq, ib = ia + 1;
      const float2 ci = *reinterpret_cast<const float2*>(s.cum + ia);
      float e[4] = {ci.x - cja, ci.y - cja, ci.x - cjb, ci.y - cjb};
      if (edge) {
        const bool va = ia < Q, vb = ib < Q;
        e[0] = va && ja <= ia ? e[0] : -INFINITY;
        e[1] = vb && ja <= ib ? e[1] : -INFINITY;
        e[2] = va && jb <= ia ? e[2] : -INFINITY;
        e[3] = vb && jb <= ib ? e[3] : -INFINITY;
      }
      float w[4], g[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float l = ex2(e[v] * kLog2e);
        const float d = (v >> 1) ? djb : dja;
        const float t = cbt[u][v] * l;
        ct[v >> 1] = fmaf(dwt[u][v], t, ct[v >> 1]);
        w[v] = t * d;
        g[v] = dwt[u][v] * l * d;
      }
      split_bf16x2(w[0], w[1], wh[2 * u], wl[2 * u]);
      split_bf16x2(w[2], w[3], wh[2 * u + 1], wl[2 * u + 1]);
      split_bf16x2(g[0], g[1], gh[2 * u], gl[2 * u]);
      split_bf16x2(g[2], g[3], gh[2 * u + 1], gl[2 * u + 1]);
    }
    // dx_j += W^T dY_i, dB_j += G^T C_i.
#pragma unroll
    for (int p0 = 0; p0 < P; p0 += 16) {
      ldb_k<P>(bh, s.dyh, i0, p0, lane);
      ldb_k<P>(bl, s.dyl, i0, p0, lane);
      mma2<true, true>(dxa[p0 / 8], dxa[p0 / 8 + 1], wh, wl, bh, bl);
    }
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      ldb_k<N>(bh, s.ch, i0, n0, lane);
      if constexpr (F32) ldb_k<N>(bl, s.cl, i0, n0, lane);
      mma2<true, F32>(dba[n0 / 8], dba[n0 / 8 + 1], gh, gl, bh, bl);
    }
  }
  // The chunk state's terms: u = x_j dS^T (rows j, columns n), 16
  // columns at a time, each spent on B_j . u and dB_j += w_j u at once.
  const float wja = s.wj[ja], wjb = s.wj[jb];
  float bu[2] = {0.f, 0.f};
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += 16) {
    float uacc[2][4] = {};
#pragma unroll
    for (int k = 0; k < P / 16; ++k) {
      unsigned sh[4], sl[4];
      ldb_n<P>(sh, s.dsh, n0, 16 * k, lane);
      ldb_n<P>(sl, s.dsl, n0, 16 * k, lane);
      mma2<F32, true>(uacc[0], uacc[1], xh[k], xl[F32 ? k : 0], sh, sl);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int nf = n0 / 8 + u;
        const int j = (v >> 1) ? jb : ja, n = 8 * nf + 2 * tq + (v & 1);
        const float b = elem<T>(s.bh, s.bl, Rows<N>::off(j, n));
        bu[v >> 1] = fmaf(b, uacc[u][v], bu[v >> 1]);
        dba[nf][v] = fmaf((v >> 1) ? wjb : wja, uacc[u][v], dba[nf][v]);
      }
  }
  // dx_j += (w_j B_j) dS: A fragment built from the staged B, split.
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 16) {
    unsigned ah[4], al[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = (r & 1) ? jb : ja, n = k0 + 8 * (r >> 1) + 2 * tq;
      const float w = (r & 1) ? wjb : wja;
      const int o = Rows<N>::off(j, n);
      split_bf16x2(w * elem<T>(s.bh, s.bl, o),
                   w * elem<T>(s.bh, s.bl, o + 1), ah[r], al[r]);
    }
#pragma unroll
    for (int p0 = 0; p0 < P; p0 += 16) {
      unsigned sh[4], sl[4];
      ldb_k<P>(sh, s.dsh, k0, p0, lane);
      ldb_k<P>(sl, s.dsl, k0, p0, lane);
      mma2<true, true>(dxa[p0 / 8], dxa[p0 / 8 + 1], ah, al, sh, sl);
    }
  }
  ct[0] = quad_sum(ct[0]);
  ct[1] = quad_sum(ct[1]);
  bu[0] = quad_sum(bu[0]);
  bu[1] = quad_sum(bu[1]);
  if (tq == 0) {
    s.colt[ja] = ct[0];
    s.colt[jb] = ct[1];
    s.dwj[ja] = bu[0];
    s.dwj[jb] = bu[1];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = h ? jb : ja;
    if (j >= Q) continue;
#pragma unroll
    for (int pf = 0; pf < P / 8; ++pf)
      store2(dx + j * sqx + 8 * pf + 2 * tq, dxa[pf][2 * h],
             dxa[pf][2 * h + 1]);
#pragma unroll
    for (int nf = 0; nf < N / 8; ++nf)
      store2(dB + j * sqn + 8 * nf + 2 * tq, dba[nf][2 * h],
             dba[nf][2 * h + 1]);
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads,
                                  N == 128 ? 1 : (sizeof(T) == 4 ? 2 : 3))
ssd_bwd_kernel(const Args a) {
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Q = a.Q, H = a.H, Qp = (Q + 15) / 16 * 16, nt = Qp / 16;
  const Smem<P, N, F32> s(smem_raw, Qp);
  const int h = static_cast<int>(blockIdx.x % H);
  const long long blk = blockIdx.x / H;         // b * nc + c
  const int t = threadIdx.x, warp = t >> 5;

  // ---- stage every operand once; dt and da beside.
  const long long rx = (blk * Q * H + h) * P, rn = (blk * Q * H + h) * N;
  const long long sqx = static_cast<long long>(H) * P;
  const long long sqn = static_cast<long long>(H) * N;
  if constexpr (F32) {
    stage_split<P>(s.xh, s.xl, static_cast<const float*>(a.x), rx, sqx, Q,
                   Qp);
    stage_split<N>(s.bh, s.bl, static_cast<const float*>(a.Bm), rn, sqn, Q,
                   Qp);
    stage_split<N>(s.ch, s.cl, static_cast<const float*>(a.Cm), rn, sqn, Q,
                   Qp);
  } else {
    stage_bf16<P>(s.xh, static_cast<const bf16*>(a.x), rx, sqx, Q, Qp);
    stage_bf16<N>(s.bh, static_cast<const bf16*>(a.Bm), rn, sqn, Q, Qp);
    stage_bf16<N>(s.ch, static_cast<const bf16*>(a.Cm), rn, sqn, Q, Qp);
    cp_async_commit();
  }
  const long long at = (blk * Q + t) * H + h;
  const float dt_t = t < Q ? a.dt[at] : 0.f;
  const float da_t = t < Q ? a.da[at] : 0.f;
  stage_split<P>(s.dyh, s.dyl, a.dy, rx, sqx, Q, Qp);
  stage_split<P>(s.dsh, s.dsl, a.dS, (blk * H + h) * N * P, P, N, N);

  // ---- cum = cumsum(da) (Q <= kThreads); decays of the chunk state.
  const float cum_t = block_scan(da_t, s.tot_first);
  if (t < Qp) {
    s.cum[t] = t < Q ? cum_t : 0.f;
    s.dtv[t] = dt_t;
  }
  __syncthreads();
  const float last = s.cum[Q - 1];
  const float ej_t = t < Q ? expf(last - cum_t) : 0.f;
  if (t < Qp) s.wj[t] = ej_t * dt_t;
  if constexpr (!F32) cp_async_wait<0>();
  __syncthreads();

  // ---- the two passes: tiles (w, 2 kWarps - 1 - w) of each 8.
  const long long row_q = blk * Q * H + h;     // row 0 of this block
  T* dxg = static_cast<T*>(a.dx) + row_q * P;
  T* dBg = static_cast<T*>(a.dB) + row_q * N;
  T* dCg = static_cast<T*>(a.dC) + row_q * N;
  for (int base = 0; base < nt; base += 2 * kWarps)
    for (int half = 0; half < 2; ++half) {
      const int tile = base + (half ? 2 * kWarps - 1 - warp : warp);
      if (tile < nt) row_tile<T, P, N>(s, tile, Q, dCg, sqn);
    }
  for (int base = 0; base < nt; base += 2 * kWarps)
    for (int half = 0; half < 2; ++half) {
      const int tile = base + (half ? 2 * kWarps - 1 - warp : warp);
      if (tile < nt) col_tile<T, P, N>(s, tile, nt, Q, dxg, sqx, dBg, sqn);
    }
  __syncthreads();

  // ---- ddt, dcum and its reverse cumsum.
  float dcum = 0.f, r = 0.f;
  if (t < Q) {
    const float bu = s.dwj[t], col = s.colt[t];
    a.ddt[at] = fmaf(bu, ej_t, col);
    r = bu * s.wj[t];
    dcum = s.rowm[t] - dt_t * col - r;
  }
  // sum_j (B_j . u_j) wj: a warp's xor sum, then the warps in order.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  if ((t & 31) == 0) s.tot_last[warp] = r;
  __syncthreads();
  if (t == Q - 1) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += s.tot_last[w];
    dcum += sum + a.ddec[blk * H + h] * expf(last);
  }
  if (t < Qp) s.rowm[t] = dcum;
  __syncthreads();
  // Thread t takes position Q - 1 - t: an inclusive scan from the end.
  const float rev = block_scan(t < Q ? s.rowm[Q - 1 - t] : 0.f, s.tot_last);
  if (t < Q) a.dda[(blk * Q + (Q - 1 - t)) * H + h] = rev;
}

template <typename T, int P, int N>
int launch(const Args& a, long long blocks, cudaStream_t st) {
  const int Qp = (a.Q + 15) / 16 * 16;
  const long long smem = Smem<P, N, sizeof(T) == 4>::bytes(Qp);
  auto kernel = ssd_bwd_kernel<T, P, N>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // All of the SM's unified memory as shared memory: three bf16 blocks
  // (two fp32; one at N 128) fit only so.
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem),
           st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype 0: fp32 x, B, C; 1: bf16.
// Every tensor contiguous (shapes above).  Returns 0 when launched, else a
// CUDA error code (cudaErrorInvalidValue for a shape the kernel does not
// take: Q above 128 or (P, N) other than (64, 16), (64, 128) and
// (16, 16)).
extern "C" int ssd_intra_chunk_bwd_launch(
    int dtype, const void* x, const void* Bm, const void* Cm, const void* dt,
    const void* da, const void* dy, const void* dS, const void* ddec,
    void* dx, void* dB, void* dC, void* ddt, void* dda, int B, int nc, int Q,
    int H, int P, int N, void* stream) {
  if (B < 1 || nc < 1 || Q < 1 || Q > kMaxQ || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x; a.Bm = Bm; a.Cm = Cm;
  a.dt = static_cast<const float*>(dt);
  a.da = static_cast<const float*>(da);
  a.dy = static_cast<const float*>(dy);
  a.dS = static_cast<const float*>(dS);
  a.ddec = static_cast<const float*>(ddec);
  a.dx = dx; a.dB = dB; a.dC = dC;
  a.ddt = static_cast<float*>(ddt);
  a.dda = static_cast<float*>(dda);
  a.Q = Q; a.H = H;
  const long long blocks = static_cast<long long>(B) * nc * H;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 16)
    return dtype == 1 ? launch<bf16, 64, 16>(a, blocks, s)
                      : launch<float, 64, 16>(a, blocks, s);
  if (P == 64 && N == 128)
    return dtype == 1 ? launch<bf16, 64, 128>(a, blocks, s)
                      : launch<float, 64, 128>(a, blocks, s);
  if (P == 16 && N == 16)
    return dtype == 1 ? launch<bf16, 16, 16>(a, blocks, s)
                      : launch<float, 16, 16>(a, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
