// SSD intra-chunk kernel for Hopper (sm_90a): the quadratic (within-chunk)
// term and the chunk states of the Mamba-2 state-space-duality scan.
//
// Replaces the Pallas kernel repro/kernels/ssd_scan/kernel.py
// ssd_intra_chunk_pallas.  For each (batch b, chunk c, head h), with
// cum = cumsum(da) over the Q positions of the chunk:
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (Q x P)
//   S     = sum_j exp(cum_last - cum_j) dt_j B_j^T x_j             (N x P)
//   decay = exp(cum_last)
// x (B, nc, Q, H, P), B/C (B, nc, Q, H, N) in fp32 or bf16, dt/da
// (B, nc, Q, H) fp32, any strides with a unit-stride last dim; outputs y
// (B, nc, Q, H, P), S (B, nc, H, N, P) and decay (B, nc, H), contiguous
// fp32.
//
// Precision: not fp32 arithmetic.  The split bf16 products below keep each
// term of W x and of the chunk state, and with fp32 inputs of C . B, to
// about 2^-17 of its size (fp32 keeps 2^-24), and the decay inside W runs
// on ex2.approx.ftz (2^-22; results below 2^-126 flush to 0).  At the Jamba
// chunk on an H100 the largest error is 4.7e-6 of max|ref| with bf16
// inputs and 9.0e-6 with fp32 inputs, against 2.5e-6 and 1.9e-6 for the
// CUDA-core fp32 kernel this one replaced (chip_smoke.py, phase 2): within
// the 3e-4 tolerance, but with fp32 inputs 4.7x the error of fp32
// arithmetic, between bf16 and fp32.
//
// What bounds it on an H100: bytes.  At the Jamba-v0.1 prefill chunk (B 1,
// nc 32, Q 128, H 128, P 64, N 16) the fp32 y alone is 134 MB; with the
// inputs 0.25 GB in bf16 (0.076 ms at 3.35 TB/s; 0.36 GB, 0.106 ms, with
// fp32 inputs).  The causal triangle's 6.6 GFLOP bound the first version
// on the CUDA cores (0.098 ms at 67 TFLOP/s; it took 0.72 ms, with one
// 119 KB block an SM and its phases in strict turn).  On the tensor cores
// they take a few microseconds, but the mma.sync instructions that carry
// them, and the work that feeds each, still compete with the loads, so
// the design counts instructions as well as bytes.
//
// Design: one block of 4 warps per (b, c, h), 4096 blocks at the Jamba
// chunk.  x is staged as bf16 (bf16 inputs: by cp.async in 16-byte pieces;
// fp32 inputs: split once into hi + lo bf16 arrays, |x - hi - lo| <=
// 2^-18 |x|), in rows whose 16-byte pieces are swizzled by row so that
// ldmatrix.trans reads them without bank conflicts; B and C in their dtype
// (element loads where a stride or the base is not 16-byte aligned).  29
// KB a block in bf16 at the Jamba shape, 54 KB in fp32: several blocks
// share an SM, so one block's loads overlap another's products.  The
// weight matrix W is never staged: each warp owns pairs of 16-row tiles
// (tile w and tile 2 * 4 - 1 - w of each group of 8, so the causal
// triangle's work is even across warps), and for each 16-column step j of
// its triangle it computes C_i . B_j on mma.sync m16n8k16 bf16 (bf16
// inputs: one exact product with fp32 accumulation, C's fragments held in
// registers across the tile; fp32 inputs: B and C split into hi + lo bf16,
// three products), applies exp(cum_i - cum_j) dt_j and the causal mask to
// the accumulator in registers (only tiles on the diagonal or past Q mask,
// and a masked entry's exponent is -inf before exp, so exp never
// overflows), splits W into hi + lo bf16 (|W - hi - lo| <= 2^-18 |W|) and
// repacks the two 16 x 8 accumulators as the A fragment of W x, as the
// flash kernels repack P.  W x is then W_hi x + W_lo x (fp32 inputs:
// + W_hi x_lo) on m16n8k16 with x's fragments from ldmatrix.trans; the
// chunk state the same way, its A operand (B_j wj, n by j) built from the
// staged B.  One rounding of W to bf16 or to TF32 costs up to 2^-9 or
// 2^-11 of each term, which breaks the 3e-4 tolerance; the split, 2^-18.
// A bf16 k16 product is one instruction where TF32 needs two k8 ones, so
// split bf16 takes half the mma.sync instructions of split TF32 (2 vs 4
// per 16 keys and 8 columns of x with bf16 inputs, 3 vs 6 with fp32).
//
// Not yet: folding the cross-chunk recurrence and the inter-chunk term
// into the kernel (ssd_chunk_scan's plain part now costs more than this
// kernel), and overlapping one (b, c, h)'s loads with the previous one's
// products inside a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPBlock = 64;          // y columns per accumulator block
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

struct Strides {   // element strides of the (b, c, q, h) dimensions
  long long b, c, q, h;
  __device__ long long at(int bb, int cc, int hh) const {
    return bb * b + cc * c + hh * h;
  }
};

struct Dims {
  int nc, Q, H, P, N;
  int Qp;          // Q rounded up to 16 (row tiles, k steps over j)
  int Pp;          // P rounded up to 8 (n tiles of the products)
  int Np;          // N rounded up to 16 (k steps of C . B)
  int ldx;         // row stride of x in shared memory: Pp rounded to 64
  int ldbc;        // row stride of B / C in shared memory, elements
  int xparts;      // 1 (bf16 x) or 2 (fp32 x as hi + lo)
};

template <typename T>
__host__ __device__ inline Dims make_dims(int nc, int Q, int H, int P,
                                          int N) {
  Dims d;
  d.nc = nc; d.Q = Q; d.H = H; d.P = P; d.N = N;
  d.Qp = round_up(Q, 16);
  d.Pp = round_up(P, 8);
  d.Np = round_up(N, 16);
  d.ldx = round_up(d.Pp, 64);
  // Rows 16 bytes longer than N: the fragment reads of a warp (rows gid,
  // columns 2 tq) hit distinct banks, and each row starts on 16 bytes.
  d.ldbc = d.Np + 16 / (int)sizeof(T);
  d.xparts = sizeof(T) == 2 ? 1 : 2;
  return d;
}

// Shared memory in bytes: x (xparts x Qp x ldx bf16) | B | C (Qp x ldbc
// in T each) | cum, dt, wj (Qp floats each) | the warps' scan totals.
template <typename T>
__host__ __device__ inline long long smem_bytes(const Dims& d) {
  return (long long)d.xparts * d.Qp * d.ldx * 2 +
         2LL * d.Qp * d.ldbc * sizeof(T) + (3LL * d.Qp + kWarps) * 4;
}

// Offset of x's element (row r, column c): the 16-byte pieces of a row are
// swizzled within each group of 8 by r & 7, so the 8 rows an ldmatrix
// phase reads at one column fall in 8 distinct bank groups.
__device__ __forceinline__ int xoff(int r, int c, int ldx) {
  const int piece = c >> 3;
  return r * ldx + (((piece & ~7) | ((piece ^ r) & 7)) << 3) + (c & 7);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// 2^x, max relative error 2^-22; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// C's A fragments for rows ia, ia + 8 and the 16 columns k0 .. k0 + 15,
// and g += C . B_j over them for row jr = j0 + gid of B: bf16 as one exact
// product, fp32 as hi + lo splits of both in three products.
template <typename T>
struct CFrag;

template <>
struct CFrag<bf16> {
  unsigned a[4];
  __device__ __forceinline__ void load(const bf16* cs, int ia, int ld,
                                       int k0, int tq) {
    const bf16* ca = cs + ia * ld + k0 + 2 * tq;
    a[0] = lds32(ca);
    a[1] = lds32(ca + 8 * ld);
    a[2] = lds32(ca + 8);
    a[3] = lds32(ca + 8 * ld + 8);
  }
  __device__ __forceinline__ void mma(float (&g)[4], const bf16* bs, int jr,
                                      int ld, int k0, int tq) const {
    const bf16* bb = bs + jr * ld + k0 + 2 * tq;
    mma_bf16(g, a, lds32(bb), lds32(bb + 8));
  }
};

template <>
struct CFrag<float> {
  unsigned h[4], l[4];
  __device__ __forceinline__ void load(const float* cs, int ia, int ld,
                                       int k0, int tq) {
    const float* ca = cs + ia * ld + k0 + 2 * tq;
    const int off[4] = {0, 8 * ld, 8, 8 * ld + 8};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 v = *reinterpret_cast<const float2*>(ca + off[u]);
      split_bf16x2(v.x, v.y, h[u], l[u]);
    }
  }
  __device__ __forceinline__ void mma(float (&g)[4], const float* bs, int jr,
                                      int ld, int k0, int tq) const {
    const float* bb = bs + jr * ld + k0 + 2 * tq;
    const float2 v0 = *reinterpret_cast<const float2*>(bb);
    const float2 v1 = *reinterpret_cast<const float2*>(bb + 8);
    unsigned bh0, bl0, bh1, bl1;
    split_bf16x2(v0.x, v0.y, bh0, bl0);
    split_bf16x2(v1.x, v1.y, bh1, bl1);
    mma_bf16(g, l, bh0, bh1);
    mma_bf16(g, h, bl0, bl1);
    mma_bf16(g, h, bh0, bh1);
  }
};

// acc += W x for the 16 x 16 A fragment (wh, wl) of W and the x rows
// j0 .. j0 + 15, columns p0 .. p0 + 8 ntl - 1 (ntl <= NT): W_hi x +
// W_lo x (XPARTS 2, fp32 inputs: x = x_hi + x_lo, and + W_hi x_lo).
template <int XPARTS, int NT>
__device__ __forceinline__ void wx(float (&acc)[NT][4],
                                   const unsigned (&wh)[4],
                                   const unsigned (&wl)[4], const bf16* xs,
                                   int xpart, int ldx, int j0, int p0,
                                   int ntl, int lane) {
  const int jr = j0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    if (2 * np >= ntl) break;
    const int pc = p0 + 16 * np + (lane >> 4) * 8;
    const bool two = 2 * np + 1 < ntl;
    unsigned xb[4];
    ldsm_x4_trans(xb, xs + xoff(jr, pc, ldx));
    mma_bf16(acc[2 * np], wl, xb[0], xb[1]);
    mma_bf16(acc[2 * np], wh, xb[0], xb[1]);
    if (two) {
      mma_bf16(acc[2 * np + 1], wl, xb[2], xb[3]);
      mma_bf16(acc[2 * np + 1], wh, xb[2], xb[3]);
    }
    if constexpr (XPARTS == 2) {
      ldsm_x4_trans(xb, xs + xpart + xoff(jr, pc, ldx));
      mma_bf16(acc[2 * np], wh, xb[0], xb[1]);
      if (two) mma_bf16(acc[2 * np + 1], wh, xb[2], xb[3]);
    }
  }
}

// f(q, c) for the pieces e = threadIdx.x + k kThreads < Qp cpr of a
// (row q, piece c) grid, (q, c) = (e / cpr, e % cpr) stepped without a
// division per piece.
template <typename F>
__device__ __forceinline__ void for_pieces(int Qp, int cpr, F&& f) {
  const int dq = kThreads / cpr, dc = kThreads % cpr;
  int q = threadIdx.x / cpr, c = threadIdx.x % cpr;
  for (; q < Qp; q += dq, c += dc) {
    if (c >= cpr) {
      c -= cpr;
      ++q;
      if (q >= Qp) break;
    }
    f(q, c);
  }
}

// Rows [0, Qp) x columns [0, cols_p) of B or C into shared memory (row
// stride ld), zero past Q and past cols.  vec: 16-byte cp.async pieces
// (aligned base and strides, cols a multiple of the piece); otherwise
// element loads.
template <typename T>
__device__ void stage_bc(T* dst, int ld, const T* __restrict__ src,
                         long long base, long long sq, int Q, int Qp, int cols,
                         int cols_p, bool vec) {
  constexpr int CH = 16 / sizeof(T);
  if (vec) {
    for_pieces(Qp, cols_p / CH, [&](int q, int c) {
      const bool ok = q < Q && c * CH < cols;
      cp_async16(dst + q * ld + c * CH, ok ? src + base + q * sq + c * CH : src,
                 ok ? 16 : 0);
    });
  } else {
    for (int e = threadIdx.x; e < Qp * cols_p; e += kThreads) {
      const int q = e / cols_p, c = e - q * cols_p;
      dst[q * ld + c] = q < Q && c < cols ? src[base + q * sq + c] : T(0.f);
    }
  }
}

// x rows [0, Qp) x columns [0, Pp) into its swizzled bf16 layout, zero
// past Q and past P.  bf16: 16-byte cp.async pieces (vec) or element
// loads.  fp32: four elements at a time through registers, split into the
// hi part (xs) and the lo part (xs + xpart).
template <typename T>
__device__ void stage_x(bf16* xs, int xpart, const Dims& d,
                        const T* __restrict__ src, long long base,
                        long long sq, bool vec) {
  const int Q = d.Q, Qp = d.Qp, P = d.P;
  if constexpr (std::is_same<T, bf16>::value) {
    if (vec) {
      for_pieces(Qp, d.Pp / 8, [&](int q, int c) {
        const bool ok = q < Q;
        cp_async16(xs + xoff(q, 8 * c, d.ldx),
                   ok ? src + base + q * sq + 8 * c : src, ok ? 16 : 0);
      });
    } else {
      for (int e = threadIdx.x; e < Qp * d.Pp; e += kThreads) {
        const int q = e / d.Pp, c = e - q * d.Pp;
        xs[xoff(q, c, d.ldx)] =
            q < Q && c < P ? src[base + q * sq + c] : bf16(0.f);
      }
    }
  } else {
    // Sixteen loads in flight per thread before any is used (all of x at
    // the Jamba shape).
    constexpr int kBatch = 16;
    const int cpr = d.Pp / 4, n = Qp * cpr;
    const int shift = (cpr & (cpr - 1)) == 0 ? __ffs(cpr) - 1 : -1;
    for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
      float4 v[kBatch];
      int qs[kBatch], cs[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        const int q = shift >= 0 ? e >> shift : e / cpr;
        const int c = 4 * (e - q * cpr);
        qs[u] = q;
        cs[u] = c;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < n && q < Q) {
          const float* row = src + base + q * sq;
          if (vec && c + 4 <= P) {
            v[u] = *reinterpret_cast<const float4*>(row + c);
          } else {
            v[u].x = c < P ? row[c] : 0.f;
            v[u].y = c + 1 < P ? row[c + 1] : 0.f;
            v[u].z = c + 2 < P ? row[c + 2] : 0.f;
            v[u].w = c + 3 < P ? row[c + 3] : 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int q = qs[u], c = cs[u];
        if (e0 + u * kThreads >= n) break;
        uint2 hi, lo;
        split_bf16x2(v[u].x, v[u].y, hi.x, lo.x);
        split_bf16x2(v[u].z, v[u].w, hi.y, lo.y);
        const int o = xoff(q, c, d.ldx);
        *reinterpret_cast<uint2*>(xs + o) = hi;
        *reinterpret_cast<uint2*>(xs + xpart + o) = lo;
      }
    }
  }
}

// Inclusive prefix sum of da over the Q positions into cum (fp32); cum is
// 0 from Q to Qp.  first: this thread's da of the first kThreads
// positions, loaded by the caller.
__device__ void block_cumsum(const float* __restrict__ da, long long base,
                             long long stride, int Q, int Qp, float first,
                             float* cum, float* tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float carry = 0.0f;
  for (int q0 = 0; q0 < Qp; q0 += kThreads) {
    const int q = q0 + threadIdx.x;
    float v = q0 == 0 ? first : q < Q ? da[base + q * stride] : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float t = lane < kWarps ? tot[lane] : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, t, off);
        if (lane >= off) t += u;
      }
      if (lane < kWarps) tot[lane] = t;
    }
    __syncthreads();
    if (q < Qp) cum[q] = q < Q ? v + carry + (warp > 0 ? tot[warp - 1] : 0.0f)
                               : 0.0f;
    carry += tot[kWarps - 1];
    __syncthreads();
  }
}

// One 16-row tile of y: rows i0 .. i0 + 15, columns p0 .. p0 + 8 ntl - 1.
// ONE_K: N fits one 16-wide k step, whose C fragments stay in registers
// across the tile.
template <typename T, bool ONE_K>
__device__ void y_tile(const Dims& d, int i0, int p0, int ntl,
                       const bf16* xs, int xpart, const T* bs, const T* cs,
                       const float* cum, const float* dtv,
                       float* __restrict__ yg) {
  const int lane = threadIdx.x & 31, gid = lane / 4, tq = lane % 4;
  const int Q = d.Q, ldbc = d.ldbc;
  const int ia = i0 + gid, ib = ia + 8;
  const float cia = cum[ia], cib = cum[ib];
  float acc[kPBlock / 8][4];
#pragma unroll
  for (int nf = 0; nf < kPBlock / 8; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nf][e] = 0.f;

  CFrag<T> cf;
  if constexpr (ONE_K) cf.load(cs, ia, ldbc, 0, tq);
  for (int j0 = 0; j0 <= i0; j0 += 16) {   // j <= i0 + 15
    // G = C_i . B_j for the two 16 x 8 tiles of keys j0 + 8 u + (0 .. 7);
    // this thread holds keys j0 + 8 u + 2 tq and + 1.
    float g[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if constexpr (ONE_K) {
        cf.mma(g[u], bs, j0 + 8 * u + gid, ldbc, 0, tq);
      } else {
        for (int k0 = 0; k0 < d.Np; k0 += 16) {
          CFrag<T> ck;
          ck.load(cs, ia, ldbc, k0, tq);
          ck.mma(g[u], bs, j0 + 8 * u + gid, ldbc, k0, tq);
        }
      }
    }
    // W = G exp(cum_i - cum_j) dt_j for j <= i < Q.  Only a tile on the
    // diagonal or past Q masks, and there the exponent of a masked entry
    // is -inf, so exp never sees a positive overflow.
    const bool edge = j0 + 16 > i0 || i0 + 16 > Q;
    unsigned wh[4], wl[4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int ja = j0 + 8 * u + 2 * tq, jb = ja + 1;
      const float2 cj = *reinterpret_cast<const float2*>(cum + ja);
      const float2 dj = *reinterpret_cast<const float2*>(dtv + ja);
      float e[4] = {cia - cj.x, cia - cj.y, cib - cj.x, cib - cj.y};
      if (edge) {
        const bool ra = ia < Q, rb = ib < Q;
        e[0] = ra && ja <= ia ? e[0] : -INFINITY;
        e[1] = ra && jb <= ia ? e[1] : -INFINITY;
        e[2] = rb && ja <= ib ? e[2] : -INFINITY;
        e[3] = rb && jb <= ib ? e[3] : -INFINITY;
      }
      const float w0 = g[u][0] * ex2(e[0] * kLog2e) * dj.x;
      const float w1 = g[u][1] * ex2(e[1] * kLog2e) * dj.y;
      const float w2 = g[u][2] * ex2(e[2] * kLog2e) * dj.x;
      const float w3 = g[u][3] * ex2(e[3] * kLog2e) * dj.y;
      // The two accumulators are the A fragment of W x: rows ia / ib,
      // keys 2 tq and 2 tq + 1 of the first 8 (u = 0) and of the next 8.
      split_bf16x2(w0, w1, wh[2 * u], wl[2 * u]);
      split_bf16x2(w2, w3, wh[2 * u + 1], wl[2 * u + 1]);
    }
    wx<sizeof(T) == 2 ? 1 : 2, kPBlock / 8>(acc, wh, wl, xs, xpart, d.ldx,
                                            j0, p0, ntl, lane);
  }
  const bool pairs = (d.P & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = half ? ib : ia;
    if (i >= Q) continue;
    float* dst = yg + (long long)i * d.H * d.P;
#pragma unroll
    for (int nf = 0; nf < kPBlock / 8; ++nf) {
      const int p = p0 + nf * 8 + 2 * tq;
      if (nf >= ntl || p >= d.P) continue;
      const float v0 = acc[nf][2 * half], v1 = acc[nf][2 * half + 1];
      if (pairs) {
        *reinterpret_cast<float2*>(dst + p) = make_float2(v0, v1);
      } else {
        dst[p] = v0;
        if (p + 1 < d.P) dst[p + 1] = v1;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 6 : 4)
ssd_intra_chunk_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                       const T* __restrict__ cm, const float* __restrict__ dt,
                       const float* __restrict__ da, float* __restrict__ y,
                       float* __restrict__ s_out, float* __restrict__ dec,
                       Dims d, Strides sx, Strides sb, Strides sc,
                       Strides sdt, Strides sda, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  const int xpart = d.Qp * d.ldx;              // offset of x's lo part
  T* bs = reinterpret_cast<T*>(xs + d.xparts * xpart);
  T* cs = bs + d.Qp * d.ldbc;
  float* cum = reinterpret_cast<float*>(cs + d.Qp * d.ldbc);
  float* dtv = cum + d.Qp;
  float* wj = dtv + d.Qp;
  float* tot = wj + d.Qp;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane / 4, tq = lane % 4;
  const int Q = d.Q, Qp = d.Qp, ldbc = d.ldbc;

  // ---- stage B, C and x: the cp.async pieces, this thread's first dt
  // and da and (fp32) the register-staged x loads are all in flight at
  // once, so a block waits for the memory's latency about once.
  stage_bc(bs, ldbc, bm, sb.at(b, c, h), sb.q, Q, Qp, d.N, d.Np, vec);
  stage_bc(cs, ldbc, cm, sc.at(b, c, h), sc.q, Q, Qp, d.N, d.Np, vec);
  const long long dto = sdt.at(b, c, h), dao = sda.at(b, c, h);
  const float dt_first = tid < Q ? dt[dto + tid * sdt.q] : 0.0f;
  const float da_first = tid < Q ? da[dao + tid * sda.q] : 0.0f;
  stage_x(xs, xpart, d, x, sx.at(b, c, h), sx.q, vec);
  cp_async_commit();
  for (int q = tid; q < Qp; q += kThreads)
    dtv[q] = q == tid ? dt_first : q < Q ? dt[dto + q * sdt.q] : 0.0f;

  // ---- cum = cumsum(da); chunk-state weights and the chunk decay
  block_cumsum(da, dao, sda.q, Q, Qp, da_first, cum, tot);  // ends synced
  const float last = cum[Q - 1];
  for (int q = tid; q < Qp; q += kThreads)
    wj[q] = q < Q ? expf(last - cum[q]) * dtv[q] : 0.0f;
  const long long bch = ((long long)b * d.nc + c) * d.H + h;
  if (tid == 0) dec[bch] = expf(last);
  cp_async_wait<0>();
  __syncthreads();

  // ---- y: pairs of 16-row tiles per warp, (w, 2 kWarps - 1 - w) of each
  // group of 2 kWarps tiles, so the triangle's work is even.
  const int nt = Qp / 16;
  float* yb = y + (((long long)b * d.nc + c) * Q * d.H + h) * d.P;
  for (int base = 0; base < nt; base += 2 * kWarps) {
    for (int half = 0; half < 2; ++half) {
      const int rt = base + (half ? 2 * kWarps - 1 - warp : warp);
      if (rt >= nt) continue;
      for (int p0 = 0; p0 < d.Pp; p0 += kPBlock) {
        const int ntl = min(kPBlock, d.Pp - p0) / 8;
        if (d.Np == 16)
          y_tile<T, true>(d, rt * 16, p0, ntl, xs, xpart, bs, cs, cum, dtv,
                          yb);
        else
          y_tile<T, false>(d, rt * 16, p0, ntl, xs, xpart, bs, cs, cum, dtv,
                           yb);
      }
    }
  }

  // ---- S = sum_j (B_j wj)^T x_j: items of 16 n x 16 p, one a warp at
  // the Jamba shape; the A fragment (n by j) is B_j wj split into hi + lo
  // bf16.
  const int n_pp = d.Pp / 8 / 2 + (d.Pp / 8) % 2;
  const int n_items = (d.Np / 16) * n_pp;
  float* sbase = s_out + bch * d.N * d.P;
  for (int it = warp; it < n_items; it += kWarps) {
    const int n0 = (it / n_pp) * 16, p0 = (it % n_pp) * 16;
    const int ntl = min(16, d.Pp - p0) / 8;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int j0 = 0; j0 < Qp; j0 += 16) {
      unsigned ah[4], al[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int ja = j0 + 8 * u + 2 * tq;
        const float2 w = *reinterpret_cast<const float2*>(wj + ja);
        const T* br = bs + ja * ldbc + n0 + gid;
        split_bf16x2(to_f32(br[0]) * w.x, to_f32(br[ldbc]) * w.y,
                     ah[2 * u], al[2 * u]);
        split_bf16x2(to_f32(br[8]) * w.x, to_f32(br[ldbc + 8]) * w.y,
                     ah[2 * u + 1], al[2 * u + 1]);
      }
      wx<sizeof(T) == 2 ? 1 : 2, 2>(acc, ah, al, xs, xpart, d.ldx, j0, p0,
                                    ntl, lane);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + gid + 8 * half;
      if (n >= d.N) continue;
#pragma unroll
      for (int nf = 0; nf < 2; ++nf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = p0 + nf * 8 + 2 * tq + e;
          if (nf < ntl && p < d.P) sbase[n * d.P + p] = acc[nf][2 * half + e];
        }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* bm, const void* cm,
                   const float* dt, const float* da, float* y, float* s,
                   float* dec, int B, const Dims& d, const Strides& sx,
                   const Strides& sb, const Strides& sc, const Strides& sdt,
                   const Strides& sda, cudaStream_t stream) {
  const long long bytes = smem_bytes<T>(d);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (bytes > optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(ssd_intra_chunk_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  // All of the SM's unified memory as shared memory: four fp32 blocks
  // (54 KB each at the Jamba shape) fit only so.
  err = cudaFuncSetAttribute(ssd_intra_chunk_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  // 16-byte pieces (cp.async, float4) need aligned bases, strides and
  // widths.
  constexpr long long CH = 16 / sizeof(T);
  bool vec = d.P % CH == 0 && d.N % CH == 0;
  for (const void* p : {x, bm, cm})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (const Strides* st : {&sx, &sb, &sc})
    vec = vec && st->b % CH == 0 && st->c % CH == 0 && st->q % CH == 0 &&
          st->h % CH == 0;
  const dim3 grid(d.H, d.nc, B);
  ssd_intra_chunk_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), dt, da, y, s, dec, d, sx, sb, sc, sdt, sda,
      vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs (dtype: 0 = fp32, 1 = bf16); the
// wrapper reports it when a launch fails.
long long ssd_intra_chunk_smem_bytes(int dtype, int Q, int P, int N) {
  return dtype == 1 ? smem_bytes<bf16>(make_dims<bf16>(1, Q, 1, P, N))
                    : smem_bytes<float>(make_dims<float>(1, Q, 1, P, N));
}

// dtype: 0 = fp32, 1 = bf16 (x, B and C).  Strides are in elements, for the
// (b, c, q, h) dimensions of x, B, C, dt and da in that order.  Returns the
// CUDA error of the launch (0 on success).
int ssd_intra_chunk_launch(int dtype, const void* x, const void* bm,
                           const void* cm, const float* dt, const float* da,
                           float* y, float* s, float* dec, int B, int nc,
                           int Q, int H, int P, int N, long long sxb,
                           long long sxc, long long sxq, long long sxh,
                           long long sbb, long long sbc, long long sbq,
                           long long sbh, long long scb, long long scc,
                           long long scq, long long sch, long long sdtb,
                           long long sdtc, long long sdtq, long long sdth,
                           long long sdab, long long sdac, long long sdaq,
                           long long sdah, void* stream) {
  const Strides sx{sxb, sxc, sxq, sxh}, sb{sbb, sbc, sbq, sbh},
      sc{scb, scc, scq, sch}, sdt{sdtb, sdtc, sdtq, sdth},
      sda{sdab, sdac, sdaq, sdah};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = launch<bf16>(x, bm, cm, dt, da, y, s, dec, B,
                       make_dims<bf16>(nc, Q, H, P, N), sx, sb, sc, sdt, sda,
                       st);
  else if (dtype == 0)
    err = launch<float>(x, bm, cm, dt, da, y, s, dec, B,
                        make_dims<float>(nc, Q, H, P, N), sx, sb, sc, sdt,
                        sda, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
