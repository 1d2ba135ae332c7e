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
//     each slot's valid rows only (rows past the count are never read).
// Rows past a slot's count come out as exact zeros in modes 0 and 1
// (selected, never multiplied: padded rows may hold anything).
//
// What bounds them on an H100: at GLM-4.5-Air's full width (K 4096, N
// 1408; 8192 tokens at top-8, 65,536 routed rows) the products, 3 x 2 x
// 65536 x 4096 x 1408 flops a product in 3xTF32, 4.6 ms each at the data
// sheet's 495 TFLOP/s TF32; at the reduced configurations' widths (D 64,
// F 32) the launch.  These are the first, simple kernels: right before
// fast.
//
// Arithmetic: 3xTF32 on mma.sync m16n8k8, as the fp32 forward
// (grouped_gemm.cu) and flash_attention_bwd_mma.cu: each operand split
// into hi + lo TF32 parts, a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, each
// product about 2^-20 of its size.  The tensor core truncates as it
// accumulates, so each 32-deep stage of the contraction is summed in
// fresh registers (large and small terms apart) and added to the fp32
// accumulator.  Every sum in a fixed order, no atomics: the same bits on
// every run.
//
// Design: one block of 4 warps per (64-row tile of the output, 64-column
// tile, slot); each warp owns 16 rows x 64 columns (8 n8 tiles; two sets
// in mode 1, h and g).  The contraction runs in stages of 32 through a
// 2-stage cp.async ring; a tile whose rows all lie past the count writes
// its zeros and exits before any load (mode 2: a slot with no rows writes
// zeros).  Operands stay fp32 in shared memory and are split as they are
// read: tiles with the contraction along the row are 32 + 4 floats a row,
// tiles with it down the columns 64 + 8, so every fragment read hits 32
// distinct banks.  Widths must be multiples of 4 floats (the wrapper asks
// for 8) on 16-byte aligned rows.
//
// Not yet: wgmma in TF32 (K-major operands only), a persistent schedule
// over the tiles that hold rows (as B1-B3 in bf16), weights split once a
// block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TM = 64, TN = 64;     // output tile
constexpr int KT = 32;              // contraction a stage
constexpr int LD_K = KT + 4;        // rows with the contraction along them
constexpr int LD_N = 64 + 8;        // rows with it down the columns

struct Args {
  const float *a, *a2, *b, *b2, *dact;
  float *out, *out2;
  const long long* rows;            // null: M for every slot
  int G, M, K, N;
  long long sag, sar, sbg, sbr;     // a (and a2), b (and b2): slot, row
  int second;                       // mode 0: add a2 b2^T
};

// Shared floats of one stage: mode 0 the A and B tiles (64 x 32 each, and
// A2, B2), mode 1 A (64 x 32) and the w1, w3 tiles (32 x 64 each), mode 2
// x and d (32 x 64 each).
template <int MODE>
struct Stage {
  static constexpr int A = MODE == 2 ? KT * LD_N : TM * LD_K;
  static constexpr int B = MODE == 0 ? TN * LD_K : KT * LD_N;
  static constexpr int FLOATS = MODE == 0 ? 2 * (A + B)
                                          : MODE == 1 ? A + 2 * B : A + B;
  static constexpr int BYTES = 2 * FLOATS * 4;
};

__device__ __forceinline__ long long valid_rows(const Args& p, int g) {
  if (p.rows == nullptr) return p.M;
  const long long r = p.rows[g];
  return r < 0 ? 0 : (r < p.M ? r : p.M);
}

// NROWS rows of COLS floats from row r's base src(r) (null: zeros), columns
// col0 + c below col_end, into rows LD apart.
template <int NROWS, int COLS, int LD, typename Src>
__device__ __forceinline__ void load_tile(float* dst, Src src, int col0,
                                          int col_end, const float* any) {
  constexpr int P = COLS / 4;
  for (int i = threadIdx.x; i < NROWS * P; i += THREADS) {
    const int r = i / P, c = i % P * 4;
    const float* s = src(r);
    const bool ok = s != nullptr && col0 + c < col_end;
    cp_async16(dst + r * LD + c, ok ? s + col0 + c : any, ok ? 16 : 0);
  }
}

struct FragA { unsigned h[4], l[4]; };
struct FragB { unsigned h[2], l[2]; };

// A fragment: rows r0 + gid (+ 8), contraction k0 + tq (+ 4) along a row.
__device__ __forceinline__ FragA a_rows(const float* s, int ld, int r0,
                                        int k0) {
  const int lane = threadIdx.x % 32;
  const float* p = s + (r0 + lane / 4) * ld + k0 + lane % 4;
  FragA a;
  split_tf32(p[0], a.h[0], a.l[0]);
  split_tf32(p[8 * ld], a.h[1], a.l[1]);
  split_tf32(p[4], a.h[2], a.l[2]);
  split_tf32(p[8 * ld + 4], a.h[3], a.l[3]);
  return a;
}

// A fragment of a tile stored transposed: rows r0 + gid (+ 8) are columns,
// the contraction k0 + tq (+ 4) runs down the rows.
__device__ __forceinline__ FragA a_cols(const float* s, int ld, int r0,
                                        int k0) {
  const int lane = threadIdx.x % 32;
  const float* p = s + (k0 + lane % 4) * ld + r0 + lane / 4;
  FragA a;
  split_tf32(p[0], a.h[0], a.l[0]);
  split_tf32(p[8], a.h[1], a.l[1]);
  split_tf32(p[4 * ld], a.h[2], a.l[2]);
  split_tf32(p[4 * ld + 8], a.h[3], a.l[3]);
  return a;
}

// B fragment, n = row n0 + gid, contraction k0 + tq (+ 4) along the row.
__device__ __forceinline__ FragB b_rows(const float* s, int ld, int n0,
                                        int k0) {
  const int lane = threadIdx.x % 32;
  const float* p = s + (n0 + lane / 4) * ld + k0 + lane % 4;
  FragB b;
  split_tf32(p[0], b.h[0], b.l[0]);
  split_tf32(p[4], b.h[1], b.l[1]);
  return b;
}

// B fragment, n = column n0 + gid, contraction k0 + tq (+ 4) down the rows.
__device__ __forceinline__ FragB b_cols(const float* s, int ld, int k0,
                                        int n0) {
  const int lane = threadIdx.x % 32;
  const float* p = s + (k0 + lane % 4) * ld + n0 + lane / 4;
  FragB b;
  split_tf32(p[0], b.h[0], b.l[0]);
  split_tf32(p[4 * ld], b.h[1], b.l[1]);
  return b;
}

__device__ __forceinline__ void mma(float (&big)[4], float (&small)[4],
                                    const FragA& a, const FragB& b) {
  mma_3xtf32(big, small, a.h, a.l, b.h, b.l);
}

__device__ __forceinline__ void add_stage(float (&acc)[4],
                                          const float (&big)[4],
                                          const float (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += big[e] + small[e];
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
grouped_bwd_f32_kernel(const Args p) {
  using S = Stage<MODE>;
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.z;
  const int r0 = blockIdx.x * TM;           // output rows (M, or K in mode 2)
  const int n0 = blockIdx.y * TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tq = lane % 4;
  const long long count = valid_rows(p, g);
  const int out_rows = MODE == 2 ? p.K : p.M;
  float* out = p.out + static_cast<long long>(g) * out_rows * p.N;
  float* out2 = MODE == 1 ? p.out2 + static_cast<long long>(g) * p.M * p.N
                          : nullptr;

  // Rows [r0, r0 + 64) x columns [n0, n0 + 64) of out (and out2) as zeros.
  auto write_zeros = [&]() {
    for (int i = threadIdx.x; i < TM * (TN / 2); i += THREADS) {
      const int r = r0 + i / (TN / 2), c = n0 + i % (TN / 2) * 2;
      if (r >= out_rows || c >= p.N) continue;
      const long long at = static_cast<long long>(r) * p.N + c;
      *reinterpret_cast<float2*>(out + at) = make_float2(0.f, 0.f);
      if (MODE == 1) *reinterpret_cast<float2*>(out2 + at) = make_float2(0.f, 0.f);
    }
  };
  const long long depth = MODE == 2 ? count : p.K;   // contraction length
  if ((MODE != 2 && r0 >= count) || depth == 0) {
    write_zeros();
    return;
  }
  const float* ag = p.a + g * p.sag;
  const float* a2g = MODE == 0 && p.second ? p.a2 + g * p.sag : nullptr;
  const float* bg = p.b + g * p.sbg;
  const float* b2g = MODE == 1 || (MODE == 0 && p.second) ? p.b2 + g * p.sbg
                                                          : nullptr;
  const int n_st = static_cast<int>((depth + KT - 1) / KT);

  auto load_stage = [&](int st, int t) {
    float* a_s = smem + st * S::FLOATS;
    float* b_s = a_s + S::A;
    const int k0 = t * KT;
    if constexpr (MODE == 0) {
      // A: output rows m (valid ones), contraction k along the row; B: rows
      // n, contraction k.
      auto arow = [&](const float* base) {
        return [=](int r) -> const float* {
          const long long m = r0 + r;
          return m < count ? base + m * p.sar : nullptr;
        };
      };
      auto brow = [&](const float* base) {
        return [=](int r) -> const float* {
          const int n = n0 + r;
          return n < p.N ? base + n * p.sbr : nullptr;
        };
      };
      load_tile<TM, KT, LD_K>(a_s, arow(ag), k0, p.K, p.a);
      load_tile<TN, KT, LD_K>(b_s, brow(bg), k0, p.K, p.b);
      if (p.second) {
        load_tile<TM, KT, LD_K>(b_s + S::B, arow(a2g), k0, p.K, p.a);
        load_tile<TN, KT, LD_K>(b_s + S::B + S::A, brow(b2g), k0, p.K, p.b);
      }
    } else if constexpr (MODE == 1) {
      load_tile<TM, KT, LD_K>(a_s, [&](int r) -> const float* {
        const long long m = r0 + r;
        return m < count ? ag + m * p.sar : nullptr;
      }, k0, p.K, p.a);
      auto krow = [&](const float* base) {
        return [=](int r) -> const float* {
          const int k = k0 + r;
          return k < p.K ? base + static_cast<long long>(k) * p.sbr : nullptr;
        };
      };
      load_tile<KT, TN, LD_N>(b_s, krow(bg), n0, p.N, p.b);
      load_tile<KT, TN, LD_N>(b_s + S::B, krow(b2g), n0, p.N, p.b);
    } else {
      // x and d rows m of the stage (valid ones), columns the output's.
      load_tile<KT, TM, LD_N>(a_s, [&](int r) -> const float* {
        const long long m = k0 + r;
        return m < count ? ag + m * p.sar : nullptr;
      }, r0, p.K, p.a);
      load_tile<KT, TN, LD_N>(b_s, [&](int r) -> const float* {
        const long long m = k0 + r;
        return m < count ? bg + m * p.sbr : nullptr;
      }, n0, p.N, p.b);
    }
  };

  float acc[TN / 8][4], acc2[MODE == 1 ? TN / 8 : 1][4];
#pragma unroll
  for (int j = 0; j < TN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < (MODE == 1 ? TN / 8 : 1); ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[j][e] = 0.f;

  load_stage(0, 0);
  cp_async_commit();
  const int wr = 16 * warp;                   // the warp's first tile row
  for (int t = 0; t < n_st; ++t) {
    if (t + 1 < n_st) load_stage((t + 1) & 1, t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* a_s = smem + (t & 1) * S::FLOATS;
    const float* b_s = a_s + S::A;
    FragA af[KT / 8];
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk)
      af[kk] = MODE == 2 ? a_cols(a_s, LD_N, wr, kk * 8)
                         : a_rows(a_s, LD_K, wr, kk * 8);
    if constexpr (MODE == 0) {
      FragA af2[KT / 8];
      if (p.second) {
#pragma unroll
        for (int kk = 0; kk < KT / 8; ++kk)
          af2[kk] = a_rows(b_s + S::B, LD_K, wr, kk * 8);
      }
#pragma unroll
      for (int nf = 0; nf < TN / 8; ++nf) {
        float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < KT / 8; ++kk)
          mma(big, small, af[kk], b_rows(b_s, LD_K, nf * 8, kk * 8));
        if (p.second) {
#pragma unroll
          for (int kk = 0; kk < KT / 8; ++kk)
            mma(big, small, af2[kk],
                b_rows(b_s + S::B + S::A, LD_K, nf * 8, kk * 8));
        }
        add_stage(acc[nf], big, small);
      }
    } else {
#pragma unroll
      for (int nf = 0; nf < TN / 8; ++nf) {
        float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < KT / 8; ++kk)
          mma(big, small, af[kk], b_cols(b_s, LD_N, kk * 8, nf * 8));
        add_stage(acc[nf], big, small);
        if constexpr (MODE == 1) {
          float big2[4] = {0.f, 0.f, 0.f, 0.f};
          float small2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < KT / 8; ++kk)
            mma(big2, small2, af[kk],
                b_cols(b_s + S::B, LD_N, kk * 8, nf * 8));
          add_stage(acc2[nf], big2, small2);
        }
      }
    }
    __syncthreads();                 // stage t & 1 is free for t + 2
  }
  cp_async_wait<0>();

  // This thread's rows r0 + wr + gid (+ 8), columns n0 + 8 nf + 2 tq (+ 1).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + wr + gid + 8 * i;
    if (r >= out_rows) continue;
    const bool valid = MODE == 2 || r < count;
#pragma unroll
    for (int nf = 0; nf < TN / 8; ++nf) {
      const int c = n0 + 8 * nf + 2 * tq;
      if (c >= p.N) continue;
      const long long at = static_cast<long long>(r) * p.N + c;
      float2 v = make_float2(0.f, 0.f), v2 = make_float2(0.f, 0.f);
      if (valid && MODE != 1) {
        v = make_float2(acc[nf][2 * i], acc[nf][2 * i + 1]);
      } else if (valid) {
        const float2 da = *reinterpret_cast<const float2*>(
            p.dact + static_cast<long long>(g) * p.M * p.N + at);
        const float h[2] = {acc[nf][2 * i], acc[nf][2 * i + 1]};
        const float gv[2] = {acc2[nf][2 * i], acc2[nf][2 * i + 1]};
        const float d[2] = {da.x, da.y};
        float dh[2], dg[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = 1.f / (1.f + expf(-h[e]));
          dg[e] = d[e] * h[e] * s;
          dh[e] = d[e] * gv[e] * s * (1.f + h[e] * (1.f - s));
        }
        v = make_float2(dh[0], dh[1]);
        v2 = make_float2(dg[0], dg[1]);
      }
      *reinterpret_cast<float2*>(out + at) = v;
      if (MODE == 1) *reinterpret_cast<float2*>(out2 + at) = v2;
    }
  }
}

template <int MODE>
int launch(const Args& p, cudaStream_t s) {
  auto kernel = grouped_bwd_f32_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Stage<MODE>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int out_rows = MODE == 2 ? p.K : p.M;
  const dim3 grid((out_rows + TM - 1) / TM, (p.N + TN - 1) / TN, p.G);
  if (grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, THREADS, Stage<MODE>::BYTES, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes.  mode 0 (dgrad): a = x (G, M, K),
// a2 = x2 or null, b = w (G, N, K), b2 = w2 or null, out (G, M, N); mode 1
// (SwiGLU backward): a = x (G, M, K), b = w1, b2 = w3 (G, K, N), dact
// (G, M, N) contiguous, out = dh, out2 = dg (G, M, N); mode 2 (wgrad):
// a = x (G, M, K), b = d (G, M, N), out (G, K, N).  All fp32 with a
// unit-stride last dim and 16-byte aligned rows; outputs contiguous.
// rows: a (G,) int64 device vector or null.  sag / sar and sbg / sbr:
// a's and b's slot and row strides (a2, b2 share them), elements.
// Launches on `stream`, does not synchronise, returns the CUDA error code
// (0 = launched).
extern "C" int grouped_bwd_f32_launch(
    int mode, const void* a, const void* a2, const void* b, const void* b2,
    const void* dact, void* out, void* out2, const void* rows, int G, int M,
    int K, int N, long long sag, long long sar, long long sbg,
    long long sbr, void* stream) {
  if (G < 1 || M < 0 || K < 1 || N < 1 || K % 4 || N % 4 ||
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
  p.rows = static_cast<const long long*>(rows);
  p.G = G; p.M = M; p.K = K; p.N = N;
  p.sag = sag; p.sar = sar; p.sbg = sbg; p.sbr = sbr;
  p.second = a2 != nullptr && b2 != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0) return 0;
  switch (mode) {
    case 0: return launch<0>(p, s);
    case 1: return launch<1>(p, s);
    case 2: return launch<2>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
