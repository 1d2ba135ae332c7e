// w8a8 grouped GEMM kernels for Hopper (sm_90a): the int8 expert FFN.
//
// Replaces the Pallas kernels of repro/kernels/grouped_gemm/kernel.py:
//   grouped_swiglu_q8_pallas -> out[g] = silu(h) * gt with
//       h  = (float)(q[g] @ w1q[g]) * row_scale[g][:, None] * w1s[g][None, :]
//       gt = (float)(q[g] @ w3q[g]) * row_scale[g][:, None] * w3s[g][None, :]
//   grouped_matmul_q8_pallas -> out[g] = (float)(q[g] @ wq[g])
//                                        * row_scale[g][:, None] * cs[g][None, :]
// with q int8 (G, M, K), weight codes int8 (G, K, N), row scales fp32 (G, M),
// column scales fp32 (G, N), and out fp32 (G, M, N).  Products accumulate in
// int32, which is exact in any order (|acc| <= 127^2 * K < 2^31 for
// K <= 133,000); the dequant multiplies in the reference's order,
// (acc * rs) * cs, each product rounded (no FMA), so the matmul equals its
// plain version bitwise and the SwiGLU differs only through expf.
//
// What bounds them on an H100 SXM (1,979 TOP/s int8 dense, 3.35 TB/s): at
// the GLM-4.5-Air prefill shape (G 130, M 1009, K 4096, N 1408) the SwiGLU
// is bound by operations (3.03 TOP, 1.53 ms; its bytes take 0.83 ms); the
// down projection (K 1408, N 4096) by bytes, and most of those bytes are its
// fp32 output (2.15 of 3.09 GB, 0.92 ms); at decode (M 8) both are bound by
// the weight bytes.  What the design does about it: h and g never leave the
// registers (both accumulators live in one block, which reads each x tile
// once for both contractions, and the gate runs in the epilogue), weights
// are read as int8 (a quarter of the fp32 bytes), and the output is written
// once, as fp32 pairs straight from the accumulators.
//
// Design (a first, simple version): one block of 8 warps computes a
// 128 x 128 output tile of one group and walks K in 64-byte steps through a
// 4-stage cp.async ring in shared memory.  Warps run mma.sync m16n8k32
// (s8 x s8 -> s32), which takes A row-major and B column-major: the weight
// codes must be K-contiguous ((G, N, K) storage passed as a (G, K, N)
// view), so both operands are copied to shared memory as rows of K.
// Shared rows are 80 bytes apart, so the 32-bit fragment loads of a warp
// hit 32 distinct banks.  Alignment: a token row of the int8 EP wire is
// D + 4 bytes long, so rows start on 4-byte, not 16-byte, boundaries; each
// operand is copied in 16-byte pieces when its base and strides allow it,
// else in 4-byte pieces, and any piece that is ragged or misaligned even so
// byte by byte.  Ragged M, N and K are masked in the kernel.  Not yet:
// wgmma with TMA (the way to the full int8 rate), persistent blocks, and
// stopping at each slot's valid row count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128;   // output tile (per weight)
constexpr int BK = 64;              // K bytes per stage
constexpr int LD = BK + 16;         // shared row stride, bytes
constexpr int STAGES = 4;
constexpr int THREADS = 256;        // 8 warps: 2 along M x 4 along N
constexpr int WARPS_N = 4;
constexpr int WM = 64, WN = 32;     // per-warp tile
constexpr int FM = WM / 16;         // m16 fragments per warp
constexpr int FN = WN / 8;          // n8 fragments per warp

template <bool SWIGLU>
struct Q8Tile {
  static constexpr int NB = SWIGLU ? 2 : 1;   // weight tiles per stage
  static constexpr int A_BYTES = BM * LD;
  static constexpr int B_BYTES = BN * LD;
  static constexpr int STAGE_BYTES = A_BYTES + NB * B_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
};

template <int W>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Fill W bytes of shared memory from a row of global memory: bytes
// [col, col + W) masked against `limit`, all zero when the row is out of
// range.  A full, aligned piece goes through cp.async (zero bytes read for
// an empty one); a ragged or misaligned piece is copied byte by byte.
template <int W>
__device__ __forceinline__ void load_piece(int8_t* dst, const int8_t* src,
                                           const int8_t* base, bool row_ok,
                                           int col, int limit) {
  if (!row_ok || col >= limit) {
    cp_async<W>(dst, base, 0);
  } else if (col + W <= limit &&
             (reinterpret_cast<uintptr_t>(src) & (W - 1)) == 0) {
    cp_async<W>(dst, src, W);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) dst[e] = col + e < limit ? src[e] : 0;
  }
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (float)acc * rs * cs in the reference's order, each product rounded.
__device__ __forceinline__ float dequant(int acc, float rs, float cs) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs);
}

__device__ __forceinline__ float silu_mul(float h, float g) {
  return h * (1.0f / (1.0f + expf(-h))) * g;
}

// Weights w1/w3: element (g, k, n) at g * swg + n * swn + k.  Scales s1/s3:
// element (g, n) at g * ssg + n.  Row scales: (g, m) at g * srg + m * srm.
template <bool SWIGLU, int AW, int BW>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_q8_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ rs,
                       const int8_t* __restrict__ w1,
                       const float* __restrict__ s1,
                       const int8_t* __restrict__ w3,
                       const float* __restrict__ s3, float* __restrict__ out,
                       int M, int K, int N, long long sqg, long long sqm,
                       long long srg, long long srm, long long swg,
                       long long swn, long long ssg, long long sog,
                       long long som) {
  using C = Q8Tile<SWIGLU>;
  extern __shared__ __align__(128) int8_t smem[];

  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / WARPS_N, warp_n = warp % WARPS_N;
  const int gid = lane / 4, tq = lane % 4;   // mma fragment coordinates

  const int8_t* qg = q + g * sqg;
  const int8_t* wg[2] = {w1 + g * swg, w3 + g * swg};

  auto load_stage = [&](int stage, int k0) {
    int8_t* a_s = smem + stage * C::STAGE_BYTES;
    // A: BM rows x BK bytes in pieces of AW.
#pragma unroll
    for (int v = 0; v < BM * BK / AW / THREADS; ++v) {
      const int idx = tid + v * THREADS;
      const int row = idx / (BK / AW), col = (idx % (BK / AW)) * AW;
      load_piece<AW>(a_s + row * LD + col,
                     qg + (long long)(m0 + row) * sqm + k0 + col, q,
                     m0 + row < M, k0 + col, K);
    }
    // B: BN weight columns x BK bytes of K each, per weight.
#pragma unroll
    for (int b = 0; b < C::NB; ++b) {
      int8_t* b_s = a_s + C::A_BYTES + b * C::B_BYTES;
#pragma unroll
      for (int v = 0; v < BN * BK / BW / THREADS; ++v) {
        const int idx = tid + v * THREADS;
        const int row = idx / (BK / BW), col = (idx % (BK / BW)) * BW;
        load_piece<BW>(b_s + row * LD + col,
                       wg[b] + (long long)(n0 + row) * swn + k0 + col, w1,
                       n0 + row < N, k0 + col, K);
      }
    }
  };

  int acc[C::NB][FM][FN][4];
#pragma unroll
  for (int b = 0; b < C::NB; ++b)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[b][i][j][t] = 0;

  const int ktiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of tile kt landed
    __syncthreads();               // everyone's did; tile kt-1 is consumed
    const int pre = kt + STAGES - 1;
    if (pre < ktiles) load_stage(pre % STAGES, pre * BK);
    cp_async_commit();

    const int8_t* a_s = smem + (kt % STAGES) * C::STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      // A fragment of m16n8k32 (row-major 16 x 32): rows gid and gid + 8,
      // bytes 4 tq .. 4 tq + 3 and 16 more.
      unsigned a[FM][4];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int8_t* p = a_s + (warp_m * WM + i * 16 + gid) * LD + kk + tq * 4;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * LD);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * LD + 16);
      }
#pragma unroll
      for (int b = 0; b < C::NB; ++b) {
        const int8_t* b_s = a_s + C::A_BYTES + b * C::B_BYTES;
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          // B fragment (column-major 32 x 8): column gid, bytes 4 tq.. and
          // 16 more of K.
          const int8_t* p = b_s + (warp_n * WN + j * 8 + gid) * LD + kk + tq * 4;
          const unsigned b0 = lds32(p), b1 = lds32(p + 16);
#pragma unroll
          for (int i = 0; i < FM; ++i) mma_s8(acc[b][i][j], a[i], b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: accumulator t of fragment (i, j) is row gid + 8 (t / 2),
  // column 2 tq + t % 2 of that 16 x 8 tile.
  float* og = out + g * sog;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + warp_m * WM + i * 16 + gid + half * 8;
      if (r >= M) continue;
      const float rsv = rs[g * srg + r * srm];
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int c = n0 + warp_n * WN + j * 8 + tq * 2;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = c + e < N ? c + e : N - 1;
          const float h = dequant(acc[0][i][j][half * 2 + e], rsv,
                                  s1[g * ssg + cc]);
          if constexpr (SWIGLU)
            v[e] = silu_mul(h, dequant(acc[1][i][j][half * 2 + e], rsv,
                                       s3[g * ssg + cc]));
          else
            v[e] = h;
        }
        float* dst = og + (long long)r * som + c;
        if (c + 1 < N && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        } else {
          if (c < N) dst[0] = v[0];
          if (c + 1 < N) dst[1] = v[1];
        }
      }
    }
}

template <bool SWIGLU, int AW, int BW>
int launch(const int8_t* q, const float* rs, const int8_t* w1,
           const float* s1, const int8_t* w3, const float* s3, float* out,
           int G, int M, int K, int N, long long sqg, long long sqm,
           long long srg, long long srm, long long swg, long long swn,
           long long ssg, long long sog, long long som, cudaStream_t stream) {
  using C = Q8Tile<SWIGLU>;
  auto kernel = grouped_gemm_q8_kernel<SWIGLU, AW, BW>;
  // Above 48 KB, dynamic shared memory must be opted into (per device).
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, G);
  kernel<<<grid, THREADS, C::SMEM_BYTES, stream>>>(
      q, rs, w1, s1, w3, s3, out, M, K, N, sqg, sqm, srg, srm, swg, swn, ssg,
      sog, som);
  return static_cast<int>(cudaGetLastError());
}

template <bool SWIGLU>
int launch_widths(int aw, int bw, const int8_t* q, const float* rs,
                  const int8_t* w1, const float* s1, const int8_t* w3,
                  const float* s3, float* out, int G, int M, int K, int N,
                  long long sqg, long long sqm, long long srg, long long srm,
                  long long swg, long long swn, long long ssg, long long sog,
                  long long som, cudaStream_t s) {
  if (aw == 16 && bw == 16)
    return launch<SWIGLU, 16, 16>(q, rs, w1, s1, w3, s3, out, G, M, K, N, sqg, sqm, srg, srm, swg, swn, ssg, sog, som, s);
  if (aw == 4 && bw == 16)
    return launch<SWIGLU, 4, 16>(q, rs, w1, s1, w3, s3, out, G, M, K, N, sqg, sqm, srg, srm, swg, swn, ssg, sog, som, s);
  if (aw == 16 && bw == 4)
    return launch<SWIGLU, 16, 4>(q, rs, w1, s1, w3, s3, out, G, M, K, N, sqg, sqm, srg, srm, swg, swn, ssg, sog, som, s);
  if (aw == 4 && bw == 4)
    return launch<SWIGLU, 4, 4>(q, rs, w1, s1, w3, s3, out, G, M, K, N, sqg, sqm, srg, srm, swg, swn, ssg, sog, som, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point, bound with ctypes.  swiglu: 1 -> the fused SwiGLU
// (w3, s3 used); 0 -> the matmul (w3, s3 unused).  aw, bw: the piece width
// in bytes (16 or 4) for the activation and weight copies; the caller picks
// 16 only when the operand's base and strides are multiples of 16.  Strides
// are in elements.  Launches on `stream`, does not synchronise, and returns
// the launch's CUDA error code (0 = launched).
extern "C" int grouped_gemm_q8_launch(
    int swiglu, int aw, int bw, const void* q, const void* rs, const void* w1,
    const void* s1, const void* w3, const void* s3, void* out, int G, int M,
    int K, int N, long long sqg, long long sqm, long long srg, long long srm,
    long long swg, long long swn, long long ssg, long long sog, long long som,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q8 = static_cast<const int8_t*>(q);
  const auto* rsf = static_cast<const float*>(rs);
  const auto* w1q = static_cast<const int8_t*>(w1);
  const auto* s1f = static_cast<const float*>(s1);
  const auto* w3q = static_cast<const int8_t*>(w3);
  const auto* s3f = static_cast<const float*>(s3);
  auto* o = static_cast<float*>(out);
  if (swiglu)
    return launch_widths<true>(aw, bw, q8, rsf, w1q, s1f, w3q, s3f, o, G, M, K,
                               N, sqg, sqm, srg, srm, swg, swn, ssg, sog, som, s);
  return launch_widths<false>(aw, bw, q8, rsf, w1q, s1f, w3q, s3f, o, G, M, K,
                              N, sqg, sqm, srg, srm, swg, swn, ssg, sog, som, s);
}
