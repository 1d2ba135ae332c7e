// Grouped GEMM kernels for Hopper (sm_90a): per-expert-slot batched matmul
// and the fused SwiGLU gate/up projection of the MoE expert FFN.
//
// Replaces the Pallas kernels of repro/kernels/grouped_gemm/kernel.py:
//   grouped_swiglu_pallas -> out[g] = silu(x[g] @ w1[g]) * (x[g] @ w3[g])
//   grouped_matmul_pallas -> out[g] = x[g] @ w[g]
// with x (G, M, K), w (G, K, N), out (G, M, N) in x's dtype and fp32
// accumulation.
//
// What bounds them on an H100: at the prefill shapes of the main path
// (G = 130 slots, M = 1009 rows, K = 4096, N = 1408) the tensor-core rate
// (3.0 TFLOP of bf16 for the SwiGLU, ~3 ms at 989 TFLOP/s); at decode
// (M = 8) the weight bytes (3.0 GB, ~0.9 ms at 3.35 TB/s).
//
// Design (a first, simple version): one block computes one output tile of
// one group and loops over K through shared memory.  The SwiGLU block loads
// each x tile once and feeds it to both the w1 and the w3 product; the two
// fp32 accumulators stay in registers and the gate is applied in the
// epilogue, so h and g never reach device memory (the property the Pallas
// kernel gets from its VMEM scratch).  bf16 runs on the tensor cores through
// WMMA 16x16x16 fragments fed by a 4-stage cp.async ring, so loads of the
// next K tiles overlap the products on the current one; fp32 (for tests on
// the card) is a SIMT FMA tile.  Every block masks the ragged M, N and K
// edges itself (zero-filled loads, guarded stores), so callers never pad.
// Not yet: wgmma and TMA (the only way to the full tensor-core rate),
// persistent blocks, and skipping the rows past each slot's valid count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float silu_mul(float h, float g) {
  return h * (1.0f / (1.0f + expf(-h))) * g;
}

// ---------------------------------------------------------------- bf16 / WMMA
//
// A block of 8 warps (2 along M x 4 along N) computes a BM x BN output tile
// and walks K in BK = 32 steps through a STAGES-deep ring of shared-memory
// tiles filled with cp.async, so the next tiles stream in while the tensor
// cores work on the current one.  Each warp owns a 64 x 32 slab of 16x16
// fragments: the SwiGLU block keeps two accumulator sets (h and g, 128 fp32
// per thread) over the same BN columns of w1 and w3, the matmul block one.

constexpr int TC_BK = 32;
constexpr int TC_STAGES = 4;
constexpr int TC_THREADS = 256;        // 8 warps
constexpr int TC_ALD = TC_BK + 8;      // smem leading dims (elements): 16-byte
                                       // rows, conflict-free ldmatrix

template <bool SWIGLU>
struct TcTile {
  static constexpr int BM = 128;
  static constexpr int BN = 128;                     // columns per weight
  static constexpr int WARPS_M = 2;                  // x WARPS_N = 8 warps
  static constexpr int WARPS_N = 4;
  static constexpr int FM = BM / WARPS_M / 16;       // 16x16 fragments/warp
  static constexpr int FN = BN / WARPS_N / 16;
  static constexpr int NB = SWIGLU ? 2 : 1;          // weight tiles per stage
  static constexpr int BLD = BN + 8;
  static constexpr int A_ELEMS = BM * TC_ALD;
  static constexpr int B_ELEMS = TC_BK * BLD;
  static constexpr int STAGE_ELEMS = A_ELEMS + NB * B_ELEMS;
  static constexpr int SMEM_BYTES =
      TC_STAGES * STAGE_ELEMS * 2 + TC_THREADS / 32 * 256 * 4;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Fill 8 consecutive bf16 of shared memory from a row of global memory:
// columns [col, col + 8) masked against `limit`, the whole chunk zero when
// the row is out of range.  Aligned full chunks go through cp.async (zero
// bytes read for an empty chunk); a ragged or misaligned chunk is copied
// element by element.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src,
                                           const bf16* base, bool row_ok,
                                           int col, int limit) {
  if (!row_ok || col >= limit) {
    cp_async16(dst, base, 0);
  } else if (col + 8 <= limit &&
             (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src, 16);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = col + e < limit ? src[e] : __float2bfloat16(0.0f);
  }
}

template <bool SWIGLU>
__global__ void __launch_bounds__(TC_THREADS)
grouped_gemm_bf16_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ w1,
                         const bf16* __restrict__ w3, bf16* __restrict__ out,
                         int M, int K, int N, long long sxg, long long sxm,
                         long long swg, long long swk, long long sog,
                         long long som) {
  using namespace nvcuda;
  using C = TcTile<SWIGLU>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  float* scratch_all =
      reinterpret_cast<float*>(smem_raw + TC_STAGES * C::STAGE_ELEMS * 2);

  const int g = blockIdx.z;
  const int m0 = blockIdx.y * C::BM;
  const int n0 = blockIdx.x * C::BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / C::WARPS_N, warp_n = warp % C::WARPS_N;

  const bf16* xg = x + g * sxg;
  const bf16* wg[2] = {w1 + g * swg, w3 + g * swg};

  auto load_stage = [&](int stage, int k0) {
    bf16* a_s = smem + stage * C::STAGE_ELEMS;
    // A: BM x BK = 512 chunks of 8, two per thread.
#pragma unroll
    for (int v = 0; v < C::BM * TC_BK / 8 / TC_THREADS; ++v) {
      const int idx = tid + v * TC_THREADS;
      const int row = idx / (TC_BK / 8), col = (idx % (TC_BK / 8)) * 8;
      load_chunk(a_s + row * TC_ALD + col,
                 xg + (long long)(m0 + row) * sxm + k0 + col, x,
                 m0 + row < M, k0 + col, K);
    }
    // B: BK x BN per weight.
#pragma unroll
    for (int b = 0; b < C::NB; ++b) {
      bf16* b_s = a_s + C::A_ELEMS + b * C::B_ELEMS;
#pragma unroll
      for (int v = 0; v < TC_BK * C::BN / 8 / TC_THREADS; ++v) {
        const int idx = tid + v * TC_THREADS;
        const int row = idx / (C::BN / 8), col = (idx % (C::BN / 8)) * 8;
        load_chunk(b_s + row * C::BLD + col,
                   wg[b] + (long long)(k0 + row) * swk + n0 + col, w1,
                   k0 + row < K, n0 + col, N);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::NB][C::FM][C::FN];
#pragma unroll
  for (int b = 0; b < C::NB; ++b)
#pragma unroll
    for (int i = 0; i < C::FM; ++i)
#pragma unroll
      for (int j = 0; j < C::FN; ++j) wmma::fill_fragment(acc[b][i][j], 0.0f);

  const int ktiles = (K + TC_BK - 1) / TC_BK;
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s * TC_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<TC_STAGES - 2>();   // this thread's copies of tile kt landed
    __syncthreads();                  // everyone's did; tile kt-1 is consumed
    const int pre = kt + TC_STAGES - 1;
    if (pre < ktiles) load_stage(pre % TC_STAGES, pre * TC_BK);
    cp_async_commit();

    const bf16* a_s = smem + (kt % TC_STAGES) * C::STAGE_ELEMS;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[C::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
        wmma::load_matrix_sync(
            a[i], a_s + (warp_m * C::FM * 16 + i * 16) * TC_ALD + kk, TC_ALD);
#pragma unroll
      for (int b = 0; b < C::NB; ++b) {
        const bf16* b_s = a_s + C::A_ELEMS + b * C::B_ELEMS;
#pragma unroll
        for (int j = 0; j < C::FN; ++j) {
          wmma::load_matrix_sync(
              bfr, b_s + kk * C::BLD + warp_n * C::FN * 16 + j * 16, C::BLD);
#pragma unroll
          for (int i = 0; i < C::FM; ++i)
            wmma::mma_sync(acc[b][i][j], a[i], bfr, acc[b][i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: the gate is elementwise over identically laid out fragments;
  // each 16x16 result goes through this warp's scratch for a guarded store.
  float* scratch = scratch_all + warp * 256;
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) {
      if constexpr (SWIGLU) {
#pragma unroll
        for (int t = 0; t < acc[0][i][j].num_elements; ++t)
          acc[0][i][j].x[t] = silu_mul(acc[0][i][j].x[t], acc[1][i][j].x[t]);
      }
      wmma::store_matrix_sync(scratch, acc[0][i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int rbase = m0 + warp_m * C::FM * 16 + i * 16;
      const int cbase = n0 + warp_n * C::FN * 16 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = rbase + e / 16, c = cbase + e % 16;
        if (r < M && c < N)
          out[g * sog + (long long)r * som + c] = __float2bfloat16(scratch[e]);
      }
      __syncwarp();
    }
}

// --------------------------------------------------------------- fp32 / SIMT

constexpr int F_BM = 64, F_BN = 64, F_BK = 16;
constexpr int F_THREADS = 256;         // 16 x 16 threads, 4 x 4 outputs each

template <bool SWIGLU>
__global__ void __launch_bounds__(F_THREADS)
grouped_gemm_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w1,
                        const float* __restrict__ w3, float* __restrict__ out,
                        int M, int K, int N, long long sxg, long long sxm,
                        long long swg, long long swk, long long sog,
                        long long som) {
  __shared__ float As[F_BK][F_BM + 4];     // stored transposed: As[k][m]
  __shared__ float B1s[F_BK][F_BN];
  __shared__ float B3s[SWIGLU ? F_BK : 1][F_BN];

  const int g = blockIdx.z;
  const int m0 = blockIdx.y * F_BM;
  const int n0 = blockIdx.x * F_BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  const float* xg = x + g * sxg;
  const float* w1g = w1 + g * swg;
  const float* w3g = w3 + g * swg;

  float acc1[4][4] = {}, acc3[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += F_BK) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {  // A: 64 x 16, B: 16 x 64, 1024 each
      const int idx = tid + v * F_THREADS;
      const int am = idx / F_BK, ak = idx % F_BK;
      As[ak][am] = (m0 + am < M && k0 + ak < K)
                       ? xg[(long long)(m0 + am) * sxm + k0 + ak] : 0.0f;
      const int bk = idx / F_BN, bn = idx % F_BN;
      const bool ok = k0 + bk < K && n0 + bn < N;
      const long long off = (long long)(k0 + bk) * swk + n0 + bn;
      B1s[bk][bn] = ok ? w1g[off] : 0.0f;
      if constexpr (SWIGLU) B3s[bk][bn] = ok ? w3g[off] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[4], b1[4], b3[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b1[j] = B1s[kk][tx * 4 + j];
        if constexpr (SWIGLU) b3[j] = B3s[kk][tx * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc1[i][j] = fmaf(a[i], b1[j], acc1[i][j]);
          if constexpr (SWIGLU) acc3[i][j] = fmaf(a[i], b3[j], acc3[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty * 4 + i, c = n0 + tx * 4 + j;
      if (r < M && c < N)
        out[g * sog + (long long)r * som + c] =
            SWIGLU ? silu_mul(acc1[i][j], acc3[i][j]) : acc1[i][j];
    }
}

template <typename T, bool SWIGLU>
int launch(const void* x, const void* w1, const void* w3, void* out, int G,
           int M, int K, int N, long long sxg, long long sxm, long long swg,
           long long swk, long long sog, long long som, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    using C = TcTile<SWIGLU>;
    auto kernel = grouped_gemm_bf16_kernel<SWIGLU>;
    // Above 48 KB, dynamic shared memory must be opted into (per device).
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM, G);
    kernel<<<grid, TC_THREADS, C::SMEM_BYTES, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
        static_cast<const bf16*>(w3), static_cast<bf16*>(out), M, K, N, sxg,
        sxm, swg, swk, sog, som);
  } else {
    const dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM, G);
    grouped_gemm_f32_kernel<SWIGLU><<<grid, F_THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(w3), static_cast<float*>(out), M, K, N, sxg,
        sxm, swg, swk, sog, som);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = fp32, 1 = bf16.
// swiglu: 1 -> out = silu(x @ w1) * (x @ w3); 0 -> out = x @ w1 (w3 unused).
// Strides are in elements; the last dimension of every operand is unit
// stride.  Launches on `stream`, does not synchronise, and returns the
// launch's CUDA error code (0 = launched).
extern "C" int grouped_gemm_launch(int dtype, int swiglu, const void* x,
                                   const void* w1, const void* w3, void* out,
                                   int G, int M, int K, int N, long long sxg,
                                   long long sxm, long long swg, long long swk,
                                   long long sog, long long som,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && swiglu)
    return launch<bf16, true>(x, w1, w3, out, G, M, K, N, sxg, sxm, swg, swk, sog, som, s);
  if (dtype == 1)
    return launch<bf16, false>(x, w1, w3, out, G, M, K, N, sxg, sxm, swg, swk, sog, som, s);
  if (dtype == 0 && swiglu)
    return launch<float, true>(x, w1, w3, out, G, M, K, N, sxg, sxm, swg, swk, sog, som, s);
  if (dtype == 0)
    return launch<float, false>(x, w1, w3, out, G, M, K, N, sxg, sxm, swg, swk, sog, som, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
