// Grouped GEMM kernels for Hopper (sm_90a): per-expert-slot batched matmul
// and the fused SwiGLU gate/up projection of the MoE expert FFN.
//
// Replaces the Pallas kernels of repro/kernels/grouped_gemm/kernel.py:
//   grouped_swiglu_pallas -> out[g] = silu(x[g] @ w1[g]) * (x[g] @ w3[g])
//   grouped_matmul_pallas -> out[g] = x[g] @ w[g]
// with x (G, M, K), w (G, K, N), out (G, M, N) in x's dtype and fp32
// accumulation.  Unlike the Pallas kernels, which compute every row of a
// slot ("zeros contribute zeros"), these take each slot's valid-row count
// `rows[g]` on the device: rows [0, min(rows[g], M)) are computed and the
// rest are written as exact zeros, whatever x holds there (valid rows are
// a prefix of each slot buffer; see repro_torch/moe/permute.py).
//
// What bounds them on an H100: the tensor-core rate on the valid rows
// when slots are full (GLM-4.5-Air prefill, 130 slots x 1009 rows, K 4096,
// N 1408: 3.0 TFLOP for the SwiGLU, ~3 ms at 989 TFLOP/s), and the weight
// bytes of the slots that hold any row when they are not (GLM's serve
// counts, ~252 rows a slot: 3.0 GB, ~0.9 ms at 3.35 TB/s; decode, at most
// 32 of 130 slots with rows: <= 0.74 GB).
//
// Design (bf16).  One block of three warpgroups computes a 128-row tile
// of one slot: 128 output columns of the SwiGLU (two products, on w1 and
// w3, from one A tile) or 256 of the matmul (two 128-column halves).
//   * Warpgroup 2 is the producer: one thread starts TMA loads of the x
//     tile (128 x 64, K-major) and the weight tiles (64 x 128 each, in two
//     64-column boxes, N-major as the weights are stored) into a 4-stage
//     ring of 48 KB stages with 128-byte swizzle, completion on mbarriers.
//     One 3-D tensor map per operand over (G, rows, cols) with the
//     caller's strides, encoded on the host per call;
//     cuTensorMapEncodeTiled is fetched through cudaGetDriverEntryPoint, so
//     the library needs no -lcuda.  TMA zero-fills the ragged M, N and K
//     edges.
//   * Warpgroups 0 and 1 (64 rows each) run wgmma.mma_async m64n128k16
//     bf16 -> fp32 straight from shared memory (B through the transpose
//     bit: no re-layout of the slot buffers), two accumulator sets of 64
//     registers per thread, one k-tile's products in flight while the next
//     tile's barrier is awaited; the SwiGLU gate is applied in registers in
//     the epilogue, so h and g never reach device memory (the property the
//     Pallas kernel gets from VMEM).  setmaxnreg moves registers from the
//     producer to the consumers.
//   * Rows are skipped on the device: a block whose tile starts at or past
//     rows[g] writes its zero tile and exits before any weight load, so a
//     slot with no rows costs no weight bytes; a warpgroup whose 64 rows
//     are all past the count runs no products; the epilogue zeroes the
//     rows past the count of a straddling tile.
//   * The 1-D grid runs the M-tiles of one (slot, N-tile) next to each
//     other, so the second M-tile's weight tiles come from L2.
// TMA needs 16-byte aligned bases and row strides; the wrapper copies an
// operand that is not into a padded buffer first (never on a serve path:
// every model width is a multiple of 8).  fp32 (card tests, fp32 serving)
// is a SIMT FMA tile that honours the same row counts by storing zeros
// past them; it is not meant for speed and skips no work.
// Not yet: persistent blocks (each block's prologue and epilogue are not
// overlapped with another tile's loads), clusters with TMA multicast, and
// stores through shared memory.

#include <cuda_bf16.h>

#include "hopper_tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------ bf16 / TMA + wgmma

constexpr int BM = 128;              // rows per block: two warpgroups of 64
constexpr int BN = 128;              // columns per accumulator set
constexpr int BK = 64;               // 64 bf16 = one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;         // warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int A_BYTES = BM * BK * 2;                 // 16 KB
constexpr int BOX_BYTES = BK * 64 * 2;               // 8 KB: 64 K x 64 N
constexpr int B_BYTES = 2 * BOX_BYTES;               // 16 KB: 64 K x 128 N
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;   // 48 KB
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

// Keeps the compiler from moving accesses to the accumulators across the
// asynchronous products.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) += A (64 x 16, K-major) @ B (16 x 128, N-major).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, 1, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// Zero rows [m0, m0 + nrows) x columns [n0, n0 + ncols) of one slot's
// output, 16 bytes a store (ncols, n0 and the row stride are multiples of
// 8 elements).
__device__ __forceinline__ void zero_tile(bf16* outg, long long som, int m0,
                                          int nrows, int n0, int ncols) {
  const int chunks = ncols / 8;
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < nrows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * 8;
    *reinterpret_cast<uint4*>(outg + (m0 + r) * som + n0 + c) = z;
  }
}

// out: (G, M, n_out) with n_out = N rounded up to 8 (the wrapper returns
// the first N columns); som = n_out, sog = M * n_out.
template <bool SWIGLU>
__global__ void __launch_bounds__(THREADS, 1)
grouped_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w1,
                          const __grid_constant__ CUtensorMap map_w3,
                          bf16* __restrict__ out,
                          const long long* __restrict__ rows, int M, int K,
                          int n_out, int n_tiles, int m_tiles, long long sog,
                          long long som) {
  constexpr int OUT_COLS = SWIGLU ? BN : 2 * BN;
  extern __shared__ unsigned char smem_raw[];

  const int mt = blockIdx.x % m_tiles;
  const int nt = (blockIdx.x / m_tiles) % n_tiles;
  const int g = blockIdx.x / (m_tiles * n_tiles);
  const int m0 = mt * BM, n0 = nt * OUT_COLS;
  const int mv = valid_rows(rows, g, M);
  bf16* outg = out + g * sog;

  if (m0 >= mv) {   // no valid row in this tile: zeros, no weight bytes
    zero_tile(outg, som, m0, min(BM, M - m0), n0, min(OUT_COLS, n_out - n0));
    return;
  }

  unsigned char* tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t tiles_u = smem_u32(tiles);
  const uint32_t full0 = tiles_u + STAGES * STAGE_BYTES;   // STAGES x 8 B
  const uint32_t empty0 = full0 + STAGES * 8;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int ktiles = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < ktiles; ++t) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = full0 + 8 * stage;
        const uint32_t a = tiles_u + stage * STAGE_BYTES;
        const int k0 = t * BK;
        mbar_expect_tx(full, STAGE_BYTES);
        tma_load(a, &map_x, full, k0, m0, g);
#pragma unroll
        for (int b = 0; b < 2; ++b) {   // w1 | w3, or the two column halves
          const CUtensorMap* map = (SWIGLU && b == 1) ? &map_w3 : &map_w1;
          const int nb = SWIGLU ? n0 : n0 + b * BN;
          const uint32_t dst = a + A_BYTES + b * B_BYTES;
          tma_load(dst, map, full, nb, k0, g);
          tma_load(dst + BOX_BYTES, map, full, nb + 64, k0, g);
        }
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // ---- consumers: 64 rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[2][64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.0f;
    const bool active = m0 + wg * 64 < mv;
    const int lane = threadIdx.x % 32;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int t = 0; t < ktiles; ++t) {
      mbar_wait(full0 + 8 * stage, phase);
      if (active) {
        const uint32_t a = tiles_u + stage * STAGE_BYTES + wg * (64 * 128);
        const uint32_t b = tiles_u + stage * STAGE_BYTES + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = desc_sw128(a + kk * 32, 16, 1024);
          wgmma_m64n128k16(acc[0], da,
                           desc_sw128(b + kk * 2048, BOX_BYTES, 1024));
          wgmma_m64n128k16(acc[1], da,
                           desc_sw128(b + B_BYTES + kk * 2048, BOX_BYTES,
                                      1024));
        }
        wgmma_commit();
        wgmma_wait<1>();   // the previous k-tile's products are done
      }
      if (t > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      prev = stage;
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);

    // Epilogue.  Thread layout of an m64nN fp32 accumulator: value
    // 4 j + {0, 1} at row (warp % 4) * 16 + lane / 4, columns
    // 8 j + 2 (lane % 4) + {0, 1}; 4 j + {2, 3} eight rows below.
    const int r0 = m0 + wg * 64 + (threadIdx.x / 32 % 4) * 16 + lane / 4;
    const int c0 = n0 + 2 * (lane % 4);
    const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.0f, 0.0f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r >= M) continue;
      bf16* orow = outg + r * som;
      const bool keep = r < mv;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int b = 0; b < (SWIGLU ? 1 : 2); ++b) {
          const int c = c0 + b * BN + 8 * j;
          if (c >= n_out) continue;
          const int i = 4 * j + 2 * half;
          float v0, v1;
          if constexpr (SWIGLU) {
            v0 = silu_mul(acc[0][i], acc[1][i]);
            v1 = silu_mul(acc[0][i + 1], acc[1][i + 1]);
          } else {
            v0 = acc[b][i];
            v1 = acc[b][i + 1];
          }
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              keep ? __floats2bfloat162_rn(v0, v1) : zero2;
        }
      }
    }
  }
}

// A (groups, rows, cols) bf16 operand with unit-stride cols; strides in
// elements; a box of box_rows x 64 columns with 128-byte swizzle.
int make_map(CUtensorMap* map, const void* base, long long cols,
             long long rows, long long groups, long long s_row,
             long long s_group, int box_rows) {
  return make_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, cols,
                     rows, groups, s_row, s_group, 64, box_rows);
}

template <bool SWIGLU>
int launch_bf16(const void* x, const void* w1, const void* w3, void* out,
                const long long* rows, int G, int M, int K, int N, int n_out,
                long long sxg, long long sxm, long long swg, long long swk,
                cudaStream_t stream) {
  CUtensorMap mx, mw1, mw3;
  int err = make_map(&mx, x, K, M, G, sxm, sxg, BM);
  if (!err) err = make_map(&mw1, w1, N, K, G, swk, swg, BK);
  if (!err) err = make_map(&mw3, w3, N, K, G, swk, swg, BK);
  if (err) return err;
  auto kernel = grouped_gemm_wgmma_kernel<SWIGLU>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int out_cols = SWIGLU ? BN : 2 * BN;
  const int n_tiles = (N + out_cols - 1) / out_cols;
  const int m_tiles = (M + BM - 1) / BM;
  const long long blocks = static_cast<long long>(G) * n_tiles * m_tiles;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES, stream>>>(
      mx, mw1, mw3, static_cast<bf16*>(out), rows, M, K, n_out, n_tiles,
      m_tiles, static_cast<long long>(M) * n_out, n_out);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------- fp32 / SIMT

constexpr int F_BM = 64, F_BN = 64, F_BK = 16;
constexpr int F_THREADS = 256;         // 16 x 16 threads, 4 x 4 outputs each

template <bool SWIGLU>
__global__ void __launch_bounds__(F_THREADS)
grouped_gemm_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w1,
                        const float* __restrict__ w3, float* __restrict__ out,
                        const long long* __restrict__ rows, int M, int K,
                        int N, long long sxg, long long sxm, long long swg,
                        long long swk, long long sog, long long som) {
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

  // Rows at or past the count are stored as zeros.  The count is read only
  // here: using it in the K loop (to skip or zero-load padded rows) changed
  // the loop's code and made this kernel markedly slower on an H100.
  const int mv = valid_rows(rows, g, M);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty * 4 + i, c = n0 + tx * 4 + j;
      if (r < M && c < N)
        out[g * sog + (long long)r * som + c] =
            r >= mv ? 0.0f
                    : (SWIGLU ? silu_mul(acc1[i][j], acc3[i][j]) : acc1[i][j]);
    }
}

template <bool SWIGLU>
int launch_f32(const void* x, const void* w1, const void* w3, void* out,
               const long long* rows, int G, int M, int K, int N,
               long long sxg, long long sxm, long long swg, long long swk,
               long long sog, long long som, cudaStream_t stream) {
  const dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM, G);
  grouped_gemm_f32_kernel<SWIGLU><<<grid, F_THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(w3), static_cast<float*>(out), rows, M, K, N,
      sxg, sxm, swg, swk, sog, som);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = fp32, 1 = bf16.
// swiglu: 1 -> out = silu(x @ w1) * (x @ w3); 0 -> out = x @ w1 (w3 unused).
// rows: (G,) int64 valid-row counts on the device, or null for M.
// Strides are in elements; the last dimension of every operand is unit
// stride.  bf16 needs 16-byte aligned bases and outer strides (TMA) and a
// contiguous out of width n_out = N rounded up to 8; fp32 takes any
// strides (n_out unused).  Launches on `stream`, does not synchronise, and
// returns the launch's CUDA error code (0 = launched; 1000 and up: a
// tensor map could not be made).
extern "C" int grouped_gemm_launch(int dtype, int swiglu, const void* x,
                                   const void* w1, const void* w3, void* out,
                                   const long long* rows, int G, int M, int K,
                                   int N, int n_out, long long sxg,
                                   long long sxm, long long swg, long long swk,
                                   long long sog, long long som,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && swiglu)
    return launch_bf16<true>(x, w1, w3, out, rows, G, M, K, N, n_out, sxg,
                             sxm, swg, swk, s);
  if (dtype == 1)
    return launch_bf16<false>(x, w1, w1, out, rows, G, M, K, N, n_out, sxg,
                              sxm, swg, swk, s);
  if (dtype == 0 && swiglu)
    return launch_f32<true>(x, w1, w3, out, rows, G, M, K, N, sxg, sxm, swg,
                            swk, sog, som, s);
  if (dtype == 0)
    return launch_f32<false>(x, w1, w1, out, rows, G, M, K, N, sxg, sxm, swg,
                             swk, sog, som, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
