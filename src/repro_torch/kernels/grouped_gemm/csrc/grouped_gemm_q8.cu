// w8a8 grouped GEMM kernels for Hopper (sm_90a): the int8 expert FFN.
//
// Replaces the Pallas kernels of repro/kernels/grouped_gemm/kernel.py:
//   grouped_swiglu_q8_pallas -> out[g] = silu(h) * gt with
//       h  = (float)(q[g] @ w1q[g]) * row_scale[g][:, None] * w1s[g][None, :]
//       gt = (float)(q[g] @ w3q[g]) * row_scale[g][:, None] * w3s[g][None, :]
//   grouped_matmul_q8_pallas -> out[g] = (float)(q[g] @ wq[g])
//                                        * row_scale[g][:, None] * cs[g][None, :]
// with q int8 (G, M, K), weight codes int8 (G, K, N) stored K-contiguous
// ((G, N, K) storage), row scales fp32 (G, M), column scales fp32 (G, N),
// and out (G, M, N) fp32 (the matmul may write bf16: the same fp32 value
// rounded to nearest even).  Products accumulate in int32, which is exact
// in any order (|acc| <= 127^2 * K < 2^31 for K <= 133,000); the dequant
// multiplies in the reference's order, (acc * rs) * cs, each product
// rounded (no FMA), so the matmul equals its plain version bitwise and the
// SwiGLU differs only through expf.  Unlike the Pallas kernels, which
// compute every row of a slot, these take each slot's valid-row count
// rows[g] on the device: rows [0, min(rows[g], M)) are computed and the
// rest are written as exact zeros, whatever q and row_scale hold there.
//
// What bounds them on an H100 SXM (1,979 TOP/s int8 dense, 3.35 TB/s),
// counting the valid work, each needed byte once: at GLM-4.5-Air prefill
// as the serve path fills the slots (130 slots x 1009 rows, ~252 valid, K
// 4096, N 1408) the bytes -- the SwiGLU's w1/w3 codes of the 128 slots
// that hold rows (1.48 GB) and its valid rows (~0.54 ms), the down
// projection's w2 codes and its output (~0.31 ms with bf16 output); with
// every row valid the SwiGLU is bound by operations (3.03 TOP, 1.53 ms) and
// the matmul by bytes, mostly its output (0.92 ms fp32, ~0.6 ms bf16); at
// decode (M 8, at most 32 slots with rows) the weight bytes of the slots
// with rows.  What the design does about it:
//   * Row skip.  A block whose 128-row tile starts at or past rows[g]
//     writes its zero tile and exits before any load, so a slot with no
//     rows costs no weight bytes and the ~75% padded rows of a serve
//     prefill cost only their zero stores; a consumer warpgroup whose 64
//     rows are all past the count runs no products (at decode one
//     warpgroup covers a slot's <= 8 rows).
//   * Tensor cores at the int8 rate: wgmma.mma_async m64n128k32
//     .s32.s8.s8 from shared memory.  8-bit wgmma takes both operands
//     K-major, which is how q and the weight codes are stored: a tile is
//     rows of 128 codes with 128-byte swizzle, and a k32 step advances the
//     descriptor's start by 32 bytes.
//   * h and g never leave the registers: one block holds both accumulator
//     sets (64 int32 a thread each), reads each q tile once for both
//     contractions and applies scales and gate in the epilogue.  The down
//     projection writes the FFN's output dtype directly, so no fp32 buffer
//     and no cast pass follow it.
//
// Block: three warpgroups, 128 output rows x 128 columns of the SwiGLU (two
// products from one A tile) or 256 of the matmul (two 128-column halves).
//   * One thread of warpgroup 2 produces a 4-stage ring of 48 KB stages
//     (A 128 x 128 codes, B twice 128 x 128) on mbarriers, every tile by TMA
//     from 3-D tensor maps over (G, rows, K), encoded on the host per call;
//     TMA zero-fills ragged M, N and K.  TMA needs a 16-byte aligned base
//     and row strides that are multiples of 16 bytes.  Every serve path's
//     operands have them: the bucket pads the int8 wire's slot-buffer rows
//     (D + 4 bytes) to 16 bytes (repro_torch/moe/permute.py).  The wrapper
//     copies any other operand (a view of unpadded wire rows, K not a
//     multiple of 16) into a padded buffer first and counts the copy.
//   * Warpgroups 0 and 1 (64 rows each) wait on a stage, run its 4 k32
//     steps for both accumulator sets, keep one stage's products in flight
//     while the next stage is awaited, and release the stage before.
//     setmaxnreg moves registers from the producer to them.
//   * Epilogue through shared memory: the tile's column scales are loaded
//     there before the main loop, the dequantized tile is staged in the
//     free ring, and the consumers write it out in 16-byte stores.
//   * The 1-D grid runs the M-tiles of one (slot, N-tile) next to each
//     other, so the second M-tile's weight tiles come from L2.
// Tried and dropped, slower or no faster on an H100: persistent blocks with a
// static tile order (a block's share of live tiles varies, and at the
// serve counts the slowest block set the time), one m64n256k32 product for
// both accumulator sets, and a cp.async producer for activations whose
// rows are only 4-byte aligned (4-byte pieces to swizzled addresses: about
// half the TMA route's rate, so the bucket pads the rows instead).  Not yet: overlapping one tile's epilogue with the next tile's
// products (a persistent, dynamically scheduled kernel), and TMA multicast
// across a cluster.

#include <cuda_bf16.h>

#include "grouped_common.cuh"
#include "hopper_tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;              // rows per block: two warpgroups of 64
constexpr int BN = 128;              // columns per accumulator set
constexpr int BK = 128;              // 128 int8 codes = one swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;         // warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int A_BYTES = BM * BK;                     // 16 KB
constexpr int B_BYTES = BN * BK;                     // 16 KB
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;   // 48 KB
constexpr int SCALES = 256;          // column scales of a tile, in smem
constexpr int SMEM_BYTES =
    STAGES * STAGE_BYTES + 1024 + SCALES * 4 + 2 * STAGES * 8;

// Keeps the compiler from moving accesses to the accumulators across the
// asynchronous products.
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128, int32) += A (64 x 32, K-major) @ B (32 x 128, K-major), s8.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, 1;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db));
}

// (float)acc * rs * cs in the reference's order, each product rounded.
__device__ __forceinline__ float dequant(int acc, float rs, float cs) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs);
}

// Two adjacent values of the staged tile (8- or 4-byte aligned).
__device__ __forceinline__ void store_pair(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(bf16* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

// Rows [m0, m0 + nrows) x columns [n0, n0 + ncols) of one slot's output:
// the staged tile (rows ldo elements apart), or zeros for a null one,
// written by `nthreads` threads from `tid`, 16 bytes a store where the row
// stride and ncols allow it (n0 is a multiple of 128).
template <typename OutT>
__device__ __forceinline__ void write_tile(OutT* outg, long long som, int m0,
                                           int nrows, int n0, int ncols,
                                           const OutT* staged, int ldo,
                                           int tid, int nthreads) {
  constexpr int VEC = 16 / sizeof(OutT);
  if (som % VEC == 0 && ncols % VEC == 0 &&
      (reinterpret_cast<uintptr_t>(outg) & 15) == 0) {
    const int chunks = ncols / VEC;
    for (int i = tid; i < nrows * chunks; i += nthreads) {
      const int r = i / chunks, c = (i % chunks) * VEC;
      *reinterpret_cast<uint4*>(outg + (m0 + r) * som + n0 + c) =
          staged ? *reinterpret_cast<const uint4*>(staged + r * ldo + c)
                 : make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = tid; i < nrows * ncols; i += nthreads) {
      const int r = i / ncols, c = i % ncols;
      outg[(m0 + r) * som + n0 + c] =
          staged ? staged[r * ldo + c] : OutT(0.0f);
    }
  }
}

// A (G, M, K) by map_q, the weight codes (G, N, K) by map_w1 / map_w3.
// Scales: rs (g, m) at g * srg + m * srm; s1/s3 (g, n) at g * ssg + n.
// out (G, M, N) at g * sog + m * som + n.
template <bool SWIGLU, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
grouped_gemm_q8_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_w1,
                             const __grid_constant__ CUtensorMap map_w3,
                             const float* __restrict__ rs, long long srg,
                             long long srm, const float* __restrict__ s1,
                             const float* __restrict__ s3, long long ssg,
                             OutT* __restrict__ out, long long sog,
                             long long som,
                             const long long* __restrict__ rows, int M,
                             int K, int N, int n_tiles, int m_tiles) {
  constexpr int OUT_COLS = SWIGLU ? BN : 2 * BN;
  extern __shared__ unsigned char smem_raw[];

  const int mt = blockIdx.x % m_tiles;
  const int nt = (blockIdx.x / m_tiles) % n_tiles;
  const int g = blockIdx.x / (m_tiles * n_tiles);
  const int m0 = mt * BM, n0 = nt * OUT_COLS;
  const int mv = valid_rows(rows, g, M);
  OutT* outg = out + g * sog;

  if (m0 >= mv) {   // no valid row in this tile: zeros, no loads
    write_tile<OutT>(outg, som, m0, min(BM, M - m0), n0,
                     min(OUT_COLS, N - n0), nullptr, 0, threadIdx.x, THREADS);
    return;
  }

  unsigned char* tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t tiles_u = smem_u32(tiles);
  float* scales = reinterpret_cast<float*>(tiles + STAGES * STAGE_BYTES);
  const uint32_t full0 = tiles_u + STAGES * STAGE_BYTES + SCALES * 4;
  const uint32_t empty0 = full0 + STAGES * 8;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);               // the producer's expect_tx
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The tile's column scales (w1 | w3, or its 256 columns), 0 past N: the
  // epilogue reads them from shared memory, not stalling on global loads.
  if (threadIdx.x < SCALES) {
    const int c = n0 + threadIdx.x % OUT_COLS;
    const float* src = (SWIGLU && threadIdx.x >= BN) ? s3 : s1;
    scales[threadIdx.x] = c < N ? src[g * ssg + c] : 0.0f;
  }
  __syncthreads();

  const int ktiles = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != CONSUMERS * 128) return;
    for (int t = 0; t < ktiles; ++t) {
      const int stage = t % STAGES;
      mbar_wait(empty0 + 8 * stage, ((t / STAGES) & 1) ^ 1);
      const uint32_t full = full0 + 8 * stage;
      const uint32_t a = tiles_u + stage * STAGE_BYTES;
      const int k0 = t * BK;
      mbar_expect_tx(full, STAGE_BYTES);
      tma_load(a, &map_q, full, k0, m0, g);
#pragma unroll
      for (int b = 0; b < 2; ++b) {   // w1 | w3, or the two column halves
        const CUtensorMap* map = (SWIGLU && b == 1) ? &map_w3 : &map_w1;
        tma_load(a + A_BYTES + b * B_BYTES, map, full, k0,
                 SWIGLU ? n0 : n0 + b * BN, g);
      }
    }
  } else {
    // ---- consumers: 64 rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    int acc[2][64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0;
    const bool active = m0 + wg * 64 < mv;
    const int lane = threadIdx.x % 32;
    int prev = 0;
    for (int t = 0; t < ktiles; ++t) {
      const int stage = t % STAGES;
      mbar_wait(full0 + 8 * stage, (t / STAGES) & 1);
      if (active) {
        const uint32_t a = tiles_u + stage * STAGE_BYTES + wg * (64 * BK);
        const uint32_t b = tiles_u + stage * STAGE_BYTES + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          const uint64_t da = desc_sw128(a + kk * 32, 16, 1024);
          wgmma_m64n128k32(acc[0], da, desc_sw128(b + kk * 32, 16, 1024));
          wgmma_m64n128k32(acc[1], da,
                           desc_sw128(b + B_BYTES + kk * 32, 16, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();   // the previous stage's products are done
      }
      if (t > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      prev = stage;
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);

    // Epilogue, through shared memory: once both warpgroups are done with
    // the ring, each thread writes its dequantized (and gated) values into
    // the tile there (rows OUT_COLS + 8 elements apart, so a warp's pair
    // stores hit distinct banks), then the 256 consumer threads write the
    // tile out in 16-byte pieces.  Thread layout of an m64nN 32-bit
    // accumulator: value 4 j + {0, 1} at row (warp % 4) * 16 + lane / 4,
    // columns 8 j + 2 (lane % 4) + {0, 1}; 4 j + {2, 3} eight rows below.
    const int rl0 = wg * 64 + (threadIdx.x / 32 % 4) * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
    constexpr int LDO = OUT_COLS + 8;
    OutT* staged = reinterpret_cast<OutT*>(tiles);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = rl0 + 8 * half;
      const int r = m0 + rl;
      OutT* srow = staged + rl * LDO;
      const bool keep = r < mv;
      const float rsv = keep ? rs[g * srg + r * srm] : 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int b = 0; b < (SWIGLU ? 1 : 2); ++b) {
          const int c = c0 + b * BN + 8 * j;   // column within the tile
          const int i = 4 * j + 2 * half;
          float v[2] = {0.0f, 0.0f};
          if (keep) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if constexpr (SWIGLU)
                v[e] = silu_mul(dequant(acc[0][i + e], rsv, scales[c + e]),
                                dequant(acc[1][i + e], rsv,
                                        scales[BN + c + e]));
              else
                v[e] = dequant(acc[b][i + e], rsv, scales[c + e]);
            }
          }
          store_pair(srow + c, v[0], v[1]);
        }
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    write_tile(outg, som, m0, min(BM, M - m0), n0, min(OUT_COLS, N - n0),
               staged, LDO, threadIdx.x, CONSUMERS * 128);
  }
}

template <bool SWIGLU, typename OutT>
int launch(const int8_t* q, long long sqg, long long sqm, const float* rs, long long srg, long long srm, const int8_t* w1,
           const int8_t* w3, long long swg, long long swn, const float* s1,
           const float* s3, long long ssg, OutT* out, const long long* rows,
           int G, int M, int K, int N, cudaStream_t stream) {
  CUtensorMap mq, mw1, mw3;
  int err = make_map_3d(&mq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, K, M, G,
                        sqm, sqg, BK, BM);
  if (!err)
    err = make_map_3d(&mw1, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w1, K, N, G,
                      swn, swg, BK, BN);
  if (!err)
    err = make_map_3d(&mw3, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w3, K, N, G,
                      swn, swg, BK, BN);
  if (err) return err;
  auto kernel = grouped_gemm_q8_wgmma_kernel<SWIGLU, OutT>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int out_cols = SWIGLU ? BN : 2 * BN;
  const int n_tiles = (N + out_cols - 1) / out_cols;
  const int m_tiles = (M + BM - 1) / BM;
  const long long blocks = static_cast<long long>(G) * n_tiles * m_tiles;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES, stream>>>(
      mq, mw1, mw3, rs, srg, srm, s1, s3, ssg, out,
      static_cast<long long>(M) * N, N, rows, M, K, N, n_tiles, m_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes.  swiglu: 1 -> the fused SwiGLU
// (w3, s3 used; out fp32); 0 -> the matmul (w3, s3 unused).  out_bf16: 1
// writes bf16, 0 fp32; out is a contiguous (G, M, N).  q and the weight
// codes are K-contiguous with base and strides multiples of 16 bytes (TMA
// reads them).  rows: (G,) int64 valid-row counts on the device, or null
// for M.  Strides are in elements.  Launches on
// `stream`, does not synchronise, and returns the launch's CUDA error code
// (0 = launched; 1000 and up: a tensor map could not be made).
extern "C" int grouped_gemm_q8_launch(
    int swiglu, int out_bf16, const void* q, long long sqg, long long sqm,
    const void* rs, long long srg, long long srm,
    const void* w1, const void* w3, long long swg, long long swn,
    const void* s1, const void* s3, long long ssg, void* out,
    const long long* rows, int G, int M, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q8 = static_cast<const int8_t*>(q);
  const auto* rsf = static_cast<const float*>(rs);
  const auto* w1q = static_cast<const int8_t*>(w1);
  const auto* w3q = static_cast<const int8_t*>(w3);
  const auto* s1f = static_cast<const float*>(s1);
  const auto* s3f = static_cast<const float*>(s3);
  if (swiglu && !out_bf16)
    return launch<true>(q8, sqg, sqm, rsf, srg, srm, w1q, w3q, swg, swn, s1f,
                        s3f, ssg, static_cast<float*>(out), rows, G, M, K, N,
                        s);
  if (!swiglu && !out_bf16)
    return launch<false>(q8, sqg, sqm, rsf, srg, srm, w1q, w1q, swg, swn, s1f,
                         s1f, ssg, static_cast<float*>(out), rows, G, M, K, N,
                         s);
  if (!swiglu)
    return launch<false>(q8, sqg, sqm, rsf, srg, srm, w1q, w1q, swg, swn, s1f,
                         s1f, ssg, static_cast<bf16*>(out), rows, G, M, K, N,
                         s);
  return static_cast<int>(cudaErrorInvalidValue);
}
