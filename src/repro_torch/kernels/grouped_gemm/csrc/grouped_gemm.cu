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
// What bounds them on an H100 (bf16): the tensor-core rate on the valid
// rows when slots are full (GLM-4.5-Air prefill, 130 slots x 1009 rows,
// K 4096, N 1408: 3.0 TFLOP for the SwiGLU, ~3 ms at 989 TFLOP/s), and
// the weight bytes of the slots that hold any row when they are not
// (GLM's serve counts, ~252 rows a slot: 3.0 GB, ~0.9 ms at 3.35 TB/s;
// decode, at most 32 of 130 slots with rows: <= 0.74 GB).
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
// every model width is a multiple of 8).
//
// Design (fp32: fp32 serving, the serve CLI's default dtype).  The
// reference computes in fp32, whose rate off the tensor cores (67 TFLOP/s)
// bounds the GLM serve counts' SwiGLU at 11.3 ms; TF32 products alone miss
// the 1e-4 tolerance (10 mantissa bits, truncated: a bias near 1e-3).  So
// the products run on the tensor cores in 3xTF32: each fp32 operand is
// split into hi (its 13 low mantissa bits cleared, a TF32 value) and
// lo = x - hi, and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi on mma.sync
// m16n8k8, each product keeping about 2^-20 (fp32: 2^-24).  Three products
// at the TF32 rate (495 TFLOP/s) bound that SwiGLU at 4.6 ms, and a decode
// step by the weight bytes of its slots with rows (GLM: <= 1.5 GB).
// wgmma takes TF32 operands only K-major from shared memory, and the
// weights are N-major, so these kernels use mma.sync.  One block of eight
// warps computes a 128-row tile of one slot: 64 output columns of the
// SwiGLU (w1 and w3) or 128 of the matmul.
//   * Thread 0 also produces: it starts TMA loads of the x tile (128 x 32,
//     K-major) and four 32 x 32 weight boxes (N-major, as stored) into a
//     5-stage ring of 32 KB stages with 128-byte swizzle, completion on
//     mbarriers, the tensor maps as in the bf16 kernels; four tiles up
//     front, then one after each tile it has consumed.  No warp is set
//     apart for it: a ninth warp puts three on one SM sub-partition, whose
//     16K registers then cap a thread at 168, and the K loop spilled.
//   * The 8 warps (4 row warps of 32 rows x 2 column warps) read their
//     fragments from the swizzled tiles without bank conflicts (A by
//     ldmatrix, B one 16-byte load per k row; consume_f32 gives the
//     layout), split each element once (the SwiGLU's A fragment serves w1
//     and w3), and sum each 32-deep stage's products in fresh registers
//     that are added to the accumulators in fp32: the tensor core
//     truncates as it accumulates, so no chain runs over all of K.
//   * Rows are skipped on the device as in bf16: a block whose tile
//     starts at or past rows[g] writes zeros and exits before any weight
//     load; a row warp whose 32 rows are all past the count writes zeros
//     and takes no part in the ring; a warp whose second 16-row fragment
//     is past it runs half the products (a separate instantiation of the
//     K loop, which reads no count); the epilogue selects zero for the
//     rows past the count of a straddling tile.
// At GLM's serve counts on an H100 the SwiGLU takes 13.5 ms and the matmul
// 7.0 (chip_smoke.py): a third of their three-product bounds, 0.23x
// torch.bmm over the padded buffers in fp32.
// Backward (bf16 only; the training step's expert FFN, at GLM-4.5-Air's
// train shapes G 130, cap 2017, K 4096, N 1408).  The JAX package has no
// backward kernel: XLA differentiates the einsums of repro/moe/expert.py.
//   * B1, B2 and B3 are persistent kernels of their own: one block an SM
//     (__launch_bounds__(THREADS, 1), ~210 KB of shared memory) walks a
//     list of output tiles; the producer thread keeps the ring (3 stages of
//     48 KB) full across tile boundaries, so the next tile's loads run
//     under this tile's epilogue, and the epilogue leaves through shared
//     memory: bf16 into swizzled staging boxes, fence.proxy.async, one
//     thread's TMA stores in a bulk group, waited on only before the
//     buffer is written again, so the store of tile i runs under the
//     products of tile i + 1.  Three stages, not the forward's four: the
//     staging takes the fourth stage's room (227 KB a block; four stages
//     with half the staging measured no faster).  A consumer warpgroup
//     runs its 64 rows x 256 columns as one m64n256k16 product a k-step
//     (two m64n128 would read its A operand twice).
//   * B2 grouped_matmul_nt_kernel (dgrad): out = x w^T with w stored
//     (G, N, K), K-contiguous (dact = dy w2^T, N 1408 at GLM-4.5-Air);
//     NT2 sums two products over the same K, out = x w1^T + x2 w3^T (dx =
//     dh w1^T + dg w3^T, N 4096): the k loop runs over (x, w1) and then
//     (x2, w3) into the same accumulators.  A tile is 128 rows (two
//     warpgroups of 64) x 256 columns; wgmma reads the K-major B without
//     the transpose bit, the stage's 256 weight rows two TMA boxes of 64 K
//     x 128 rows side by side.  A last column tile of at most 128 columns
//     runs an m64n128 product and loads one box (GLM's N 1408 is 5.5
//     tiles).  Only row tiles that hold rows are walked, numbered and taken
//     as B1's items (below): slot-major, then the column tile, then the
//     row tile fastest, from a device counter; a slot's last row tile with
//     at most 64 valid rows is a narrow item whose 64 rows both warpgroups
//     take, each 128 of the 256 columns.  A slot's empty row tiles cost
//     nothing (at GLM-4.5-Air's train counts 12 of a slot's 16).  Rows
//     past the count: a straddling tile's are stored as zeros (selected,
//     never multiplied, so NaN in the operands' padded rows never reaches
//     a valid row); the rest, rows [ceil(rows[g] / 64) 64, M), are written
//     as zeros by the producer warpgroup's idle warps (the public
//     contract) or left unwritten (the autograd backward: dact's reader is
//     B1, dx's the dispatch gathers' backward, both of which select the
//     valid rows).
//     Bound: the products on the valid rows where slots are long (GLM's
//     and Jamba-v0.1's train counts), the weights' bytes where they are
//     short (DeepSeek-V3's cell).  Where slots are long the main loop also
//     meets the L2's bandwidth: a 128 x 256 tile takes 48 KB a k-step, ~7
//     TB/s over 132 SMs at GLM's counts (skipping a third of the bytes
//     measured 8-10% faster).  Clusters of two CTAs sharing a weight tile
//     by multicast read a third less, and were 12% faster where every slot
//     held 512 rows, but 4-8% slower at GLM's train counts, so not kept.
//   * B3 grouped_wgrad_kernel: dW[g] = x[g, :rows[g]]^T d[g, :rows[g]],
//     (G, K, N) in bf16 with fp32 accumulation.  A tile is 128 output
//     rows (two warpgroups of 64) x 256 columns; the list is every
//     (slot, K tile, N tile), slot-major with the N tiles fastest, block b
//     taking tiles b, b + grid, ...: the blocks running together read one
//     slot's x and d panels from L2 and write whole output rows (at
//     DeepSeek-V3's cell, bound by its stores, 3.45-3.54 ms against
//     3.91-4.00 with the K tiles fastest; the same within 5% at GLM's and
//     Jamba's counts).  The contraction is over the slot's
//     valid rows only: ceil(rows[g] / 64) token tiles (a slot with no rows
//     stores its zero tile and reads nothing; this is what torch.bmm over
//     the padded buffers cannot skip), and the rows of the last tile past
//     the count are zeroed in shared memory before its products, so
//     whatever the buffers hold there (NaN included) adds nothing.  Both
//     operands are token-major: x is read as an M-major A (wgmma's
//     transpose bit on A), d as the N-major B the forward kernels read.
//     Columns: a tile whose second 128 columns lie past N runs an m64n128
//     product (GLM-4.5-Air's N 1408 is 5.5 tiles of 256; the last one is
//     128 wide instead of wasting 8% of the products on zero columns).
//     What bounds it: the products where slots are long (GLM's and
//     Jamba's train counts, ~500 rows a slot: 0.76 and 0.97 ms), the
//     output's bytes where they are short (DeepSeek-V3's cell, ~128 rows a
//     slot: 258 x 7168 x 2048 bf16, 7.6 GB, 2.26 ms against 2 token tiles
//     of products a tile), where a tile's stores overlap the next tile's
//     products (a second staging tile in place of a stage measured no
//     faster).
//   * B1 grouped_swiglu_bwd_kernel: the SwiGLU's products h = x w1,
//     g = x w3 from one read of each x tile (w1's and w3's boxes side by
//     side as one 256-column B), and an epilogue that writes
//     dh = dact g s (1 + h (1 - s)) and dg = dact h s, s = sigmoid(h),
//     both bf16.  Only row tiles that hold rows are walked:
//     sum_g ceil(rows[g] / 128) of them x the 128-column tiles, numbered
//     by a schedule every block builds in shared memory from `rows` (a
//     warp scan; no host read): slot-major, then the column tile, then the
//     row tile fastest.  Blocks take the items one at a time from a counter
//     on the device, so the items that share a weight panel start together
//     and its second reader finds it in L2 (with items dealt out by block
//     number, blocks drift apart and DeepSeek-V3's cell, whose weights
//     bound it, read them about twice).  A slot's last row tile with at
//     most 64 valid rows is a narrow item: both warpgroups take its 64
//     rows, each 64 of the 128 columns (one m64n128 product over w1's and
//     w3's boxes 16 KB apart), so it costs half an item instead of a full
//     one with a warpgroup idle.  The tile's dact block (128 x 128, 32 KB)
//     comes by TMA into its own buffer under its own mbarrier while the
//     products run (the producer issues it a few k-steps into the tile,
//     once the previous tile's dh store has read the buffer); each thread
//     reads its dact values from it and writes dh back in place and dg
//     into a staging buffer, and both leave by TMA.  Rows past the count:
//     a straddling tile's are stored as zeros; the rest, rows
//     [ceil(rows[g] / 64) 64, M) of each slot, one contiguous range, are
//     written as zeros by streaming 16-byte stores from the producer
//     warpgroup's three idle warps (the public contract), or left
//     unwritten (the autograd backward, whose only readers, B2 and B3,
//     read the valid rows only).  Bound as the forward SwiGLU (operations
//     on the valid rows), or by the weights' bytes where slots are short.
// Not yet: clusters with TMA multicast; for fp32, wgmma in TF32 (it needs
// the weights K-major: a transpose in shared memory or K-major slot
// buffers), and splitting each weight element once a block, not once a
// row warp.

#include <cuda_bf16.h>

#include "grouped_common.cuh"
#include "hopper_tma.cuh"
#include "warp_mma.cuh"

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

// d (64 x 128, fp32) += A (64 x 16) @ B (16 x 128), both from shared
// memory: A K-major (TA 0) or M-major (TA 1), B K-major (TB 0) or N-major
// (TB 1), the transpose bits of wgmma.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, 1, 1, 1, %66, %67;\n"
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
      : "l"(da), "l"(db), "n"(TA), "n"(TB));
}

// d (64 x 256, fp32) += A (64 x 16) @ B (16 x 256): as wgmma_m64n128k16,
// with B four 64-column boxes LBO apart (one instruction where two m64n128
// would read A twice).  d[4 j + e] sits at column 8 j + 2 (lane % 4) +
// (e & 1): j < 16 is the first 128 columns, so d is acc[2][64] flattened.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, 1, 1, 1, %130, %131;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "n"(TA), "n"(TB));
}

__device__ __forceinline__ float (&flat(float (&acc)[2][64]))[128] {
  return *reinterpret_cast<float(*)[128]>(&acc[0][0]);
}

// Zero rows [m0, m0 + nrows) x columns [n0, n0 + ncols) of one slot's
// output, 16 bytes a store (ncols, n0 and the row stride are multiples of
// 16 bytes).
template <typename T>
__device__ __forceinline__ void zero_tile(T* outg, long long som, int m0,
                                          int nrows, int n0, int ncols) {
  constexpr int V = 16 / sizeof(T);
  const int chunks = ncols / V;
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < nrows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * V;
    *reinterpret_cast<uint4*>(outg + (m0 + r) * som + n0 + c) = z;
  }
}

// The products of grouped_gemm_wgmma_kernel.
enum Mode {
  MODE_MATMUL = 0,       // out = x w (w N-major)
  MODE_SWIGLU = 1,       // out = silu(x w1) * (x w3)
};

// dh and dg of out = silu(h) g for an upstream gradient da.
__device__ __forceinline__ void swiglu_grad(float h, float g, float da,
                                            float& dh, float& dg) {
  const float sg = 1.0f / (1.0f + expf(-h));
  dg = da * h * sg;
  dh = da * g * sg * (1.0f + h * (1.0f - sg));
}

// out: (G, M, n_out) with n_out = N rounded up to 8 (the wrapper returns
// the first N columns); som = n_out, sog = M * n_out.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
grouped_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w1,
                          const __grid_constant__ CUtensorMap map_w3,
                          bf16* __restrict__ out,
                          const long long* __restrict__ rows, int M, int K,
                          int n_out, int n_tiles, int m_tiles, long long sog,
                          long long som) {
  constexpr bool SWI = MODE == MODE_SWIGLU;
  constexpr int OUT_COLS = SWI ? BN : 2 * BN;
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
          const uint32_t dst = a + A_BYTES + b * B_BYTES;
          const CUtensorMap* map = (SWI && b == 1) ? &map_w3 : &map_w1;
          const int nb = SWI ? n0 : n0 + b * BN;
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
          wgmma_m64n128k16<0, 1>(
              acc[0], da, desc_sw128(b + kk * 2048, BOX_BYTES, 1024));
          wgmma_m64n128k16<0, 1>(
              acc[1], da,
              desc_sw128(b + B_BYTES + kk * 2048, BOX_BYTES, 1024));
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
        for (int b = 0; b < (SWI ? 1 : 2); ++b) {
          const int c = c0 + b * BN + 8 * j;
          if (c >= n_out) continue;
          const int i = 4 * j + 2 * half;
          float v0, v1;
          if constexpr (MODE == MODE_SWIGLU) {
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

// -------------------------------- backward B1, B2 and B3: persistent blocks

constexpr int P_STAGES = 3;          // ring stages of STAGE_BYTES
constexpr int SBOX = 64 * 128;       // 8 KB: 64 rows of a swizzled 64-column box
constexpr int TAIL_BAR = 1;          // named barrier of both consumer warpgroups
constexpr int WG_BAR = 2;            // 2, 3: one a consumer warpgroup
constexpr int FREE_AT = 4;           // B1: k-step at which the dact buffer is
constexpr int DACT_AT = FREE_AT + P_STAGES;   // freed, and refilled
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block may use
// Shared memory of all three: the ring, 64 KB of staging (B2, B3: two
// warpgroups x four boxes; B1: the dact buffer and dg's), the barriers;
// then B1's and B2's work-item ids and schedule (G + 1 ints, added by the
// launcher).
constexpr int SMEM_PERSISTENT =
    1024 + P_STAGES * STAGE_BYTES + 8 * SBOX + (2 * P_STAGES + 2) * 8 +
    4 * P_STAGES;

// Byte offset of element column c (even, < 64) of row r in a box of 64 bf16
// columns with TMA's 128-byte swizzle (16-byte chunk j of row r at chunk
// j ^ (r % 8); boxes 1024-byte aligned).  A warp's 32-bit accesses at one
// accumulator index touch 8 rows x 4 words: 32 distinct banks.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8 x 8 bf16 matrices to shared memory in one instruction: lane t
// gives the address of row t % 8 of matrix t / 8 (16 bytes), and its
// register i holds its part of matrix i in the mma fragment layout (row
// lane / 4, columns 2 (lane % 4) + {0, 1}).
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == P_STAGES) { stage = 0; phase ^= 1; }
}

// B3's tile w: slot g, output rows m0 .. m0 + 127 (of Kd), columns
// n0 .. n0 + 255 (of N); slot-major, the N tiles fastest.
__device__ __forceinline__ void wgrad_tile(int w, int k_tiles, int n_tiles,
                                           int& g, int& m0, int& n0) {
  const int per = k_tiles * n_tiles;
  g = w / per;
  const int r = w - g * per;
  m0 = (r / n_tiles) * BM;
  n0 = (r % n_tiles) * 2 * BN;
}

// One B3 tile's token tiles for one consumer warpgroup: TWO, both
// 128-column halves in one m64n256 product (the four B boxes side by
// side), else the first half's m64n128.  Stage t holds token rows
// 64 t .. 64 t + 63 as two A boxes (64 Kd columns each, one per consumer
// warpgroup) and four B boxes; the ring position carries over to the next
// tile, and the last stage is released here.
template <bool TWO>
__device__ __forceinline__ void wgrad_products(float (&acc)[2][64],
                                               unsigned char* tiles,
                                               uint32_t tiles_u,
                                               uint32_t full0,
                                               uint32_t empty0, int mv,
                                               int wg, int& stage,
                                               uint32_t& phase) {
  const int lane = threadIdx.x % 32;
  const int ttiles = (mv + BK - 1) / BK;
  int prev = 0;
  for (int t = 0; t < ttiles; ++t) {
    mbar_wait(full0 + 8 * stage, phase);
    const int tail = mv - t * BK;   // valid token rows in this tile
    if (tail < BK) {
      // Token rows tail .. 63 of all six boxes to zero (a row is 128
      // bytes; the swizzle permutes 16-byte pieces within it), made
      // visible to the tensor cores' async proxy, then both consumer
      // warpgroups meet before the products.
      unsigned char* st = tiles + stage * STAGE_BYTES;
      const int n = 6 * (BK - tail) * 8;
      const uint4 z = make_uint4(0, 0, 0, 0);
      for (int i = threadIdx.x; i < n; i += CONSUMERS * 128) {
        const int box = i / ((BK - tail) * 8);
        const int rr = tail + (i / 8) % (BK - tail), c = i % 8;
        *reinterpret_cast<uint4*>(st + box * BOX_BYTES + rr * 128 + c * 16) =
            z;
      }
      fence_proxy_async();
      named_sync(TAIL_BAR, CONSUMERS * 128);
    }
    const uint32_t a = tiles_u + stage * STAGE_BYTES + wg * BOX_BYTES;
    const uint32_t b = tiles_u + stage * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = desc_sw128(a + kk * 2048, BOX_BYTES, 1024);
      const uint64_t db = desc_sw128(b + kk * 2048, BOX_BYTES, 1024);
      if constexpr (TWO)
        wgmma_m64n256k16<1, 1>(flat(acc), da, db);
      else
        wgmma_m64n128k16<1, 1>(acc[0], da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (t > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
    prev = stage;
    advance(stage, phase);
  }
  wgmma_wait<0>();
  if (ttiles > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
  fence_regs(acc[0]);
  fence_regs(acc[1]);
}

// B3: dW[g] (Kd x N) = x[g, :mv]^T @ d[g, :mv] over the slot's mv valid
// rows; x (G, M, Kd) and d (G, M, N) bf16, token-major; out (G, Kd, N) bf16
// through map_out (64 x 64 boxes).  n_work = G k_tiles n_tiles tiles.
__global__ void __launch_bounds__(THREADS, 1)
grouped_wgrad_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_d,
                     const __grid_constant__ CUtensorMap map_out,
                     const long long* __restrict__ rows, int M, int N,
                     int k_tiles, int n_tiles, int n_work) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t tiles_u = smem_u32(tiles);
  const uint32_t out_u = tiles_u + P_STAGES * STAGE_BYTES;   // 8 boxes
  const uint32_t full0 = out_u + 8 * SBOX;
  const uint32_t empty0 = full0 + P_STAGES * 8;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < P_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  int stage = 0;
  uint32_t phase = 0;
  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring full, tile after tile.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        int g, m0, n0;
        wgrad_tile(w, k_tiles, n_tiles, g, m0, n0);
        const int ttiles = (valid_rows(rows, g, M) + BK - 1) / BK;
        for (int t = 0; t < ttiles; ++t) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t a = tiles_u + stage * STAGE_BYTES;
          mbar_expect_tx(full, STAGE_BYTES);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            tma_load(a + j * BOX_BYTES, &map_x, full, m0 + 64 * j, t * BK, g);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_load(a + A_BYTES + j * BOX_BYTES, &map_d, full, n0 + 64 * j,
                     t * BK, g);
          advance(stage, phase);
        }
      }
    }
  } else {
    // ---- consumers: 64 output rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, tid = threadIdx.x % 128;
    const uint32_t my_out = out_u + wg * 4 * SBOX;   // 64 rows x 256 columns
    const int r0 = (tid / 32) * 16 + lane / 4;
    float acc[2][64];
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      int g, m0, n0;
      wgrad_tile(w, k_tiles, n_tiles, g, m0, n0);
      const int mv = valid_rows(rows, g, M);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.0f;
      const bool two = n0 + BN < N;
      if (two)
        wgrad_products<true>(acc, tiles, tiles_u, full0, empty0, mv, wg,
                             stage, phase);
      else
        wgrad_products<false>(acc, tiles, tiles_u, full0, empty0, mv, wg,
                              stage, phase);
      // Epilogue.  Thread layout of an m64nN fp32 accumulator: value
      // 4 j + {0, 1} at row (warp % 4) * 16 + lane / 4, columns
      // 8 j + 2 (lane % 4) + {0, 1}; 4 j + {2, 3} eight rows below.  The
      // previous tile's stores must have read the staging boxes.
      if (tid == 0) bulk_wait_read<0>();
      named_sync(WG_BAR + wg, 128);
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = b * BN + 8 * j + 2 * (lane % 4);
            const int i = 4 * j + 2 * half;
            st_shared_u32(my_out + (col / 64) * SBOX +
                              sw128(r0 + 8 * half, col % 64),
                          pack_bf16x2(acc[b][i], acc[b][i + 1]));
          }
      fence_proxy_async();
      named_sync(WG_BAR + wg, 128);
      if (tid == 0) {
        for (int bx = 0; bx < (two ? 4 : 2); ++bx)
          tma_store(&map_out, my_out + bx * SBOX, n0 + 64 * bx, m0 + 64 * wg,
                    g);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait<0>();
  }
}

// B1's and B2's schedule: wstart[g] = sum over g' < g of
// ceil(rows[g'] / 128) row tiles x n_tiles column tiles, G + 1 ints in
// shared memory, by a chunked scan in one warp (no host read).  Every
// thread gets it; it has two block barriers.
__device__ __forceinline__ void build_schedule(int* wstart,
                                               const long long* rows, int G,
                                               int M, int n_tiles) {
  for (int i = threadIdx.x; i < G; i += blockDim.x)
    wstart[i + 1] = (valid_rows(rows, i, M) + BM - 1) / BM * n_tiles;
  if (threadIdx.x == 0) wstart[0] = 0;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, per = (G + 31) / 32;
    const int lo = 1 + lane * per, hi = min(G + 1, lo + per);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += wstart[i];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - sum;
    for (int i = lo; i < hi; ++i) {
      run += wstart[i];
      wstart[i] = run;
    }
  }
  __syncthreads();
}

// Work item w of that schedule: slot g (wstart[g] <= w < wstart[g + 1]),
// its valid row count mv, then the COLS-wide column tile n0 and, fastest,
// the 128-row tile m0.
template <int COLS>
__device__ __forceinline__ void row_tile_item(const int* wstart, int G, int w,
                                              const long long* rows, int M,
                                              int& g, int& mv, int& m0,
                                              int& n0) {
  int lo = 0, hi = G;   // wstart[lo] <= w < wstart[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (wstart[mid] <= w) lo = mid; else hi = mid;
  }
  g = lo;
  mv = valid_rows(rows, g, M);
  const int mt = (mv + BM - 1) / BM;
  const int r = w - wstart[g];
  m0 = (r % mt) * BM;
  n0 = (r / mt) * COLS;
}

// Rows [ceil(rows[g] / 64) 64, M) of every slot of out (G, M, N), and of
// out2 where it is not null, both contiguous, one range a slot, to zeros:
// the producer warpgroup's three idle warps of every block, 16-byte
// streaming stores (evict-first), so the zeros do not push the weight and
// activation panels out of L2.
__device__ __forceinline__ void zero_rows_past(bf16* out, bf16* out2,
                                               const long long* rows, int G,
                                               int M, int N) {
  const long long lanes = 96LL * gridDim.x;
  const long long me = 96LL * blockIdx.x + threadIdx.x - CONSUMERS * 128 - 32;
  const int4 z = make_int4(0, 0, 0, 0);
  for (int g = 0; g < G; ++g) {
    const int z0 = min(M, (valid_rows(rows, g, M) + 63) / 64 * 64);
    const long long base = (static_cast<long long>(g) * M + z0) * N;
    const long long n16 = static_cast<long long>(M - z0) * N / 8;
    int4* p = reinterpret_cast<int4*>(out + base);
    int4* p2 = reinterpret_cast<int4*>(out2 + base);
    for (long long i = me; i < n16; i += lanes) {
      __stcs(p + i, z);
      if (out2 != nullptr) __stcs(p2 + i, z);
    }
  }
}

// The k loop of one B1 item for one consumer warpgroup.  A full item: this
// warpgroup's 64 rows against w1's and w3's 128 columns in one m64n256
// product (the four B boxes side by side: acc[0] holds h, acc[1] g).  A
// NARROW item (at most 64 valid rows): both warpgroups take rows 0..63,
// warpgroup wg w1's and w3's 64 columns of box wg (two boxes 16 KB apart:
// one m64n128 product, acc[0] holding h's 64 columns, then g's), so the
// tile's last rows cost half an item.  Releases every stage it used.
template <bool NARROW>
__device__ __forceinline__ void swiglu_bwd_products(
    float (&acc)[2][64], uint32_t tiles_u, uint32_t full0, uint32_t empty0,
    int ktiles, int wg, bool active, int it, uint32_t dempty, int& stage,
    uint32_t& phase) {
  const int lane = threadIdx.x % 32, tid = threadIdx.x % 128;
  const int free_at = min(FREE_AT, ktiles - 1);
  int prev = 0;
  for (int t = 0; t < ktiles; ++t) {
    if (t > 0) mbar_wait(full0 + 8 * stage, phase);
    if (active) {
      const uint32_t st = tiles_u + stage * STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if constexpr (NARROW) {
          wgmma_m64n128k16<0, 1>(
              acc[0], desc_sw128(st + kk * 32, 16, 1024),
              desc_sw128(st + A_BYTES + wg * BOX_BYTES + kk * 2048,
                         2 * BOX_BYTES, 1024));
        } else {
          wgmma_m64n256k16<0, 1>(
              flat(acc), desc_sw128(st + wg * (64 * 128) + kk * 32, 16, 1024),
              desc_sw128(st + A_BYTES + kk * 2048, BOX_BYTES, 1024));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();   // the previous k-tile's products are done
    }
    if (t > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
    if (it > 0 && t == free_at && tid == 0) {
      // The previous tile's dh and dg stores have read their buffers: the
      // producer may refill the dact buffer.
      bulk_wait_read<0>();
      mbar_arrive(dempty);
    }
    prev = stage;
    advance(stage, phase);
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(empty0 + 8 * prev);
  fence_regs(acc[0]);
  fence_regs(acc[1]);
}

// B1: dh, dg (G, M, N) bf16 of out = silu(x w1) (x w3) for dact (G, M, N);
// x (G, M, K), w1 / w3 (G, K, N) N-major.  map_dact: 64 x 128 boxes;
// map_dh, map_dg: 64 x 64 boxes.  ZERO_PAD: rows past the walked row
// tiles are written as zeros.  `next`: an int zeroed before the launch,
// from which each block's producer takes its work items one at a time, so
// the items that share a weight panel start together (the hardware's
// order of blocks), whatever each block's earlier items cost.
template <bool ZERO_PAD>
__global__ void __launch_bounds__(THREADS, 1)
grouped_swiglu_bwd_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w1,
                          const __grid_constant__ CUtensorMap map_w3,
                          const __grid_constant__ CUtensorMap map_dact,
                          const __grid_constant__ CUtensorMap map_dh,
                          const __grid_constant__ CUtensorMap map_dg,
                          bf16* __restrict__ dh, bf16* __restrict__ dg,
                          const long long* __restrict__ rows,
                          int* __restrict__ next, int G, int M, int K, int N,
                          int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t tiles_u = smem_u32(tiles);
  // dact buffer: two 64-column boxes of 128 rows (dh is written back into
  // it); then dg's staging, the same layout.
  const uint32_t dact_u = tiles_u + P_STAGES * STAGE_BYTES;
  const uint32_t dgs_u = dact_u + 4 * SBOX;
  const uint32_t full0 = dgs_u + 4 * SBOX;
  const uint32_t empty0 = full0 + P_STAGES * 8;
  const uint32_t dfull = empty0 + P_STAGES * 8, dempty = dfull + 8;
  const uint32_t item0 = dempty + 8;   // the work item of each stage's tile
  int* wstart = reinterpret_cast<int*>(tiles + (item0 + 4 * P_STAGES -
                                                tiles_u));

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < P_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);   // one arrival per warp
    }
    mbar_init(dfull, 1);
    mbar_init(dempty, CONSUMERS);   // one arrival per consumer warpgroup
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  build_schedule(wstart, rows, G, M, n_tiles);
  const int n_work = wstart[G];
  const int ktiles = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  int stage = 0;
  uint32_t phase = 0;
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      // ---- producer.  Each tile's item id goes with its first stage (in
      // item0[stage], released by that stage's arrival); an id past the
      // last item, with an arrival and no loads, ends the consumers' loop.
      // The tile's dact block is loaded after k-step DACT_AT's stage: by
      // then both consumer warpgroups have passed k-step FREE_AT (the stage
      // it reuses was released after it), where they free the buffer from
      // the previous tile's dh store.
      const int dact_at = min(DACT_AT, ktiles - 1);
      int w = atomicAdd(next, 1);
      for (int it = 0;; ++it) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        st_shared_u32(item0 + 4 * stage, static_cast<uint32_t>(w));
        if (w >= n_work) {
          mbar_arrive(full0 + 8 * stage);
          break;
        }
        const int after = atomicAdd(next, 1);   // its latency runs under
        int g, mv, m0, n0;                      // this tile's loads
        row_tile_item<BN>(wstart, G, w, rows, M, g, mv, m0, n0);
        for (int t = 0; t < ktiles; ++t) {
          if (t > 0) mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t a = tiles_u + stage * STAGE_BYTES;
          const int k0 = t * BK;
          mbar_expect_tx(full, STAGE_BYTES);
          tma_load(a, &map_x, full, k0, m0, g);
          tma_load(a + A_BYTES, &map_w1, full, n0, k0, g);
          tma_load(a + A_BYTES + BOX_BYTES, &map_w1, full, n0 + 64, k0, g);
          tma_load(a + A_BYTES + B_BYTES, &map_w3, full, n0, k0, g);
          tma_load(a + A_BYTES + B_BYTES + BOX_BYTES, &map_w3, full, n0 + 64,
                   k0, g);
          advance(stage, phase);
          if (t == dact_at) {
            mbar_wait(dempty, (it & 1) ^ 1);
            mbar_expect_tx(dfull, 4 * SBOX);
            tma_load(dact_u, &map_dact, dfull, n0, m0, g);
            tma_load(dact_u + 2 * SBOX, &map_dact, dfull, n0 + 64, m0, g);
          }
        }
        w = after;
      }
    } else if (ZERO_PAD && threadIdx.x >= CONSUMERS * 128 + 32) {
      // ---- the producer warpgroup's other three warps: the rows past the
      // items (they store the rows before ceil(mv / 64) 64, a narrow last
      // item 64 of them) to zeros.
      zero_rows_past(dh, dg, rows, G, M, N);
    }
  } else {
    // ---- consumers.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, tid = threadIdx.x % 128;
    float acc[2][64];
    for (int it = 0;; ++it) {
      mbar_wait(full0 + 8 * stage, phase);   // the tile's first stage
      const int w = static_cast<int>(ld_shared_u32(item0 + 4 * stage));
      if (w >= n_work) break;
      int g, mv, m0, n0;
      row_tile_item<BN>(wstart, G, w, rows, M, g, mv, m0, n0);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.0f;
      const bool narrow = mv - m0 <= 64;
      if (narrow)
        swiglu_bwd_products<true>(acc, tiles_u, full0, empty0, ktiles, wg,
                                  true, it, dempty, stage, phase);
      else
        swiglu_bwd_products<false>(acc, tiles_u, full0, empty0, ktiles, wg,
                                   m0 + wg * 64 < mv, it, dempty, stage,
                                   phase);

      // Epilogue: dact from its buffer, dh back into it, dg into the
      // staging boxes (each element read and written by its own thread),
      // then this warpgroup's rows and columns of both leave by TMA (a
      // full item: its 64 rows x 128 columns; a narrow one: rows 0..63 x
      // its 64 columns).  Accumulator layout: value 4 j + {0, 1} at row
      // (warp % 4) * 16 + lane / 4, columns 8 j + 2 (lane % 4) + {0, 1};
      // 4 j + {2, 3} eight rows below.  Rows past the count are stored as
      // zeros, never multiplied.
      mbar_wait(dfull, it & 1);
      named_sync(WG_BAR + wg, 128);
      const int r0 = (narrow ? 0 : wg * 64) + (tid / 32) * 16 + lane / 4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        const bool keep = m0 + r < mv;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          // A narrow item has 8 column groups of h (acc[0][0..31]) and of
          // g (acc[0][32..63]); a full one 16 of each (acc[0], acc[1]:
          // flat 0..63 and 64..127).
          if (narrow && j >= 8) break;
          const int col = (narrow ? wg * 64 : 0) + 8 * j + 2 * (lane % 4);
          const uint32_t off = (col / 64) * 2 * SBOX + sw128(r, col % 64);
          const uint32_t raw = ld_shared_u32(dact_u + off);
          const float2 da =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
          const int i = 4 * j + 2 * half;
          const float h0 = acc[0][i], h1 = acc[0][i + 1];
          // (constant indices: a register array indexed at run time
          // would go to local memory)
          const float g0 = narrow ? flat(acc)[32 + i] : flat(acc)[64 + i];
          const float g1 = narrow ? flat(acc)[33 + i] : flat(acc)[65 + i];
          float dh0, dg0, dh1, dg1;
          swiglu_grad(h0, g0, da.x, dh0, dg0);
          swiglu_grad(h1, g1, da.y, dh1, dg1);
          st_shared_u32(dact_u + off, keep ? pack_bf16x2(dh0, dh1) : 0u);
          st_shared_u32(dgs_u + off, keep ? pack_bf16x2(dg0, dg1) : 0u);
        }
      }
      fence_proxy_async();
      named_sync(WG_BAR + wg, 128);
      if (tid == 0) {
        if (narrow) {
          tma_store(&map_dh, dact_u + wg * 2 * SBOX, n0 + 64 * wg, m0, g);
          tma_store(&map_dg, dgs_u + wg * 2 * SBOX, n0 + 64 * wg, m0, g);
        } else {
#pragma unroll
          for (int bx = 0; bx < 2; ++bx) {
            const uint32_t src = bx * 2 * SBOX + wg * SBOX;
            tma_store(&map_dh, dact_u + src, n0 + 64 * bx, m0 + 64 * wg, g);
            tma_store(&map_dg, dgs_u + src, n0 + 64 * bx, m0 + 64 * wg, g);
          }
        }
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait<0>();
  }
}

// The k loop of one B2 item for one consumer warpgroup.  WIDE: its 64
// rows against the tile's 256 columns, one m64n256 product a k-step (B
// K-major: the stage's 256 weight rows of 128 bytes, two TMA boxes side by
// side, no transpose bit).  Otherwise one m64n128 product on the A rows
// at a_off and the B rows (output columns) at b_off: a last column tile
// of at most 128 columns, or a narrow item's half of the columns.  total
// k-steps (NT2: those over (x, w1), then those over (x2, w3)); releases
// every stage it used.
template <bool WIDE>
__device__ __forceinline__ void matmul_nt_products(float (&acc)[2][64],
                                                   uint32_t tiles_u,
                                                   uint32_t full0,
                                                   uint32_t empty0, int total,
                                                   bool active,
                                                   uint32_t a_off,
                                                   uint32_t b_off, int& stage,
                                                   uint32_t& phase) {
  const int lane = threadIdx.x % 32;
  int prev = 0;
  for (int t = 0; t < total; ++t) {
    if (t > 0) mbar_wait(full0 + 8 * stage, phase);
    if (active) {
      const uint32_t st = tiles_u + stage * STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = desc_sw128(st + a_off + kk * 32, 16, 1024);
        const uint64_t db =
            desc_sw128(st + A_BYTES + b_off + kk * 32, 16, 1024);
        if constexpr (WIDE)
          wgmma_m64n256k16<0, 0>(flat(acc), da, db);
        else
          wgmma_m64n128k16<0, 0>(acc[0], da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();   // the previous k-step's products are done
    }
    if (t > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
    prev = stage;
    advance(stage, phase);
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(empty0 + 8 * prev);
  fence_regs(acc[0]);
  fence_regs(acc[1]);
}

// B2: out (G, M, N) = x w1^T (NT2: + x2 w3^T), x / x2 (G, M, K), w1 / w3
// stored (G, N, K) K-major; out bf16 contiguous through map_out (64 x 64
// boxes).  Work items as B1's (build_schedule, row_tile_item) with
// 256-column tiles, taken one at a time from the device counter `next`
// (zeroed before the launch).  ZERO_PAD: the rows past the walked row
// tiles are written as zeros.
template <bool NT2, bool ZERO_PAD>
__global__ void __launch_bounds__(THREADS, 1)
grouped_matmul_nt_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_x2,
                         const __grid_constant__ CUtensorMap map_w1,
                         const __grid_constant__ CUtensorMap map_w3,
                         const __grid_constant__ CUtensorMap map_out,
                         bf16* __restrict__ out,
                         const long long* __restrict__ rows,
                         int* __restrict__ next, int G, int M, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t tiles_u = smem_u32(tiles);
  const uint32_t out_u = tiles_u + P_STAGES * STAGE_BYTES;   // 8 boxes
  const uint32_t full0 = out_u + 8 * SBOX;
  const uint32_t empty0 = full0 + P_STAGES * 8;
  const uint32_t item0 = empty0 + P_STAGES * 8;   // each stage's item id
  int* wstart =
      reinterpret_cast<int*>(tiles + (item0 + 4 * P_STAGES - tiles_u));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < P_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  build_schedule(wstart, rows, G, M, (N + 2 * BN - 1) / (2 * BN));
  const int n_work = wstart[G];
  const int ktiles = (K + BK - 1) / BK;
  const int total = NT2 ? 2 * ktiles : ktiles;
  const int wg = threadIdx.x / 128;
  int stage = 0;
  uint32_t phase = 0;
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      // ---- producer: each item's id goes with its first stage (item0),
      // an id past the last item, with an arrival and no loads, ends the
      // consumers' loop.  The next item's loads start as soon as its
      // stages are free, under this item's epilogue.
      int w = atomicAdd(next, 1);
      for (;;) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        st_shared_u32(item0 + 4 * stage, static_cast<uint32_t>(w));
        if (w >= n_work) {
          mbar_arrive(full0 + 8 * stage);
          break;
        }
        const int after = atomicAdd(next, 1);   // its latency runs under
        int g, mv, m0, n0;                      // this item's loads
        row_tile_item<2 * BN>(wstart, G, w, rows, M, g, mv, m0, n0);
        const bool two = n0 + BN < N;   // the second 128 columns hold any
        for (int t = 0; t < total; ++t) {
          if (t > 0) mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t a = tiles_u + stage * STAGE_BYTES;
          const bool second = NT2 && t >= ktiles;
          const int k0 = (second ? t - ktiles : t) * BK;
          const CUtensorMap* mw = second ? &map_w3 : &map_w1;
          mbar_expect_tx(full, two ? STAGE_BYTES : A_BYTES + B_BYTES);
          tma_load(a, second ? &map_x2 : &map_x, full, k0, m0, g);
          tma_load(a + A_BYTES, mw, full, k0, n0, g);
          if (two) tma_load(a + A_BYTES + B_BYTES, mw, full, k0, n0 + BN, g);
          advance(stage, phase);
        }
        w = after;
      }
    } else if (ZERO_PAD && threadIdx.x >= CONSUMERS * 128 + 32) {
      zero_rows_past(out, nullptr, rows, G, M, N);
    }
  } else {
    // ---- consumers: 64 rows each (a narrow item: the same 64 rows, each
    // warpgroup 128 of the 256 columns).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, tid = threadIdx.x % 128;
    const uint32_t my_out = out_u + wg * 4 * SBOX;   // 64 rows x 256 columns
    float acc[2][64];
    for (;;) {
      mbar_wait(full0 + 8 * stage, phase);   // the item's first stage
      const int w = static_cast<int>(ld_shared_u32(item0 + 4 * stage));
      if (w >= n_work) break;
      int g, mv, m0, n0;
      row_tile_item<2 * BN>(wstart, G, w, rows, M, g, mv, m0, n0);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.0f;
      const bool two = n0 + BN < N;
      const bool narrow = two && mv - m0 <= 64;
      const bool active = narrow || m0 + wg * 64 < mv;
      if (two && !narrow)
        matmul_nt_products<true>(acc, tiles_u, full0, empty0, total, true,
                                 wg * (64 * 128), 0, stage, phase);
      else
        matmul_nt_products<false>(acc, tiles_u, full0, empty0, total, active,
                                  narrow ? 0 : wg * (64 * 128),
                                  narrow ? wg * B_BYTES : 0, stage, phase);
      if (!active) continue;   // its 64 rows are past the count

      // Epilogue: bf16 into this warpgroup's staging boxes (64 rows x 64
      // columns each, swizzled), then one thread's TMA stores.  The
      // previous item's stores must have read the boxes.  Accumulator
      // layout: value 4 j + {0, 1} at row (warp % 4) * 16 + lane / 4,
      // columns 8 j + 2 (lane % 4) + {0, 1}; 4 j + {2, 3} eight rows
      // below; acc[1] is columns 128..255.  So a warp's rows of column
      // block j are two 8 x 8 matrices in the mma fragment layout (values
      // 4 j, 4 j + 1 and 4 j + 2, 4 j + 3), and stmatrix stores blocks j
      // and j + 1 at once.  Rows past the count are stored as zeros,
      // never multiplied.
      if (tid == 0) bulk_wait_read<0>();
      named_sync(WG_BAR + wg, 128);
      const int r0 = (tid / 32) * 16 + lane / 4;      // this thread's rows
      const int row0 = m0 + (narrow ? 0 : wg * 64);   // the rows' first
      const bool keep0 = row0 + r0 < mv, keep1 = row0 + r0 + 8 < mv;
      // The row and column block this lane addresses: matrix lane / 8 is
      // (block j or j + 1) x (rows 0-7 or 8-15 of the warp's 16).
      const int arow = (tid / 32) * 16 + lane % 8 + 8 * ((lane / 8) % 2);
      const int acol = 8 * (lane / 16);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (b == 1 && (narrow || !two)) break;
#pragma unroll
        for (int j = 0; j < 16; j += 2) {
          const int col = b * BN + 8 * j + acol;
          const int i = 4 * j;
          stmatrix_x4(
              my_out + (col / 64) * SBOX + sw128(arow, col % 64),
              keep0 ? pack_bf16x2(acc[b][i], acc[b][i + 1]) : 0u,
              keep1 ? pack_bf16x2(acc[b][i + 2], acc[b][i + 3]) : 0u,
              keep0 ? pack_bf16x2(acc[b][i + 4], acc[b][i + 5]) : 0u,
              keep1 ? pack_bf16x2(acc[b][i + 6], acc[b][i + 7]) : 0u);
        }
      }
      fence_proxy_async();
      named_sync(WG_BAR + wg, 128);
      if (tid == 0) {
        const int c0 = n0 + (narrow ? wg * BN : 0);
        const int boxes = (two && !narrow) ? 4 : 2;
        for (int bx = 0; bx < boxes && c0 + 64 * bx < N; ++bx)
          tma_store(&map_out, my_out + bx * SBOX, c0 + 64 * bx, row0, g);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait<0>();
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

// x (G, M, K) with strides (sxg, sxm); w1 / w3 (G, K, N) N-major with
// strides (swg, swk).
template <int MODE>
int launch_bf16(const void* x, const void* w1, const void* w3, void* out,
                const long long* rows, int G, int M, int K, int N, int n_out,
                long long sxg, long long sxm, long long swg, long long swk,
                cudaStream_t stream) {
  CUtensorMap mx, mw1, mw3;
  int err = make_map(&mx, x, K, M, G, sxm, sxg, BM);
  if (!err) err = make_map(&mw1, w1, N, K, G, swk, swg, BK);
  if (!err) err = make_map(&mw3, w3, N, K, G, swk, swg, BK);
  if (err) return err;
  auto kernel = grouped_gemm_wgmma_kernel<MODE>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool swi = MODE == MODE_SWIGLU;
  const int out_cols = swi ? BN : 2 * BN;
  const int n_tiles = (N + out_cols - 1) / out_cols;
  const int m_tiles = (M + BM - 1) / BM;
  const long long blocks = static_cast<long long>(G) * n_tiles * m_tiles;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES, stream>>>(
      mx, mw1, mw3, static_cast<bf16*>(out), rows, M, K, n_out,
      n_tiles, m_tiles,
      static_cast<long long>(M) * n_out, n_out);
  return static_cast<int>(cudaGetLastError());
}

// One block an SM: the persistent kernels' grid.
int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

// B1.  x (G, M, K) with strides (sxg, sxm); w1 / w3 (G, K, N) N-major with
// strides (swg, swk); dact, dh, dg (G, M, N) contiguous; next: an int
// zeroed before the launch.
template <bool ZERO_PAD>
int launch_swiglu_bwd(const void* x, const void* w1, const void* w3,
                      void* dh, void* dg, const void* dact,
                      const long long* rows, int* next, int G, int M, int K,
                      int N, long long sxg, long long sxm, long long swg,
                      long long swk, cudaStream_t stream) {
  const long long sog = static_cast<long long>(M) * N;
  CUtensorMap mx, mw1, mw3, mda, mdh, mdg;
  int err = make_map(&mx, x, K, M, G, sxm, sxg, BM);
  if (!err) err = make_map(&mw1, w1, N, K, G, swk, swg, BK);
  if (!err) err = make_map(&mw3, w3, N, K, G, swk, swg, BK);
  if (!err) err = make_map(&mda, dact, N, M, G, N, sog, BM);
  if (!err) err = make_map(&mdh, dh, N, M, G, N, sog, 64);
  if (!err) err = make_map(&mdg, dg, N, M, G, N, sog, 64);
  int sms = 0;
  if (!err) err = sm_count(&sms);
  if (err) return err;
  const int smem = SMEM_PERSISTENT + 4 * (G + 1);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = grouped_swiglu_bwd_kernel<ZERO_PAD>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<sms, THREADS, smem, stream>>>(
      mx, mw1, mw3, mda, mdh, mdg, static_cast<bf16*>(dh),
      static_cast<bf16*>(dg), rows, next, G, M, K, N, (N + BN - 1) / BN);
  return static_cast<int>(cudaGetLastError());
}

// B2.  x, x2 (G, M, K) with strides (sxg, sxm); w1, w3 (G, N, K) K-major
// with strides (swg, swn); out (G, M, N) contiguous; next: an int zeroed
// before the launch.
template <bool NT2, bool ZERO_PAD>
int launch_matmul_nt(const void* x, const void* x2, const void* w1,
                     const void* w3, void* out, const long long* rows,
                     int* next, int G, int M, int K, int N, long long sxg,
                     long long sxm, long long swg, long long swn,
                     cudaStream_t stream) {
  CUtensorMap mx, mx2, mw1, mw3, mo;
  int err = make_map(&mx, x, K, M, G, sxm, sxg, BM);
  if (!err) err = make_map(&mx2, x2, K, M, G, sxm, sxg, BM);
  if (!err) err = make_map(&mw1, w1, K, N, G, swn, swg, BN);
  if (!err) err = make_map(&mw3, w3, K, N, G, swn, swg, BN);
  if (!err)
    err = make_map(&mo, out, N, M, G, N, static_cast<long long>(M) * N, 64);
  int sms = 0;
  if (!err) err = sm_count(&sms);
  if (err) return err;
  const int smem = SMEM_PERSISTENT + 4 * (G + 1);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = grouped_matmul_nt_kernel<NT2, ZERO_PAD>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<sms, THREADS, smem, stream>>>(mx, mx2, mw1, mw3, mo,
                                         static_cast<bf16*>(out), rows, next,
                                         G, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- fp32 / 3xTF32 mma.sync

constexpr int F_BM = 128;             // rows per block: 4 warps of 32
constexpr int F_BK = 32;              // 32 fp32 = one 128-byte swizzle row
constexpr int F_STAGES = 5;
constexpr int F_WARPS = 8;            // 4 (rows) x 2 (columns)
constexpr int F_THREADS = F_WARPS * 32;
constexpr int F_A_BYTES = F_BM * F_BK * 4;         // 16 KB
constexpr int F_BOX_BYTES = F_BK * 32 * 4;         // 4 KB: 32 K x 32 N
constexpr int F_STAGE_BYTES = F_A_BYTES + 4 * F_BOX_BYTES;   // 32 KB
constexpr int F_SMEM_BYTES = F_STAGES * F_STAGE_BYTES + 1024 + 2 * F_STAGES * 8;

// The K loop of one consumer warp: 32 rows (NMF of its two 16-row
// fragments hold valid rows) x two 32-column weight boxes of the stage
// (SwiGLU: w1 and w3 over the same columns; matmul: two neighbouring
// boxes), 3xTF32 on mma.sync m16n8k8.
//
// Fragments from the 128-byte-swizzled tiles (16-byte chunk j of row r
// sits at chunk j ^ (r % 8)):
//   * A by ldmatrix.x4, one per 16 x 8 fragment (rows of 32-bit words:
//     lane t gets element (t / 4, t % 4) of each 8 x 4 block); the eight
//     rows of each block fall on eight chunks, so no bank conflicts.
//   * B by one 16-byte load per (k row, box): lane (gid, tq) reads chunk
//     c(gid) = 4 (gid % 2) + gid / 2 of rows kk * 8 + tq and + tq + 4, and
//     element nb of those four floats is its b0 / b1 of the n-step nb.  So
//     mma column gid of n-step nb is box column 4 c(gid) + nb; the eight
//     lanes of each quarter warp read eight distinct chunks.  The output
//     follows: a thread's c0 (c1) of n-steps 0..3 are box columns 4 tq ..
//     4 tq + 3 (16 + 4 tq ..), one 16-byte store each.
// Each stage's twelve products per output (4 k-steps x 3) chain in fresh
// registers, small terms first, and are added to acc in fp32: the tensor
// core truncates as it accumulates, so one chain over all of K could lose
// an ulp at each of its 3 K / 8 steps (1,536 at K 4096: about 1e-4 of the
// sum, the tolerance).
struct F32Ring {
  const CUtensorMap *x, *w1, *w3;
  const unsigned char* tiles;          // the stages, 1024-byte aligned
  uint32_t tiles_u, full0, empty0;     // their shared address; barriers
  int m0, n0, g, ktiles;
};

// Start the loads of K tile u into stage u % F_STAGES once every warp has
// released the tile that stage held (u - F_STAGES): the x tile and four
// weight boxes, w1 | w1 | w3 | w3 (SwiGLU) or four neighbours of w.
template <bool SWIGLU>
__device__ __forceinline__ void load_stage_f32(const F32Ring& r, int u) {
  const int stage = u % F_STAGES;
  mbar_wait(r.empty0 + 8 * stage, ((u / F_STAGES) & 1) ^ 1);
  const uint32_t full = r.full0 + 8 * stage;
  const uint32_t a = r.tiles_u + stage * F_STAGE_BYTES;
  const int k0 = u * F_BK;
  mbar_expect_tx(full, F_STAGE_BYTES);
  tma_load(a, r.x, full, k0, r.m0, r.g);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const CUtensorMap* map = (SWIGLU && b >= 2) ? r.w3 : r.w1;
    const int col = r.n0 + 32 * (SWIGLU ? b % 2 : b);
    tma_load(a + F_A_BYTES + b * F_BOX_BYTES, map, full, col, k0, r.g);
  }
}

template <int NMF, bool SWIGLU>
__device__ __forceinline__ void consume_f32(float (&acc)[2][2][4][4],
                                            const F32Ring& r, bool producer,
                                            int wm, int wn, int lane) {
  const int gid = lane / 4, tq = lane % 4;
  // ldmatrix: lane gives row (lane % 8) + 8 ((lane / 8) % 2) of the
  // fragment and chunk 2 kk + lane / 16; the row's swizzle is lane % 8.
  const uint32_t a_row =
      (wm * 32 + (lane & 7) + ((lane >> 3) & 1) * 8) * 128;
  const int a_chunk = lane >> 4, a_sw = lane & 7;
  const int cg = ((gid & 1) << 2) | (gid >> 1);
  const int b_off0 = tq * 128 + ((cg ^ tq) << 4);
  const int b_off1 = (tq + 4) * 128 + ((cg ^ (tq + 4)) << 4);
  const int box[2] = {SWIGLU ? wn : 2 * wn, SWIGLU ? 2 + wn : 2 * wn + 1};
  int stage = 0;
  uint32_t phase = 0;
  for (int t = 0; t < r.ktiles; ++t) {
    mbar_wait(r.full0 + 8 * stage, phase);
    const uint32_t a_u = r.tiles_u + stage * F_STAGE_BYTES + a_row;
    const unsigned char* b_p = r.tiles + stage * F_STAGE_BYTES + F_A_BYTES;
    float part[NMF][2][4][4];
#pragma unroll
    for (int mf = 0; mf < NMF; ++mf)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mf][b][nb][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < F_BK / 8; ++kk) {
      unsigned ah[NMF][4], al[NMF][4];
#pragma unroll
      for (int mf = 0; mf < NMF; ++mf) {
        unsigned a[4];
        ldsm_x4(a, a_u + mf * 16 * 128 + (((2 * kk + a_chunk) ^ a_sw) << 4));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(__uint_as_float(a[i]), ah[mf][i], al[mf][i]);
      }
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const unsigned char* bp = b_p + box[b] * F_BOX_BYTES + kk * 8 * 128;
        const float4 v0 = *reinterpret_cast<const float4*>(bp + b_off0);
        const float4 v1 = *reinterpret_cast<const float4*>(bp + b_off1);
        const float k0[4] = {v0.x, v0.y, v0.z, v0.w};
        const float k1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          unsigned bh[2], bl[2];
          split_tf32(k0[nb], bh[0], bl[0]);
          split_tf32(k1[nb], bh[1], bl[1]);
#pragma unroll
          for (int mf = 0; mf < NMF; ++mf)
            mma_3xtf32(part[mf][b][nb], part[mf][b][nb], ah[mf], al[mf], bh,
                       bl);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(r.empty0 + 8 * stage);   // shared reads done
#pragma unroll
    for (int mf = 0; mf < NMF; ++mf)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mf][b][nb][e] += part[mf][b][nb][e];
    // The stage released one tile ago (by the other warps too, by now)
    // takes the tile F_STAGES - 1 ahead.
    if (producer && t + F_STAGES - 1 < r.ktiles)
      load_stage_f32<SWIGLU>(r, t + F_STAGES - 1);
    if (++stage == F_STAGES) { stage = 0; phase ^= 1; }
  }
}

// out: (G, M, n_out) fp32 with n_out = N rounded up to 4 (the wrapper
// returns the first N columns); som = n_out, sog = M * n_out.
template <bool SWIGLU>
__global__ void __launch_bounds__(F_THREADS, 1)
grouped_gemm_tf32_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w1,
                         const __grid_constant__ CUtensorMap map_w3,
                         float* __restrict__ out,
                         const long long* __restrict__ rows, int M, int K,
                         int n_out, int n_tiles, int m_tiles, long long sog,
                         long long som) {
  constexpr int OUT_COLS = SWIGLU ? 64 : 128;
  extern __shared__ unsigned char smem_raw[];

  const int mt = blockIdx.x % m_tiles;
  const int nt = (blockIdx.x / m_tiles) % n_tiles;
  const int g = blockIdx.x / (m_tiles * n_tiles);
  const int m0 = mt * F_BM, n0 = nt * OUT_COLS;
  const int mv = valid_rows(rows, g, M);
  float* outg = out + g * sog;

  if (m0 >= mv) {   // no valid row in this tile: zeros, no weight bytes
    zero_tile(outg, som, m0, min(F_BM, M - m0), n0, min(OUT_COLS, n_out - n0));
    return;
  }

  unsigned char* tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t tiles_u = smem_u32(tiles);
  const F32Ring ring{&map_x, &map_w1, &map_w3, tiles, tiles_u,
                     tiles_u + F_STAGES * F_STAGE_BYTES,
                     tiles_u + F_STAGES * F_STAGE_BYTES + F_STAGES * 8,
                     m0, n0, g, (K + F_BK - 1) / F_BK};
  // Row warps whose 32 rows are all past the count take no part in the
  // ring: they write their zeros only.
  const int m_warps = min(F_WARPS / 2, (mv - m0 + 31) / 32);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(ring.full0 + 8 * s, 1);
      mbar_init(ring.empty0 + 8 * s, 2 * m_warps);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Thread 0 (of row warp 0, always active) is also the producer: the
  // first F_STAGES - 1 tiles now, one more after each tile it consumes.
  if (threadIdx.x == 0)
    for (int u = 0; u < min(F_STAGES - 1, ring.ktiles); ++u)
      load_stage_f32<SWIGLU>(ring, u);

  // Warp (wm, wn) owns rows m0 + 32 wm .. + 31.  The two column warps of
  // a row warp are neighbours, so they sit on two SM sub-partitions (warp
  // % 4) when only row warp 0 has rows, as at decode.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int r0 = m0 + wm * 32;
  float acc[2][2][4][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mf][b][nb][e] = 0.0f;
  if (wm < m_warps) {
    const bool producer = threadIdx.x == 0;
    if (mv - r0 > 16)
      consume_f32<2, SWIGLU>(acc, ring, producer, wm, wn, lane);
    else   // the second fragment holds no valid row: half the products
      consume_f32<1, SWIGLU>(acc, ring, producer, wm, wn, lane);
  }

  // Epilogue: c0 / c1 / c2 / c3 of n-step nb at (row gid, box column
  // 4 tq + nb) / (gid, 16 + 4 tq + nb) / (gid + 8, ..) / (gid + 8, ..);
  // rows past the count are selected to zero, never multiplied.
  const int gid = lane / 4, tq = lane % 4;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + mf * 16 + gid + 8 * (e >> 1);
      if (r >= M) continue;
      float* orow = outg + r * som;
      const bool keep = r < mv;
#pragma unroll
      for (int b = 0; b < (SWIGLU ? 1 : 2); ++b) {
        const int c = n0 + (SWIGLU ? 32 : 64) * wn + 32 * b + 16 * (e & 1) +
                      4 * tq;
        if (c >= n_out) continue;
        const float(&v)[4][4] = acc[mf][b];
        float4 o;
        if constexpr (SWIGLU) {
          const float(&w)[4][4] = acc[mf][1];
          o = make_float4(
              silu_mul(v[0][e], w[0][e]), silu_mul(v[1][e], w[1][e]),
              silu_mul(v[2][e], w[2][e]), silu_mul(v[3][e], w[3][e]));
        } else {
          o = make_float4(v[0][e], v[1][e], v[2][e], v[3][e]);
        }
        *reinterpret_cast<float4*>(orow + c) = keep ? o : zero4;
      }
    }
}

template <bool SWIGLU>
int launch_f32(const void* x, const void* w1, const void* w3, void* out,
               const long long* rows, int G, int M, int K, int N, int n_out,
               long long sxg, long long sxm, long long swg, long long swk,
               cudaStream_t stream) {
  CUtensorMap mx, mw1, mw3;
  int err = make_map_3d(&mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, K, M, G,
                        sxm, sxg, 32, F_BM);
  if (!err)
    err = make_map_3d(&mw1, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w1, N, K, G,
                      swk, swg, 32, F_BK);
  if (!err)
    err = make_map_3d(&mw3, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w3, N, K, G,
                      swk, swg, 32, F_BK);
  if (err) return err;
  auto kernel = grouped_gemm_tf32_kernel<SWIGLU>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int out_cols = SWIGLU ? 64 : 128;
  const int n_tiles = (N + out_cols - 1) / out_cols;
  const int m_tiles = (M + F_BM - 1) / F_BM;
  const long long blocks = static_cast<long long>(G) * n_tiles * m_tiles;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), F_THREADS, F_SMEM_BYTES, stream>>>(
      mx, mw1, mw3, static_cast<float*>(out), rows, M, K, n_out, n_tiles,
      m_tiles, static_cast<long long>(M) * n_out, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = fp32, 1 = bf16.
// swiglu: 1 -> out = silu(x @ w1) * (x @ w3); 0 -> out = x @ w1 (w3 unused).
// rows: (G,) int64 valid-row counts on the device, or null for M.
// Strides are in elements; the last dimension of every operand is unit
// stride, and bases and outer strides are 16-byte aligned (TMA).  out is
// contiguous, of width n_out = N rounded up to 16 bytes (8 bf16, 4 fp32).
// Launches on `stream`, does not synchronise, and returns the launch's
// CUDA error code (0 = launched; 1000 and up: a tensor map could not be
// made).
extern "C" int grouped_gemm_launch(int dtype, int swiglu, const void* x,
                                   const void* w1, const void* w3, void* out,
                                   const long long* rows, int G, int M, int K,
                                   int N, int n_out, long long sxg,
                                   long long sxm, long long swg, long long swk,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && swiglu)
    return launch_bf16<MODE_SWIGLU>(x, w1, w3, out, rows, G, M, K, N, n_out,
                                    sxg, sxm, swg, swk, s);
  if (dtype == 1)
    return launch_bf16<MODE_MATMUL>(x, w1, w1, out, rows, G, M, K, N, n_out,
                                    sxg, sxm, swg, swk, s);
  if (dtype == 0 && swiglu)
    return launch_f32<true>(x, w1, w3, out, rows, G, M, K, N, n_out, sxg,
                            sxm, swg, swk, s);
  if (dtype == 0)
    return launch_f32<false>(x, w1, w1, out, rows, G, M, K, N, n_out, sxg,
                             sxm, swg, swk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// B2: out = x w1^T (dual: + x2 w3^T), each slot's valid rows, bf16.  x,
// x2 (G, M, K) with strides (sxg, sxm); w1, w3 stored (G, N, K),
// K-major, with strides (swg, swn); out (G, M, N) contiguous; next: an
// int on the device, zeroed before the launch.  zero_pad 1: rows past the
// count are exact zeros; 0: rows at or past the count rounded up to 64
// are left unwritten.  Same conventions as grouped_gemm_launch.
extern "C" int grouped_matmul_nt_launch(int zero_pad, int dual,
                                        const void* x, const void* x2,
                                        const void* w1, const void* w3,
                                        void* out, const long long* rows,
                                        int* next, int G, int M, int K, int N,
                                        long long sxg, long long sxm,
                                        long long swg, long long swn,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dual && zero_pad)
    return launch_matmul_nt<true, true>(x, x2, w1, w3, out, rows, next,
                                             G, M, K, N, sxg, sxm, swg, swn,
                                             s);
  if (dual)
    return launch_matmul_nt<true, false>(x, x2, w1, w3, out, rows, next,
                                              G, M, K, N, sxg, sxm, swg, swn,
                                              s);
  if (zero_pad)
    return launch_matmul_nt<false, true>(x, x, w1, w1, out, rows, next,
                                              G, M, K, N, sxg, sxm, swg, swn,
                                              s);
  return launch_matmul_nt<false, false>(x, x, w1, w1, out, rows, next,
                                             G, M, K, N, sxg, sxm, swg, swn,
                                             s);
}

// (dh, dg) of out = silu(x w1) (x w3) for the upstream gradient dact, all
// three (G, M, N) contiguous; x (G, M, K) with strides (sxg, sxm); w1, w3
// (G, K, N) N-major with strides (swg, swk); next: an int on the device,
// zeroed before the launch.  zero_pad 1: rows past the count are exact
// zeros; 0: rows at or past the count rounded up to 64 are left
// unwritten.
extern "C" int grouped_swiglu_bwd_launch(int zero_pad, const void* x,
                                         const void* w1, const void* w3,
                                         void* dh, void* dg, const void* dact,
                                         const long long* rows, int* next,
                                         int G, int M, int K, int N,
                                         long long sxg, long long sxm,
                                         long long swg, long long swk,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (zero_pad)
    return launch_swiglu_bwd<true>(x, w1, w3, dh, dg, dact, rows, next, G, M,
                                   K, N, sxg, sxm, swg, swk, s);
  return launch_swiglu_bwd<false>(x, w1, w3, dh, dg, dact, rows, next, G, M,
                                  K, N, sxg, sxm, swg, swk, s);
}

// dW = x^T d per slot over its valid rows: x (G, M, Kd), d (G, M, N) bf16
// with unit-stride last dims and strides (sxg, sxm), (sdg, sdm); out
// (G, Kd, N) contiguous bf16.  rows: (G,) int64 on the device, or null
// for M.
extern "C" int grouped_wgrad_launch(const void* x, const void* d, void* out,
                                    const long long* rows, int G, int M,
                                    int Kd, int N, long long sxg,
                                    long long sxm, long long sdg,
                                    long long sdm, void* stream) {
  CUtensorMap mx, md, mo;
  int err = make_map(&mx, x, Kd, M, G, sxm, sxg, BK);
  if (!err) err = make_map(&md, d, N, M, G, sdm, sdg, BK);
  if (!err)
    err = make_map(&mo, out, N, Kd, G, N, static_cast<long long>(Kd) * N, 64);
  int sms = 0;
  if (!err) err = sm_count(&sms);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      grouped_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_PERSISTENT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int k_tiles = (Kd + BM - 1) / BM;
  const int n_tiles = (N + 2 * BN - 1) / (2 * BN);
  const long long n_work = static_cast<long long>(G) * k_tiles * n_tiles;
  if (n_work > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_work < sms ? n_work : sms);
  grouped_wgrad_kernel<<<grid, THREADS, SMEM_PERSISTENT,
                         static_cast<cudaStream_t>(stream)>>>(
      mx, md, mo, rows, M, N, k_tiles, n_tiles, static_cast<int>(n_work));
  return static_cast<int>(cudaGetLastError());
}
