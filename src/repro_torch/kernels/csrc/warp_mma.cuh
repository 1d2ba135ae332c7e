// Warp-level helpers shared by the mma.sync kernels (flash_attention.cu,
// ssd_scan.cu, grouped_gemm.cu): 16-byte cp.async pieces, ldmatrix, the
// bf16 and TF32 m16n8 products, the splits of fp32 values into two parts
// for them, and the 3xTF32 product built from those.
// Built with -I on this directory (kernels/build.py), which also hashes
// this header into every library's name.

#pragma once

#include <cuda_bf16.h>

namespace {

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

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// Four 8 x 8 bf16 matrices, transposed: lanes 8i .. 8i + 7 give the row
// addresses of matrix i, and lane t receives elements (2 (t % 4), t / 4)
// and (2 (t % 4) + 1, t / 4) of each, the B fragment of m16n8k16.
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Four 8 x 8 b16 matrices from shared address `addr` (lanes 8i .. 8i + 7
// give the 16-byte row addresses of matrix i): lane t receives 32-bit word
// t % 4 of row t / 4 of each.  On rows of fp32 values that is element
// (t / 4, t % 4) of an 8 x 4 block, the layout of an m16n8k8 .tf32 A
// fragment.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (a, b) = hi + lo as two bf16 pairs (a in the low half), each rounded to
// nearest: |v - hi - lo| <= 2^-18 |v|.  A product of two such splits that
// drops lo x lo keeps each term to about 2^-17 (fp32 keeps 2^-24).
__device__ __forceinline__ void split_bf16x2(float a, float b, unsigned& hi,
                                             unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// x = hi + lo as two operands of an m16n8k8 .tf32 product: hi is x with
// its 13 low mantissa bits cleared (a TF32 value), lo = x - hi exactly,
// whose own low bits the tensor core ignores: |x - hi - lo_tf32| <
// 2^-20 |x|.  Two instructions, where two roundings (cvt.rna) take more.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b in 3xTF32: big += a_hi b_hi, small += a_lo b_hi + a_hi b_lo (the
// a_lo b_lo term, below 2^-20 of the product, is dropped).  The tensor
// core truncates as it accumulates, so the caller keeps each chain short
// or the large terms apart from the small ones; big and small may be the
// same registers.
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  mma_tf32(small, al, bh[0], bh[1]);
  mma_tf32(small, ah, bl[0], bl[1]);
  mma_tf32(big, ah, bh[0], bh[1]);
}

}  // namespace
