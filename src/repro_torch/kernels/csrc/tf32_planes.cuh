// TF32 hi / lo planes for the 3xTF32 products on TF32 wgmma (the fp32
// grouped backward, grouped_gemm_bwd_f32.cu), and the TF32 wgmma product
// that reads them.  The mma.sync kernels split each fragment as they read
// it (warp_mma.cuh split_tf32): for them planes were measured slower
// (flash_attention_bwd_mma.cu's header).
//
// 3xTF32: an fp32 value x is hi + lo, hi being x with its 13 low mantissa
// bits cleared (a TF32 value) and lo = x - hi, whose own low bits the
// tensor core ignores; a b = a_lo b_hi + a_hi b_lo + a_hi b_hi keeps each
// product to about 2^-20 of its size (warp_mma.cuh split_tf32).  Here an
// fp32 tile that has landed in shared memory is split once per block,
// each element once, into a hi plane and a lo plane in the layout that
// the consuming product reads, so no warp splits a value as it reads it
// and no two warps split the same one.
//
// Layouts.
//  * K-major plane with the 128-byte swizzle (TF32 wgmma's only layout for
//    an operand in shared memory: K-major, no transpose bit): R rows of 32
//    floats (128 bytes), 16-byte chunk c of row r stored at chunk
//    c ^ (r % 8), regions on 1024 bytes; a wgmma descriptor
//    desc_sw128(addr, 16, 1024) (hopper_tma.cuh) and 32 bytes a k8 step.
//    sw128(r, c) is a chunk's float offset.
//  * split_rows: a landed tile of R rows x 32 contraction values, rows
//    `ld` floats apart, into swizzled K-major planes.
//  * split_transposed: a landed tile of 32 contraction rows x C columns,
//    rows `ld` floats apart, into C plane rows of 32 contraction values:
//    the plane a product needs where the operand is stored with its
//    contraction down the columns.  A warp reads 32 consecutive floats of
//    a landed row at a time, so any `ld` is free of bank conflicts.
// Built with -I on this directory (kernels/build.py), which also hashes
// this header into every library's name.

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ void split4(float4 v, float4& hi, float4& lo) {
  hi.x = __uint_as_float(__float_as_uint(v.x) & 0xffffe000u);
  hi.y = __uint_as_float(__float_as_uint(v.y) & 0xffffe000u);
  hi.z = __uint_as_float(__float_as_uint(v.z) & 0xffffe000u);
  hi.w = __uint_as_float(__float_as_uint(v.w) & 0xffffe000u);
  lo = make_float4(v.x - hi.x, v.y - hi.y, v.z - hi.z, v.w - hi.w);
}

// Float offset of 16-byte chunk c (0-7) of row r in a swizzled K-major
// plane.
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 32 + ((c ^ (r & 7)) << 2);
}

// A landed R x 32 tile, rows ld floats apart, into hi and lo swizzled
// K-major planes of R rows.  A quarter-warp reads one row's 8 chunks and
// writes them to 8 distinct chunks of that row.
template <int R>
__device__ __forceinline__ void split_rows(const float* land, int ld,
                                           float* hi, float* lo, int tid,
                                           int nthr) {
  for (int i = tid; i < R * 8; i += nthr) {
    const int r = i >> 3, c = i & 7;
    float4 h, l;
    split4(*reinterpret_cast<const float4*>(land + r * ld + 4 * c), h, l);
    *reinterpret_cast<float4*>(hi + sw128(r, c)) = h;
    *reinterpret_cast<float4*>(lo + sw128(r, c)) = l;
  }
}

// A landed 32 x C tile (32 contraction rows, ld floats apart) into hi and
// lo swizzled K-major planes of C rows x 32.  A warp takes 32 consecutive
// plane rows of one chunk: its reads are 32 consecutive floats of each of
// 4 landed rows, its 16-byte writes 8 distinct chunks a quarter-warp.
template <int C>
__device__ __forceinline__ void split_transposed(const float* land, int ld,
                                                 float* hi, float* lo,
                                                 int tid, int nthr) {
  for (int i = tid; i < C * 8; i += nthr) {
    const int n = i % C, c = i / C;
    const float* p = land + 4 * c * ld + n;
    float4 h, l;
    split4(make_float4(p[0], p[ld], p[2 * ld], p[3 * ld]), h, l);
    const int at = sw128(n, c);
    *reinterpret_cast<float4*>(hi + at) = h;
    *reinterpret_cast<float4*>(lo + at) = l;
  }
}

// d (64 x 128) = A (64 x 8, TF32 fragments in registers: value e of lane
// l of warp w at row 16 w + l / 4 + 8 (e % 2), column l % 4 + 4 (e / 2),
// as mma.sync m16n8k8's) @ B (8 x 128, K-major in shared memory), plus d
// unless scale_d is 0.
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
                                                   const unsigned (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

}  // namespace
