// Device helpers shared by the grouped GEMM kernels (grouped_gemm.cu and
// grouped_gemm_q8.cu): the SwiGLU epilogue and a slot's valid row count.

#pragma once

namespace {

__device__ __forceinline__ float silu_mul(float h, float g) {
  return h * (1.0f / (1.0f + expf(-h))) * g;
}

// Rows of slot g to compute: min(rows[g], M), clamped at 0; M for null.
__device__ __forceinline__ int valid_rows(const long long* rows, int g,
                                          int M) {
  if (rows == nullptr) return M;
  const long long r = rows[g];
  return r <= 0 ? 0 : (r >= M ? M : static_cast<int>(r));
}

}  // namespace
