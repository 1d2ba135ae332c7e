// Fused router top-k for Hopper (sm_90a): scores, selection and histogram.
//
// Replaces the Pallas kernel repro/kernels/gating_topk/kernel.py:
//   gating_topk_pallas -> for each token row t of logits (T, E) fp32:
//       scores[t]  = softmax(logits[t]) or sigmoid(logits[t])
//       k rounds of: a = argmax(s) (the lowest index among equal
//       maxima, as lax.top_k and argmax), ids[t, i] = a,
//       weights[t, i] = s[a], s[a] = -inf
//       counts[e] += number of rows that selected e
// with ids int64 (the port's id dtype), weights fp32, counts int64 and,
// when the caller passes a buffer, the scores (T, E) fp32.  With an
// aux-free selection bias (E,) (DeepSeek), the rounds select on
// scores + bias while the weights stay the unbiased scores, as
// repro/moe/gating.py:gate does.
//
// What bounds it on an H100 SXM (3.35 TB/s): it is a row reduction with a
// few operations per byte, so bytes bound it.  At the GLM-4.5-Air and
// Qwen3-235B-A22B prefill shape (T 4096, E 128, k 8) it reads 2.1 MB of
// logits and writes 0.5 MB of ids and weights (and 2.1 MB of scores when
// asked): 0.8 us without the scores, 1.4 us with them.  What the design
// does about it: the logits are read once, into registers; the scores, the
// k selection rounds and the histogram never leave the chip, and the
// outputs are written once.
//
// Design: one warp per token row, E up to 256.  Lane l holds experts l,
// l + 32, l + 64, ... (so a warp's loads are coalesced), does the softmax's
// max and sum with warp shuffles, and each of the k <= 8 rounds is a warp
// argmax over (score, index) pairs that prefers the lower index on equal
// scores (the biased score when a bias is given; the pair carries the
// unbiased score along for the weight).  The owner lane of the winner
// masks it.  Counts go to a block-shared histogram with shared atomics,
// then to global memory with one integer atomicAdd per expert and block:
// integer sums are the same in any order, so the counts are
// deterministic.  CUDA C++ rather than
// Triton: the port's kernels are CUDA C++ for sm_90a, bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_E = 256;
constexpr int PER_LANE = MAX_E / 32;
constexpr int MAX_K = 8;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (v, i) beats (w, j) when v > w, or v == w and i < j.
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

template <int SCORE_FN>   // 0 softmax, 1 sigmoid
__global__ void __launch_bounds__(THREADS)
gating_topk_kernel(const float* __restrict__ logits, long long srow,
                   const float* __restrict__ bias, int64_t* __restrict__ ids, float* __restrict__ weights,
                   unsigned long long* __restrict__ counts,
                   float* __restrict__ scores, int T, int E, int k) {
  __shared__ int hist[MAX_E];
  for (int e = threadIdx.x; e < E; e += THREADS) hist[e] = 0;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.x * WARPS + warp;   // this warp's token row
  if (t < T) {
    const float* x = logits + (long long)t * srow;
    float s[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int e = lane + 32 * i;
      s[i] = e < E ? x[e] : -INFINITY;
    }
    if (SCORE_FN == 0) {
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) m = fmaxf(m, s[i]);
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        s[i] = lane + 32 * i < E ? expf(s[i] - m) : 0.f;
        sum += s[i];
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) s[i] = s[i] / sum;
    } else {
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) s[i] = 1.f / (1.f + expf(-s[i]));
    }
    if (scores != nullptr) {
      float* out = scores + (long long)t * E;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i)
        if (lane + 32 * i < E) out[lane + 32 * i] = s[i];
    }
    // Selection keys: the scores, plus the bias when given.  Experts past
    // E take part as -inf: never selected, since k <= E and every real key
    // is finite.
    float key[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int e = lane + 32 * i;
      key[i] = e >= E ? -INFINITY : (bias != nullptr ? s[i] + bias[e] : s[i]);
    }
    for (int round = 0; round < k; ++round) {
      float bv = key[0], bw = s[0];
      int bi = lane;
#pragma unroll
      for (int i = 1; i < PER_LANE; ++i)   // the first maximum wins
        if (key[i] > bv) { bv = key[i]; bw = s[i]; bi = lane + 32 * i; }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const float ow = __shfl_xor_sync(0xffffffffu, bw, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (beats(ov, oi, bv, bi)) { bv = ov; bw = ow; bi = oi; }
      }
      if (lane == bi % 32) {
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i)
          if (lane + 32 * i == bi) key[i] = -INFINITY;
      }
      if (lane == 0) {
        ids[(long long)t * k + round] = bi;
        weights[(long long)t * k + round] = bw;
        atomicAdd(&hist[bi], 1);
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += THREADS)
    if (hist[e]) atomicAdd(&counts[e], (unsigned long long)hist[e]);
}

}  // namespace

// Plain C entry point, bound with ctypes.  score_fn: 0 softmax, 1 sigmoid.
// logits: (T, E) fp32 with row stride `srow` (elements) and unit stride
// along E; bias (E,) fp32 contiguous or null; ids (T, k) int64, weights (T, k) fp32 contiguous; counts (E,)
// int64, zeroed by the caller; scores (T, E) fp32 contiguous or null.
// Launches on `stream`, does not synchronise, and returns the launch's
// CUDA error code (0 = launched; cudaErrorInvalidValue for E or k out of
// range).
extern "C" int gating_topk_launch(int score_fn, const void* logits,
                                  const void* bias, void* ids, void* weights, void* counts,
                                  void* scores, int T, int E, int k,
                                  long long srow, void* stream) {
  if (E < 1 || E > MAX_E || k < 1 || k > MAX_K || k > E || T < 1 ||
      (score_fn != 0 && score_fn != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + WARPS - 1) / WARPS);
  const auto* x = static_cast<const float*>(logits);
  const auto* bs = static_cast<const float*>(bias);
  auto* i64 = static_cast<int64_t*>(ids);
  auto* w = static_cast<float*>(weights);
  auto* c = static_cast<unsigned long long*>(counts);
  auto* sc = static_cast<float*>(scores);
  if (score_fn == 0)
    gating_topk_kernel<0><<<grid, THREADS, 0, s>>>(x, srow, bs, i64, w, c, sc, T, E, k);
  else
    gating_topk_kernel<1><<<grid, THREADS, 0, s>>>(x, srow, bs, i64, w, c, sc, T, E, k);
  return static_cast<int>(cudaGetLastError());
}
