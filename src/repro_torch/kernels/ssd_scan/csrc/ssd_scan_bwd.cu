// SSD intra-chunk backward for Hopper (sm_90a): the gradient of the
// quadratic term, the chunk state and the chunk decay of the Mamba-2 scan
// (B5).
//
// The JAX package has no backward kernel: XLA differentiates the plain SSD
// path around repro/kernels/ssd_scan/kernel.py ssd_intra_chunk_pallas (the
// forward this is the backward of, ssd_scan.cu here).  For each (batch b,
// chunk c, head h), with cum = cumsum(da), L[i,j] = exp(cum_i - cum_j) for
// j <= i (0 above the diagonal), CB = C B^T, W = CB * L * dt_j,
// wj = exp(cum_last - cum_j) dt_j, and the forward's y = W x,
// S = (B wj)^T x, decay = exp(cum_last), it takes dY (Q x P), dS (N x P)
// and d(decay) and gives:
//   dW   = dY x^T (j <= i),   G = dW * L * dt_j  (= d(CB)),
//   dx_j = sum_i W[i,j] dY_i + wj (B_j dS),
//   dC_i = sum_j G[i,j] B_j,  dB_j = sum_i G[i,j] C_i + wj (dS x_j),
//   ddt_j = sum_i dW CB L + (B_j . dS x_j) exp(cum_last - cum_j),
//   dcum_i = sum_j dW W  - sum_k dW[k,i] W[k,i]  - (B_i . dS x_i) wi
//            (+ sum_j (B_j . dS x_j) wj + d(decay) decay at i = Q - 1),
//   dda_k = sum_{i >= k} dcum_i  (the reverse cumsum).
// x, B, C in fp32 or bf16 (the forward's input types; dx, dB, dC come
// back in that type), dt, da, dY, dS, d(decay) fp32, all contiguous:
// x, dY (B, nc, Q, H, P), B, C (B, nc, Q, H, N), dt, da (B, nc, Q, H),
// dS (B, nc, H, N, P), d(decay) (B, nc, H).  (P, N) is (64, 16), Jamba's
// head dim and state, or (16, 16), the reduced configurations'.
//
// Masked entries: no product above the diagonal is ever formed.  The row
// pass runs j <= i and the column pass i >= j, so exp(cum_i - cum_j) is
// only taken where the exponent is <= 0 (da <= 0) and a masked entry
// contributes an exact 0, never 0 * inf.
//
// What bounds it on an H100: bytes.  At Jamba-v0.1's train shape (B 1,
// T 4096: nc 32, Q 128, H 128, P 64, N 16) it reads x, B, C, dY and dS and
// writes dx, dB, dC (ddt, dda and the small inputs besides): 0.59 GB with
// fp32 x, B, C (0.17 ms at 3.35 TB/s), 0.42 GB with bf16 (0.13 ms).  Its
// arithmetic, Q^2 / 2 (3 P + 3 N) multiply-adds a block recomputed twice
// over (each pass forms dW and C . B again), is 17 GFLOP of fp32 on the
// CUDA cores: 0.26 ms at 67 TFLOP/s, so this first version is bound by
// its fp32 arithmetic, not by its bytes.
//
// Design: one block per (b, c, h), a thread per position.  Phase 0 stages
// dY and C (as fp32) in shared memory and each thread takes its own row
// into registers; phase 1 stages x and B, and thread i runs the row pass
// (dW[i, j], C_i . B_j over j <= i, with x_j and B_j read by every thread
// of the warp at once: broadcasts) into dC_i, written at once, and its row
// term of dcum.
// Phase 2 takes x_j and B_j into registers and stages dY and C again;
// thread j runs the column pass (i >= j) into dx_j, dB_j, ddt_j and its
// column term of dcum, then the chunk state's terms from dS.  Sums are
// taken by one thread in a fixed order: the same bits on every run.  The
// reverse cumsum reads dcum from shared memory.  fp32 arithmetic
// throughout (expf), so it agrees with the plain closed form to fp32
// rounding.
//
// Not yet: the products on the tensor cores (dW, W^T dY and the C/B
// products are small GEMMs per block), which would leave it bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Args {
  const void *x, *Bm, *Cm;
  const float *dt, *da, *dy, *dS, *ddec;
  void *dx, *dB, *dC;
  float *ddt, *dda;
  int nc, Q, H;
};

// Stage rows [0, Q) of a (.., Q, H, W) operand of block (bc, h) into
// shared memory as fp32, row stride W.
template <typename T, int W>
__device__ __forceinline__ void stage(float* dst, const T* src, long long bc,
                                      int h, int Q, int H) {
  for (int e = threadIdx.x; e < Q * W; e += blockDim.x) {
    const int r = e / W, c = e % W;
    dst[e] = to_f(src[((bc * Q + r) * H + h) * W + c]);
  }
}

// Store an fp32 (Q, W) block of shared memory as rows of the output.
template <typename T, int W>
__device__ __forceinline__ void unstage(T* dst, const float* src,
                                        long long bc, int h, int Q, int H) {
  for (int e = threadIdx.x; e < Q * W; e += blockDim.x) {
    const int r = e / W, c = e % W;
    dst[((bc * Q + r) * H + h) * W + c] = from_f<T>(src[e]);
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(128) ssd_bwd_kernel(const Args a) {
  extern __shared__ float sm[];
  const int Q = a.Q, H = a.H;
  float* rows = sm;                 // Q x P: dY, x, dY, then dx
  float* bc = rows + Q * P;         // Q x N: C, B, C, then dB
  float* dS = bc + Q * N;           // N x P
  float* cum = dS + N * P;          // Q
  float* dtv = cum + Q;             // Q
  float* dcum = dtv + Q;            // Q
  float* red = dcum + Q;            // Q

  const int h = static_cast<int>(blockIdx.x % H);
  const long long blk = blockIdx.x / H;         // b * nc + c
  const int t = threadIdx.x;
  const bool own = t < Q;
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);

  // ---- phase 0: dY, C, dS, dt and cum; this thread's dY_i and C_i.
  stage<float, P>(rows, a.dy, blk, h, Q, H);
  stage<T, N>(bc, Cm, blk, h, Q, H);
  for (int e = t; e < N * P; e += blockDim.x)
    dS[e] = a.dS[(blk * H + h) * N * P + e];
  if (own) {
    const long long at = (blk * Q + t) * H + h;
    dtv[t] = a.dt[at];
    red[t] = a.da[at];
  }
  __syncthreads();
  float cum_t = 0.f;
  if (own) {
    for (int k = 0; k <= t; ++k) cum_t += red[k];   // cumsum, in order
    cum[t] = cum_t;
  }
  float ri[P], ci[N];
#pragma unroll
  for (int p = 0; p < P; ++p) ri[p] = own ? rows[t * P + p] : 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) ci[n] = own ? bc[t * N + n] : 0.f;
  __syncthreads();

  // ---- phase 1: x and B; the row pass of thread i = t over j <= i.
  stage<T, P>(rows, x, blk, h, Q, H);
  stage<T, N>(bc, Bm, blk, h, Q, H);
  __syncthreads();
  float dci[N];
#pragma unroll
  for (int n = 0; n < N; ++n) dci[n] = 0.f;
  float dcum_row = 0.f;
  const int last = own ? t : -1;
  for (int j = 0; j <= last; ++j) {
    const float* xj = rows + j * P;
    const float* bj = bc + j * N;
    float dw = 0.f, cb = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) dw = fmaf(ri[p], xj[p], dw);
#pragma unroll
    for (int n = 0; n < N; ++n) cb = fmaf(ci[n], bj[n], cb);
    const float g = dw * expf(cum_t - cum[j]) * dtv[j];
#pragma unroll
    for (int n = 0; n < N; ++n) dci[n] = fmaf(g, bj[n], dci[n]);
    dcum_row = fmaf(g, cb, dcum_row);           // dW[i,j] W[i,j]
  }
  // dC_i is final: written now, so its registers are free for the
  // column pass.
  if (own) {
    T* dC = static_cast<T*>(a.dC) + ((blk * Q + t) * H + h) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) dC[n] = from_f<T>(dci[n]);
  }
  // Thread j = t keeps x_j and B_j for the column pass.
  float xj[P], bj[N];
#pragma unroll
  for (int p = 0; p < P; ++p) xj[p] = own ? rows[t * P + p] : 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) bj[n] = own ? bc[t * N + n] : 0.f;
  __syncthreads();

  // ---- phase 2: dY and C again; the column pass of j = t over i >= j.
  stage<float, P>(rows, a.dy, blk, h, Q, H);
  stage<T, N>(bc, Cm, blk, h, Q, H);
  __syncthreads();
  float dxj[P], dbj[N];
#pragma unroll
  for (int p = 0; p < P; ++p) dxj[p] = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) dbj[n] = 0.f;
  float ddt = 0.f, dcum_col = 0.f;
  const float dt_t = own ? dtv[t] : 0.f;
  // Every lane of a warp walks the same rows (broadcast reads), from the
  // warp's first position; a lane skips the rows above its own.
  for (int i = t & ~31; i < Q; ++i) {
    if (!own || i < t) continue;
    const float* yi = rows + i * P;
    const float* cI = bc + i * N;
    float cb = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) cb = fmaf(cI[n], bj[n], cb);
    const float l = expf(cum[i] - cum_t);
    const float w = cb * l * dt_t;
    // One read of dY_i serves both dW[i,j] and dx_j (W needs no dW).
    float dw = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float y = yi[p];
      dw = fmaf(y, xj[p], dw);
      dxj[p] = fmaf(w, y, dxj[p]);
    }
    const float g = dw * l * dt_t;
#pragma unroll
    for (int n = 0; n < N; ++n) dbj[n] = fmaf(g, cI[n], dbj[n]);
    ddt = fmaf(dw * cb, l, ddt);
    dcum_col = fmaf(dw, w, dcum_col);
  }
  // The chunk state's terms: u = dS x_j (N), B_j^T dS (P).
  float dwj = 0.f, wj = 0.f, ej = 0.f;
  if (own) {
    ej = expf(cum[Q - 1] - cum_t);
    wj = ej * dt_t;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float u = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) u = fmaf(dS[n * P + p], xj[p], u);
      dbj[n] = fmaf(wj, u, dbj[n]);
      dwj = fmaf(bj[n], u, dwj);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float v = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) v = fmaf(bj[n], dS[n * P + p], v);
      dxj[p] = fmaf(wj, v, dxj[p]);
    }
    ddt = fmaf(dwj, ej, ddt);
    red[t] = dwj * wj;
  }
  __syncthreads();
  if (own) {
    float d = dcum_row - dcum_col - dwj * wj;
    if (t == Q - 1) {     // cum_last: every wj and the decay
      float s = 0.f;
      for (int k = 0; k < Q; ++k) s += red[k];
      d += s + a.ddec[blk * H + h] * expf(cum_t);
    }
    dcum[t] = d;
    const long long at = (blk * Q + t) * H + h;
    a.ddt[at] = ddt;
  }
  // dx and dB through shared memory (coalesced stores).
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (own) rows[t * P + p] = dxj[p];
#pragma unroll
  for (int n = 0; n < N; ++n)
    if (own) bc[t * N + n] = dbj[n];
  __syncthreads();
  if (own) {
    float s = 0.f;
    for (int k = Q - 1; k >= t; --k) s += dcum[k];   // reverse cumsum
    a.dda[(blk * Q + t) * H + h] = s;
  }
  unstage<T, P>(static_cast<T*>(a.dx), rows, blk, h, Q, H);
  unstage<T, N>(static_cast<T*>(a.dB), bc, blk, h, Q, H);
}

long long smem_bytes(int Q, int P, int N) {
  return 4LL * (static_cast<long long>(Q) * (P + N) + N * P + 4LL * Q);
}

template <typename T, int P, int N>
int launch(const Args& a, long long blocks, int threads, cudaStream_t s) {
  const long long smem = smem_bytes(a.Q, P, N);
  auto kernel = ssd_bwd_kernel<T, P, N>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem),
           s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype 0: fp32 x, B, C; 1: bf16.
// Every tensor contiguous (shapes above).  Returns 0 when launched, else a
// CUDA error code (cudaErrorInvalidValue for a shape the kernel does not
// take: Q above 128 or (P, N) other than (64, 16) and (16, 16)).
extern "C" int ssd_intra_chunk_bwd_launch(
    int dtype, const void* x, const void* Bm, const void* Cm, const void* dt,
    const void* da, const void* dy, const void* dS, const void* ddec,
    void* dx, void* dB, void* dC, void* ddt, void* dda, int B, int nc, int Q,
    int H, int P, int N, void* stream) {
  if (B < 1 || nc < 1 || Q < 1 || Q > 128 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x; a.Bm = Bm; a.Cm = Cm;
  a.dt = static_cast<const float*>(dt);
  a.da = static_cast<const float*>(da);
  a.dy = static_cast<const float*>(dy);
  a.dS = static_cast<const float*>(dS);
  a.ddec = static_cast<const float*>(ddec);
  a.dx = dx; a.dB = dB; a.dC = dC;
  a.ddt = static_cast<float*>(ddt);
  a.dda = static_cast<float*>(dda);
  a.nc = nc; a.Q = Q; a.H = H;
  const long long blocks = static_cast<long long>(B) * nc * H;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (Q + 31) / 32 * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 16)
    return dtype == 1 ? launch<bf16, 64, 16>(a, blocks, threads, s)
                      : launch<float, 64, 16>(a, blocks, threads, s);
  if (P == 16 && N == 16)
    return dtype == 1 ? launch<bf16, 16, 16>(a, blocks, threads, s)
                      : launch<float, 16, 16>(a, blocks, threads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
