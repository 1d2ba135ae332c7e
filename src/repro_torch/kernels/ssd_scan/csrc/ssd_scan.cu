// SSD intra-chunk kernel for Hopper (sm_90a): the quadratic (within-chunk)
// term and the chunk states of the Mamba-2 state-space-duality scan.
//
// Replaces the Pallas kernel repro/kernels/ssd_scan/kernel.py
// ssd_intra_chunk_pallas.  For each (batch b, chunk c, head h), with
// cum = cumsum(da) over the Q positions of the chunk:
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (Q x P)
//   S     = sum_j exp(cum_last - cum_j) dt_j B_j^T x_j             (N x P)
//   decay = exp(cum_last)
// x (B, nc, Q, H, P), B/C (B, nc, Q, H, N) in fp32 or bf16, dt/da
// (B, nc, Q, H) fp32, any strides with a unit-stride last dim; outputs y
// (B, nc, Q, H, P), S (B, nc, H, N, P) and decay (B, nc, H), contiguous
// fp32.  All arithmetic is fp32, as in the Pallas kernel.
//
// What bounds it on an H100: fp32 arithmetic outside the tensor cores.  At
// the Jamba-v0.1 prefill chunk (B 1, nc 32, Q 128, H 128, P 64, N 16) the
// causal triangle needs ~6.6 GFLOP (~0.10 ms at 67 TFLOP/s) against ~0.25 GB
// of inputs and outputs (~0.075 ms at 3.35 TB/s).  The arithmetic is three
// small contractions per block, so the limit in practice is how many shared
// memory loads feed each FMA.
//
// Design (a first, simple version): one block of 512 threads per
// (b, c, h), 4096 blocks at the Jamba chunk, which fills the 132 SMs many
// times over.  The block stages x, B (transposed) and C in shared memory as
// fp32, scans da with warp shuffles, builds the masked (Q x Q) weight
// W[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j in shared memory (masked
// entries are set to zero without evaluating exp, so they cannot overflow),
// then each thread owns 4 x 4 tiles of y (rows i0..i0+3 over j <= i0+3, the
// causal triangle only) and 1 x 4 tiles of S.  Tiles read W and x as float4,
// so eight 16-byte shared loads feed 64 FMAs.  Ragged Q and P are padded to
// multiples of 4 with zeros in shared memory and masked at the store.  Not
// yet: tensor cores (wgmma in TF32 or bf16), TMA staging, and folding the
// cross-chunk recurrence into the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

struct Strides {   // element strides of the (b, c, q, h) dimensions
  long long b, c, q, h;
  __device__ long long at(int bb, int cc, int hh) const {
    return bb * b + cc * c + hh * h;
  }
};

struct Dims {
  int nc, Q, H, P, N;
  int Q4, P4;        // Q and P rounded up to multiples of 4
  int ldw, ldb, ldc; // leading dims of W (Q4 x ldw), B^T (N x ldb), C (Q4 x ldc)
};

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

__host__ __device__ inline Dims make_dims(int nc, int Q, int H, int P, int N) {
  Dims d;
  d.nc = nc; d.Q = Q; d.H = H; d.P = P; d.N = N;
  d.Q4 = round4(Q);
  d.P4 = round4(P);
  d.ldw = d.Q4 + 4;
  d.ldb = d.Q4 + 4;
  d.ldc = N + 1;
  return d;
}

// Shared memory in floats: x (Q4 x P4) | W (Q4 x ldw) | B^T (N x ldb) |
// C (Q4 x ldc) | cum, dt, wj (Q4 each) | warp totals.  Every float4 array
// starts at a multiple of 4 floats.
__host__ __device__ inline long long smem_floats(const Dims& d) {
  return (long long)d.Q4 * d.P4 + (long long)d.Q4 * d.ldw +
         (long long)d.N * d.ldb + (long long)d.Q4 * d.ldc + 3LL * d.Q4 +
         kWarps;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Inclusive prefix sum of da over the Q positions into cum (fp32).
__device__ void block_cumsum(const float* __restrict__ da, long long base,
                             long long stride, int Q, float* cum,
                             float* tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float carry = 0.0f;
  for (int q0 = 0; q0 < Q; q0 += kThreads) {
    const int q = q0 + threadIdx.x;
    float v = q < Q ? da[base + q * stride] : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float t = lane < kWarps ? tot[lane] : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, t, off);
        if (lane >= off) t += u;
      }
      if (lane < kWarps) tot[lane] = t;
    }
    __syncthreads();
    if (q < Q) cum[q] = v + carry + (warp > 0 ? tot[warp - 1] : 0.0f);
    carry += tot[kWarps - 1];
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                       const T* __restrict__ cm, const float* __restrict__ dt,
                       const float* __restrict__ da, float* __restrict__ y,
                       float* __restrict__ s_out, float* __restrict__ dec,
                       Dims d, Strides sx, Strides sb, Strides sc,
                       Strides sdt, Strides sda) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ws = xs + d.Q4 * d.P4;
  float* bt = ws + d.Q4 * d.ldw;
  float* cs = bt + d.N * d.ldb;
  float* cum = cs + d.Q4 * d.ldc;
  float* dtv = cum + d.Q4;
  float* wj = dtv + d.Q4;
  float* tot = wj + d.Q4;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int Q = d.Q, P = d.P, N = d.N, Q4 = d.Q4, P4 = d.P4;

  // ---- stage x, B^T, C and dt as fp32 (zero padding past Q and P)
  const long long xo = sx.at(b, c, h);
  for (int e = tid; e < Q4 * P4; e += kThreads) {
    const int q = e / P4, p = e - q * P4;
    xs[e] = (q < Q && p < P) ? to_f32(x[xo + q * sx.q + p]) : 0.0f;
  }
  const long long bo = sb.at(b, c, h), co = sc.at(b, c, h);
  for (int e = tid; e < Q4 * N; e += kThreads) {
    const int q = e / N, n = e - q * N;
    const bool ok = q < Q;
    bt[n * d.ldb + q] = ok ? to_f32(bm[bo + q * sb.q + n]) : 0.0f;
    cs[q * d.ldc + n] = ok ? to_f32(cm[co + q * sc.q + n]) : 0.0f;
  }
  const long long dto = sdt.at(b, c, h);
  for (int q = tid; q < Q4; q += kThreads)
    dtv[q] = q < Q ? dt[dto + q * sdt.q] : 0.0f;

  // ---- cum = cumsum(da); chunk-state weights and the chunk decay
  block_cumsum(da, sda.at(b, c, h), sda.q, Q, cum, tot);  // ends synced
  const float last = cum[Q - 1];
  for (int q = tid; q < Q4; q += kThreads)
    wj[q] = q < Q ? expf(last - cum[q]) * dtv[q] : 0.0f;
  const long long bch = ((long long)b * d.nc + c) * d.H + h;
  if (tid == 0) dec[bch] = expf(last);

  // ---- W[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
  const int nwt = Q4 / 4;
  for (int t = tid; t < Q4 * nwt; t += kThreads) {
    const int i = t / nwt, j0 = 4 * (t - i * nwt);
    float4 out = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < Q && j0 <= i) {
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int n = 0; n < N; ++n) {
        const float cv = cs[i * d.ldc + n];
        const float4 bv = ld4(bt + n * d.ldb + j0);
        a[0] += cv * bv.x;
        a[1] += cv * bv.y;
        a[2] += cv * bv.z;
        a[3] += cv * bv.w;
      }
      const float ci = cum[i];
      float r[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + k;
        r[k] = j <= i ? a[k] * expf(ci - cum[j]) * dtv[j] : 0.0f;
      }
      out = make_float4(r[0], r[1], r[2], r[3]);
    }
    *reinterpret_cast<float4*>(ws + i * d.ldw + j0) = out;
  }
  __syncthreads();

  // ---- y tiles (4 rows x 4 cols) and S tiles (1 row x 4 cols)
  const int nct = P4 / 4;
  const int ny = (Q4 / 4) * nct;
  const int ns = N * nct;
  const bool vec = (P & 3) == 0;
  for (int t = tid; t < ny + ns; t += kThreads) {
    if (t < ny) {
      const int i0 = 4 * (t / nct), p0 = 4 * (t - (t / nct) * nct);
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = 0.0f;
      const int jend = min(i0 + 4, Q);   // W is zero past the diagonal
      for (int j = 0; j < jend; j += 4) {
        float4 w[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) w[r] = ld4(ws + (i0 + r) * d.ldw + j);
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] = ld4(xs + (j + k) * P4 + p0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float wr[4] = {w[r].x, w[r].y, w[r].z, w[r].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[r][0] += wr[k] * xv[k].x;
            acc[r][1] += wr[k] * xv[k].y;
            acc[r][2] += wr[k] * xv[k].z;
            acc[r][3] += wr[k] * xv[k].w;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        if (i >= Q) break;
        float* dst = y + ((((long long)b * d.nc + c) * Q + i) * d.H + h) * P;
        if (vec) {
          *reinterpret_cast<float4*>(dst + p0) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (p0 + k < P) dst[p0 + k] = acc[r][k];
        }
      }
    } else {
      const int u = t - ny;
      const int n = u / nct, p0 = 4 * (u - n * nct);
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = 0; j < Q; ++j) {
        const float bw = wj[j] * bt[n * d.ldb + j];
        const float4 xv = ld4(xs + j * P4 + p0);
        acc.x += bw * xv.x;
        acc.y += bw * xv.y;
        acc.z += bw * xv.z;
        acc.w += bw * xv.w;
      }
      float* dst = s_out + (bch * N + n) * P;
      if (vec) {
        *reinterpret_cast<float4*>(dst + p0) = acc;
      } else {
        const float v[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (p0 + k < P) dst[p0 + k] = v[k];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* bm, const void* cm,
                   const float* dt, const float* da, float* y, float* s,
                   float* dec, int B, const Dims& d, const Strides& sx,
                   const Strides& sb, const Strides& sc, const Strides& sdt,
                   const Strides& sda, cudaStream_t stream) {
  const long long bytes = smem_floats(d) * 4;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (bytes > optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(ssd_intra_chunk_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(d.H, d.nc, B);
  ssd_intra_chunk_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<const T*>(cm), dt, da, y, s, dec, d, sx, sb, sc, sdt, sda);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs; the wrapper checks it against the
// card's limit before launching.
long long ssd_intra_chunk_smem_bytes(int Q, int P, int N) {
  return smem_floats(make_dims(1, Q, 1, P, N)) * 4;
}

// dtype: 0 = fp32, 1 = bf16 (x, B and C).  Strides are in elements, for the
// (b, c, q, h) dimensions of x, B, C, dt and da in that order.  Returns the
// CUDA error of the launch (0 on success).
int ssd_intra_chunk_launch(int dtype, const void* x, const void* bm,
                           const void* cm, const float* dt, const float* da,
                           float* y, float* s, float* dec, int B, int nc,
                           int Q, int H, int P, int N, long long sxb,
                           long long sxc, long long sxq, long long sxh,
                           long long sbb, long long sbc, long long sbq,
                           long long sbh, long long scb, long long scc,
                           long long scq, long long sch, long long sdtb,
                           long long sdtc, long long sdtq, long long sdth,
                           long long sdab, long long sdac, long long sdaq,
                           long long sdah, void* stream) {
  const Dims d = make_dims(nc, Q, H, P, N);
  const Strides sx{sxb, sxc, sxq, sxh}, sb{sbb, sbc, sbq, sbh},
      sc{scb, scc, scq, sch}, sdt{sdtb, sdtc, sdtq, sdth},
      sda{sdab, sdac, sdaq, sdah};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = launch<bf16>(x, bm, cm, dt, da, y, s, dec, B, d, sx, sb, sc, sdt,
                       sda, st);
  else if (dtype == 0)
    err = launch<float>(x, bm, cm, dt, da, y, s, dec, B, d, sx, sb, sc, sdt,
                        sda, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
