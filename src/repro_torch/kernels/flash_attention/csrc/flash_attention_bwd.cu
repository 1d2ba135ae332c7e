// Flash attention backward for Hopper (sm_90a): GQA, bf16, head dim 128,
// full sequences (the training step), causal or not.
//
// The JAX package has no backward kernel: it differentiates
// repro/models/attention.py:flash_ref (the plain version of the Pallas
// forward, repro/kernels/flash_attention/kernel.py:flash_fwd_pallas), so
// the TPU gets its backward from XLA.  This is that backward as a kernel:
// from q, k, v (B, S, H or Hkv, 128), the forward's output o and its
// gradient do (B, S, H, 128) and the forward's row logsumexp lse
// (B, H, S, fp32, natural log; the TMA + wgmma forward writes it when
// asked), it computes dq, dk, dv in bf16 with fp32 accumulation:
//   P = exp(scale q k^T - lse), dP = do v^T, D = rowsum(do o),
//   dS = P (dP - D), dq = scale dS k, dk = scale dS^T q, dv = P^T do.
//
// What bounds it on an H100: operations.  Five products of the forward's
// size where the forward has two (causal, B 2, S 4096, 32 heads: 0.69
// TFLOP of causal pairs, 0.69 ms at 989 TFLOP/s), against 0.2 GB of bytes.
//
// Precision: P and dS are rounded to bf16 as the A operands of their
// products, as the forward rounds P for P v.
//
// Design: three kernels, all simple mma.sync (m16n8k16) tiles with the
// operands in padded shared memory (rows 128 + 8 elements apart, so the
// fragments' 32-bit reads hit distinct banks) behind a 2-stage cp.async
// ring (105 KB a block: two blocks an SM); P and dS are rebuilt from
// registers as A fragments, as the forward's mma.sync kernel feeds P v.
//   1. bwd_delta_kernel: D = rowsum(do o) per (b, h, position), one warp a
//      row, into an fp32 workspace.
//   2. bwd_dkdv_kernel: one block of 4 warps per (64-key tile, KV head,
//      batch row); each warp owns 16 keys and accumulates their dk and dv
//      in registers over the G query heads of its KV head and every
//      64-query tile at or past the keys (causal), so dk and dv are
//      summed over the group inside the kernel and written once.  S^T, P^T
//      and dS^T are computed key-major (keys as the rows of the products),
//      so dv += P^T do and dk += dS^T q take P^T and dS^T straight from
//      the registers.  Blocks run the heaviest key tiles (the first) first.
//   3. bwd_dq_kernel: dq from a second pass, one block of 4 warps per
//      (64-query tile, query head, batch row), each warp 16 queries, over
//      the key tiles up to the diagonal: it recomputes S and dP (two of its
//      three products) rather than adding into dq with fp32 atomics from
//      kernel 2, so dq is deterministic: the same bits on every run.
// Masking only on the diagonal tile (causal) and on positions past S.
// Not yet: wgmma and TMA (these are mma.sync tiles at a fraction of the
// tensor-core rate), and one pass with atomics for dq.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 128;
constexpr int BT = 64;                  // rows (queries or keys) per tile
constexpr int WARPS = 4;                // 16 rows each
constexpr int THREADS = WARPS * 32;
constexpr int LDS = HD + 8;             // shared row stride, elements
constexpr int TILE = BT * LDS;          // elements of one 64-row tile
constexpr int CHUNKS = HD * 2 / 16;     // 16-byte pieces per row
constexpr int SMEM_BYTES = 6 * TILE * 2 + 4 * BT * 4;
constexpr float LOG2E = 1.4426950408889634f;

struct Bwd {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;          // (B, H, S)
  float* delta;              // (B, H, S) workspace
  bf16 *dq, *dk, *dv;
  int B, S, H, Hkv, G;
  float scale, scale_log2;
  // Element offsets of (b, position, head) in the contiguous layouts.
  __device__ __forceinline__ long long qrow(int b, int s, int h) const {
    return ((static_cast<long long>(b) * S + s) * H + h) * HD;
  }
  __device__ __forceinline__ long long kvrow(int b, int s, int h) const {
    return ((static_cast<long long>(b) * S + s) * Hkv + h) * HD;
  }
  __device__ __forceinline__ long long stat(int b, int h, int s) const {
    return (static_cast<long long>(b) * H + h) * S + s;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 64 rows of a (B, S, heads, 128) tensor at (b, s0 .., head) into a padded
// tile; rows at or past S are zero-filled.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row0, long long row_step,
                                          int s0, int S) {
  for (int i = threadIdx.x; i < BT * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = s0 + r < S;
    cp_async16(dst + r * LDS + c * 8, ok ? src + row0 + r * row_step + c * 8
                                         : src, ok ? 16 : 0);
  }
}

// 64 fp32 row statistics at src[at ..] (zero past S), plain loads: the
// barrier that opens the iteration which reads them orders them.
__device__ __forceinline__ void load_stat(float* dst, const float* src,
                                          long long at, int s0, int S) {
  if (threadIdx.x < BT) {
    const int r = threadIdx.x;
    dst[r] = s0 + r < S ? src[at + r] : 0.f;
  }
}

// The A fragment of m16n8k16 for rows row0 .. row0 + 15 and columns
// 16 kd .. 16 kd + 15 of a padded tile.
__device__ __forceinline__ void a_frag(unsigned (&a)[4], const bf16* t,
                                       int row0, int kd, int gid, int tq) {
  const bf16* p = t + (row0 + gid) * LDS + kd * 16 + tq * 2;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * LDS);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * LDS + 8);
}

// acc (16 x 64) = A (16 rows of `a_t` from row0) @ B^T with B the 64 rows
// of `b_t`: the scores of 16 rows against a tile, over all 128 dims.
__device__ __forceinline__ void rows_by_tile(float (&acc)[8][4],
                                             const bf16* a_t, int row0,
                                             const bf16* b_t, int gid,
                                             int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < HD / 16; ++kd) {
    unsigned a[4];
    a_frag(a, a_t, row0, kd, gid, tq);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* bp = b_t + (j * 8 + gid) * LDS + kd * 16 + tq * 2;
      mma_bf16(acc[j], a, lds32(bp), lds32(bp + 8));
    }
  }
}

// out (16 x 128) += P (16 x 64, the fp32 accumulator layout of
// rows_by_tile, rounded to bf16) @ T (64 rows x 128 of a padded tile).
__device__ __forceinline__ void acc_times_tile(float (&out)[16][4],
                                               const float (&p)[8][4],
                                               const bf16* t, int lane) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    const unsigned pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const bf16* tp = t + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                     (lane >> 4) * 8;
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      unsigned vb[4];
      ldsm_x4_trans(vb, tp + np * 16);
      mma_bf16(out[2 * np], pa, vb[0], vb[1]);
      mma_bf16(out[2 * np + 1], pa, vb[2], vb[3]);
    }
  }
}

// Write 16 rows x 128 of an fp32 accumulator, times `mul`, as bf16 rows at
// dst(row) (row past S skipped).
template <typename RowPtr>
__device__ __forceinline__ void store_rows(const float (&acc)[16][4],
                                           float mul, int row0, int S,
                                           int gid, int tq, RowPtr dst) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + gid + 8 * i;
    if (r >= S) continue;
    bf16* p = dst(r) + tq * 2;
#pragma unroll
    for (int nf = 0; nf < HD / 8; ++nf)
      *reinterpret_cast<__nv_bfloat162*>(p + nf * 8) = __floats2bfloat162_rn(
          acc[nf][2 * i] * mul, acc[nf][2 * i + 1] * mul);
  }
}

__global__ void __launch_bounds__(256) bwd_delta_kernel(const Bwd a) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const long long rows = static_cast<long long>(a.B) * a.S * a.H;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const bf16* op = a.o + row * HD + lane * 4;
  const bf16* dp = a.dout + row * HD + lane * 4;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 o = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(op)[i]);
    const float2 d = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(dp)[i]);
    sum += o.x * d.x + o.y * d.y;
  }
  sum = warp_sum(sum);
  if (lane == 0) {
    const int h = static_cast<int>(row % a.H);
    const int s = static_cast<int>((row / a.H) % a.S);
    const int b = static_cast<int>(row / (static_cast<long long>(a.H) * a.S));
    a.delta[a.stat(b, h, s)] = sum;
  }
}

template <bool CAUSAL>
__global__ void __launch_bounds__(THREADS) bwd_dkdv_kernel(const Bwd a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + TILE;
  bf16* qd_s = v_s + TILE;                  // stage st: q at 2 st, do at 2 st + 1
  float* st_s = reinterpret_cast<float*>(qd_s + 4 * TILE);  // lse, D per stage

  const int per = a.Hkv * a.B;
  const int kt = static_cast<int>(blockIdx.x / per);   // heaviest first
  const int hkv = static_cast<int>(blockIdx.x % per) % a.Hkv;
  const int b = static_cast<int>(blockIdx.x % per) / a.Hkv;
  const int k0 = kt * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tq = lane % 4;
  const int n_qt = (a.S + BT - 1) / BT;
  const int qt0 = CAUSAL ? k0 / BT : 0;
  const int per_head = n_qt - qt0;
  const int iters = a.G * per_head;

  load_tile(k_s, a.k, a.kvrow(b, k0, hkv), static_cast<long long>(a.Hkv) * HD,
            k0, a.S);
  load_tile(v_s, a.v, a.kvrow(b, k0, hkv), static_cast<long long>(a.Hkv) * HD,
            k0, a.S);
  auto load_q = [&](int stage, int it) {
    const int h = hkv * a.G + it / per_head;
    const int s0 = (qt0 + it % per_head) * BT;
    const long long step = static_cast<long long>(a.H) * HD;
    load_tile(qd_s + 2 * stage * TILE, a.q, a.qrow(b, s0, h), step, s0, a.S);
    load_tile(qd_s + (2 * stage + 1) * TILE, a.dout, a.qrow(b, s0, h), step,
              s0, a.S);
    load_stat(st_s + stage * 2 * BT, a.lse, a.stat(b, h, s0), s0, a.S);
    load_stat(st_s + stage * 2 * BT + BT, a.delta, a.stat(b, h, s0), s0, a.S);
  };
  if (iters > 0) load_q(0, 0);
  cp_async_commit();

  float dk[16][4], dv[16][4];
#pragma unroll
  for (int nf = 0; nf < 16; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nf][e] = dv[nf][e] = 0.f;
  const int key_row0 = warp * 16;           // this warp's keys in the tile

  for (int it = 0; it < iters; ++it) {
    if (it + 1 < iters) load_q((it + 1) & 1, it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int stage = it & 1;
    const bf16* q_s = qd_s + 2 * stage * TILE;
    const bf16* do_s = q_s + TILE;
    const float* lse_s = st_s + stage * 2 * BT;
    const float* dl_s = lse_s + BT;
    const int q0 = (qt0 + it % per_head) * BT;

    // S^T: 16 keys x 64 queries; value [j][e] at key key_row0 + gid +
    // 8 (e / 2), query 8 j + 2 tq + e % 2 of the tile.
    float p[8][4];
    rows_by_tile(p, k_s, key_row0, q_s, gid, tq);
    const bool diag = CAUSAL && q0 < k0 + BT;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + tq * 2 + (e & 1);
        const int key = k0 + key_row0 + gid + 8 * (e >> 1);
        const bool masked = q0 + qi >= a.S || (diag && key > q0 + qi);
        p[j][e] = masked ? 0.f
                         : exp2f(p[j][e] * a.scale_log2 - lse_s[qi] * LOG2E);
      }
    // dv += P^T do.
    acc_times_tile(dv, p, do_s, lane);
    // dP^T = v do^T, then dS^T = P^T (dP^T - D) in place of P^T.
    float dp[8][4];
    rows_by_tile(dp, v_s, key_row0, do_s, gid, tq);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[j][e] *= dp[j][e] - dl_s[j * 8 + tq * 2 + (e & 1)];
    // dk += dS^T q (scaled at the end).
    acc_times_tile(dk, p, q_s, lane);
    __syncthreads();   // stage `stage` is free for iteration it + 2
  }
  cp_async_wait<0>();

  store_rows(dk, a.scale, k0 + key_row0, a.S, gid, tq, [&](int r) {
    return a.dk + a.kvrow(b, r, hkv);
  });
  store_rows(dv, 1.f, k0 + key_row0, a.S, gid, tq, [&](int r) {
    return a.dv + a.kvrow(b, r, hkv);
  });
}

template <bool CAUSAL>
__global__ void __launch_bounds__(THREADS) bwd_dq_kernel(const Bwd a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + TILE;
  bf16* kv_s = do_s + TILE;                 // stage st: k at 2 st, v at 2 st + 1

  const int n_qt = (a.S + BT - 1) / BT;
  const int per = a.H * a.B;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / per);  // heaviest first
  const int h = static_cast<int>(blockIdx.x % per) % a.H;
  const int b = static_cast<int>(blockIdx.x % per) / a.H;
  const int hkv = h / a.G;
  const int q0 = qt * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tq = lane % 4;
  const int n_kt = CAUSAL ? (min(q0 + BT, a.S) - 1) / BT + 1 : (a.S + BT - 1) / BT;
  const long long qstep = static_cast<long long>(a.H) * HD;
  const long long kstep = static_cast<long long>(a.Hkv) * HD;

  load_tile(q_s, a.q, a.qrow(b, q0, h), qstep, q0, a.S);
  load_tile(do_s, a.dout, a.qrow(b, q0, h), qstep, q0, a.S);
  auto load_kv = [&](int stage, int t) {
    const int s0 = t * BT;
    load_tile(kv_s + 2 * stage * TILE, a.k, a.kvrow(b, s0, hkv), kstep, s0,
              a.S);
    load_tile(kv_s + (2 * stage + 1) * TILE, a.v, a.kvrow(b, s0, hkv), kstep,
              s0, a.S);
  };
  load_kv(0, 0);
  cp_async_commit();

  // This thread's two query rows: lse (log2 units) and D.
  const int row0 = warp * 16;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + row0 + gid + 8 * i;
    const bool ok = s < a.S;
    lse2[i] = ok ? a.lse[a.stat(b, h, s)] * LOG2E : INFINITY;
    dl[i] = ok ? a.delta[a.stat(b, h, s)] : 0.f;
  }
  float dq[16][4];
#pragma unroll
  for (int nf = 0; nf < 16; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nf][e] = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt) load_kv((t + 1) & 1, t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* k_s = kv_s + 2 * (t & 1) * TILE;
    const bf16* v_s = k_s + TILE;
    const int k0 = t * BT;
    // S: 16 queries x 64 keys; [j][e] at query row0 + gid + 8 (e / 2),
    // key 8 j + 2 tq + e % 2.
    float p[8][4];
    rows_by_tile(p, q_s, row0, k_s, gid, tq);
    const bool diag = CAUSAL && k0 + BT > q0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tq * 2 + (e & 1);
        const int qi = q0 + row0 + gid + 8 * (e >> 1);
        const bool masked = key >= a.S || (diag && key > qi);
        p[j][e] = masked ? 0.f
                         : exp2f(p[j][e] * a.scale_log2 - lse2[e >> 1]);
      }
    float dp[8][4];
    rows_by_tile(dp, do_s, row0, v_s, gid, tq);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] *= dp[j][e] - dl[e >> 1];
    // dq += dS k (scaled at the end).
    acc_times_tile(dq, p, k_s, lane);
    __syncthreads();
  }
  cp_async_wait<0>();
  store_rows(dq, a.scale, q0 + row0, a.S, gid, tq, [&](int r) {
    return a.dq + a.qrow(b, r, h);
  });
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, long long blocks, const Bwd& a,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  q, o, do, dq: (B, S, H, 128);
// k, v, dk, dv: (B, S, Hkv, 128); all bf16 and contiguous.  lse: (B, H, S)
// fp32 from the forward; delta: a (B, H, S) fp32 workspace.  Launches the
// three kernels on `stream`, does not synchronise, and returns the first
// launch's CUDA error code (0 = launched).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int S, int H, int Hkv, int causal, float scale,
    void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv) return cudaErrorInvalidValue;
  Bwd a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.B = B;
  a.S = S;
  a.H = H;
  a.Hkv = Hkv;
  a.G = H / Hkv;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * S * H;
  bwd_delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (S + BT - 1) / BT;
  err = launch(causal ? bwd_dkdv_kernel<true> : bwd_dkdv_kernel<false>,
               tiles * Hkv * B, a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch(causal ? bwd_dq_kernel<true> : bwd_dq_kernel<false>,
               tiles * H * B, a, s);
  return static_cast<int>(err);
}
