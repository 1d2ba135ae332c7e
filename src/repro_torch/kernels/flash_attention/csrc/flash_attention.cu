// Flash attention forward with cache offsets for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py:
//   flash_fwd_pallas -> out = softmax(scale * q k^T + mask) v per head,
// an online softmax over KV tiles with fp32 statistics, and extends it to
// what repro/models/attention.py:flash_ref computes on the serve path:
// query i of batch row b sits at absolute position i + q_offset[b] and
// attends key j iff j < kv_valid_len[b] and, when causal,
// j <= i + q_offset[b].  Grouped-query attention: query head h reads KV
// head h / (H / Hkv).  q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd) and the
// output (B, Sq, H, hd) are all bf16 or all fp32 with a unit-stride head
// dim, hd one of 16, 64, 128 (128 is the width of every served model, 16
// the reduced configurations'); q_offset and
// kv_valid_len are read on the device (a (B,) int64 vector or one
// constant), so the caller never syncs with the host.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at
// the GLM-4.5-Air prefill chunk (Sq 4096 at offset 4096, H 32 over 8 KV
// heads, 8192 valid keys) the causal pairs need 4 * 128 * 32 * 25.2 M =
// 412 GFLOP, 0.42 ms, against 29 MB of q, valid k/v and output (9 us): it
// is bound by operations.  A decode step (Sq 1, B 4) is bound by the bytes
// of the valid cache.  What the design does about it: both products run
// on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate); the
// K/V tiles are read from the bf16 cache once per block for all H / Hkv
// query heads that share them (no repeat over heads, no fp32 copy); the
// scores, probabilities and running statistics stay in registers; the
// KV loop stops at min(kv_valid_len, last query position + 1), so causal
// and invalid tiles cost nothing; the output is written once.
//
// Design of the bf16 kernel (a first, simple version): one block of 4
// warps per (q-tile, KV head, batch row).  Its 64 rows are (query
// position, query head of the group) pairs, 64 / G positions of the
// G = H / Hkv heads, so a decode step packs a group's heads into one tile.
// Each warp owns 16 rows and holds their q fragments in registers.  K and
// V tiles of 64 keys move through a 2-stage cp.async ring in shared memory
// (rows padded by 16 bytes, so fragment loads hit 32 banks).  Per tile:
// S = q k^T on the tensor cores, scale and mask in fp32, the online max /
// sum / correction in fp32 registers (quad shuffles for the row max), P
// rounded to bf16 in the registers that feed P v as its A operand, V's
// fragments through ldmatrix.trans.  The one departure from flash_ref's
// fp32 arithmetic is P in bf16 for the P v product.
//
// The fp32 kernel (fp32 serving, and the reduced configurations' default)
// keeps flash_ref's arithmetic in fp32 throughout on the CUDA cores, with
// the same blocks, rows and KV loop: 32-key K/V tiles in shared memory,
// lane j scores key j of the tile for each of its warp's 16 rows, warp
// shuffles give the row max and sum, and lane l accumulates output dims
// l, l + 32, ...  It is bound by the fp32 rate (67 TFLOP/s) at best.
//
// In both, a row with no valid key gives 0 (the plain version gives NaN
// there; no caller produces such a row).  Not yet: wgmma with TMA, a
// split-KV decode, and a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BM = 16 * WARPS;          // rows per block
constexpr int BN = 64;                  // keys per tile (bf16 kernel)
constexpr int BK = 32;                  // keys per tile (fp32 kernel)
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory layout of the bf16 kernel for head dim HD.
template <int HD>
struct Bf16Tile {
  static constexpr int LDS = HD + 8;    // shared row stride, elements
  static constexpr int Q_ELEMS = BM * LDS;
  static constexpr int KV_ELEMS = BN * LDS;
  static constexpr int SMEM_BYTES = (Q_ELEMS + 4 * KV_ELEMS) * 2;  // q, 2 x (k, v)
  static constexpr int CHUNKS = HD * 2 / 16;   // 16-byte pieces per row
};

// Shared-memory layout of the fp32 kernel for head dim HD.
template <int HD>
struct F32Tile {
  static constexpr int LDK = HD + 1;    // K rows padded: lane j reads row j
  static constexpr int SMEM_BYTES = (BM * HD + BK * LDK + BK * HD) * 4;
};

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

__device__ __forceinline__ unsigned lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Sq, Sk, G;
  long long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, sob, sos, soh;
  const long long* q_off;   // null: q_off_const for every row
  int q_off_stride;
  long long q_off_const;
  const long long* kv_len;  // null: kv_len_const for every row
  int kv_len_stride;
  long long kv_len_const;
  float scale_log2;         // scale * log2(e): scores are kept in log2 units
};

// This block's rows and KV extent, shared by both kernels.  Row r of the
// tile is (position q0 + r / G, head hkv * G + r % G).
struct Tile {
  int b, hkv, G, QT, q0, q_rows;
  long long qoff, lim, kv_end;

  template <bool CAUSAL>
  __device__ __forceinline__ static Tile make(const Args& a) {
    Tile t;
    t.b = blockIdx.z;
    t.hkv = blockIdx.y;
    t.G = a.G;
    t.QT = BM / a.G;                       // query positions per tile
    t.q0 = blockIdx.x * t.QT;
    t.qoff = a.q_off ? a.q_off[t.b * a.q_off_stride] : a.q_off_const;
    long long lim = a.kv_len ? a.kv_len[t.b * a.kv_len_stride] : a.kv_len_const;
    t.lim = lim < a.Sk ? lim : a.Sk;
    t.q_rows = min(t.QT, a.Sq - t.q0);     // valid query positions here
    long long kv_end = t.lim;
    if (CAUSAL) {
      const long long last = t.q0 + t.q_rows - 1 + t.qoff + 1;
      kv_end = last < kv_end ? last : kv_end;
    }
    t.kv_end = kv_end < 0 ? 0 : kv_end;
    return t;
  }
  __device__ __forceinline__ bool row_valid(int r, int Sq) const {
    return r < QT * G && q0 + r / G < Sq;
  }
  // Keys below this limit are attended by row r.
  template <bool CAUSAL>
  __device__ __forceinline__ long long row_limit(int r) const {
    const long long pos = q0 + r / G + qoff;
    return CAUSAL ? (pos + 1 < lim ? pos + 1 : lim) : lim;
  }
};

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Args a) {
  using L = Bf16Tile<HD>;
  constexpr int LDS = L::LDS, CHUNKS = L::CHUNKS;
  extern __shared__ __align__(128) __nv_bfloat16 smem[];
  __nv_bfloat16* q_s = smem;
  __nv_bfloat16* kv_s = smem + L::Q_ELEMS;  // stage st: k at 2 st, v at 2 st + 1
  const auto* qg = static_cast<const __nv_bfloat16*>(a.q);
  const auto* kg = static_cast<const __nv_bfloat16*>(a.k);
  const auto* vg = static_cast<const __nv_bfloat16*>(a.v);

  const Tile tl = Tile::make<CAUSAL>(a);
  const int b = tl.b, hkv = tl.hkv, G = tl.G, q0 = tl.q0;
  const long long kv_end = tl.kv_end;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tq = lane % 4;
  const int n_tiles = static_cast<int>((kv_end + BN - 1) / BN);
  const bool active = warp * 16 < tl.q_rows * G;

  for (int idx = tid; idx < BM * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const int qp = q0 + r / G, h = hkv * G + r % G;
    const bool ok = tl.row_valid(r, a.Sq);
    const __nv_bfloat16* src =
        ok ? qg + b * a.sqb + qp * a.sqs + h * a.sqh + c * 8 : qg;
    cp_async16(q_s + r * LDS + c * 8, src, ok ? 16 : 0);
  }
  auto load_kv = [&](int stage, int n0) {
    __nv_bfloat16* k_s = kv_s + (2 * stage) * L::KV_ELEMS;
    __nv_bfloat16* v_s = k_s + L::KV_ELEMS;
    for (int idx = tid; idx < BN * CHUNKS; idx += THREADS) {
      const int j = idx / CHUNKS, c = idx % CHUNKS;
      const long long key = n0 + j;
      const bool ok = key < kv_end;
      const __nv_bfloat16* ks =
          ok ? kg + b * a.skb + key * a.sks + hkv * a.skh + c * 8 : kg;
      const __nv_bfloat16* vs =
          ok ? vg + b * a.svb + key * a.svs + hkv * a.svh + c * 8 : vg;
      cp_async16(k_s + j * LDS + c * 8, ks, ok ? 16 : 0);
      cp_async16(v_s + j * LDS + c * 8, vs, ok ? 16 : 0);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // This thread's two rows: r0 = 16 warp + gid and r1 = r0 + 8.
  long long row_lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    row_lim[i] = tl.row_limit<CAUSAL>(warp * 16 + gid + 8 * i);

  unsigned qa[HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int nf = 0; nf < HD / 8; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nf][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_kv((t + 1) & 1, (t + 1) * BN);
    cp_async_commit();
    cp_async_wait<1>();            // tile t (and the q tile) landed
    __syncthreads();
    if (active) {
      if (t == 0) {
#pragma unroll
        for (int kd = 0; kd < HD / 16; ++kd) {
          const __nv_bfloat16* p = q_s + (warp * 16 + gid) * LDS + kd * 16 + tq * 2;
          qa[kd][0] = lds32(p);
          qa[kd][1] = lds32(p + 8 * LDS);
          qa[kd][2] = lds32(p + 8);
          qa[kd][3] = lds32(p + 8 * LDS + 8);
        }
      }
      const __nv_bfloat16* k_s = kv_s + (2 * (t & 1)) * L::KV_ELEMS;
      const __nv_bfloat16* v_s = k_s + L::KV_ELEMS;
      const int n0 = t * BN;

      // S = q k^T: 16 rows x 64 keys per warp, fp32.
      float s[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        const __nv_bfloat16* kp = k_s + (j * 8 + gid) * LDS + tq * 2;
#pragma unroll
        for (int kd = 0; kd < HD / 16; ++kd)
          mma_bf16(s[j], qa[kd], lds32(kp + kd * 16), lds32(kp + kd * 16 + 8));
      }
      // Scale, mask, and the online softmax statistics (log2 units).
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          const long long key = n0 + j * 8 + tq * 2 + (e & 1);
          const float v = key < row_lim[i] ? s[j][e] * a.scale_log2 : -INFINITY;
          s[j][e] = v;
          mx[i] = fmaxf(mx[i], v);
        }
      float base[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        base[i] = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f(m[i] - base[i]);
        m[i] = m_new;
        l[i] *= corr;
#pragma unroll
        for (int nf = 0; nf < HD / 8; ++nf) {
          o[nf][2 * i] *= corr;
          o[nf][2 * i + 1] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - base[e / 2]);
          s[j][e] = p;
          l[e / 2] += p;
        }
      // O += P v: P (bf16) is the A operand straight from the registers.
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const __nv_bfloat16* vp = v_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS
                                  + (lane >> 4) * 8;
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          unsigned vb[4];
          ldsm_x4_trans(vb, vp + np * 16);
          mma_bf16(o[2 * np], pa, vb[0], vb[1]);
          mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();               // stage t & 1 is free for tile t + 2
  }
  cp_async_wait<0>();
  if (!active) return;

  // out = O / l, written once in bf16.  Every lane takes part in the
  // shuffles before any lane skips its row.
  const float lsum[2] = {quad_sum(l[0]), quad_sum(l[1])};
  auto* og = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    const int qp = q0 + r / G, h = hkv * G + r % G;
    if (!tl.row_valid(r, a.Sq)) continue;
    const float denom = lsum[i] > 1e-20f ? lsum[i] : 1e-20f;
    __nv_bfloat16* dst = og + b * a.sob + qp * a.sos + h * a.soh + tq * 2;
#pragma unroll
    for (int nf = 0; nf < HD / 8; ++nf)
      *reinterpret_cast<__nv_bfloat162*>(dst + nf * 8) = __floats2bfloat162_rn(
          o[nf][2 * i] / denom, o[nf][2 * i + 1] / denom);
  }
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32_kernel(const Args a) {
  constexpr int LDK = F32Tile<HD>::LDK;
  constexpr int DPL = (HD + 31) / 32;      // output dims per lane
  constexpr int RPW = BM / WARPS;          // rows per warp
  extern __shared__ __align__(128) float fsmem[];
  float* q_s = fsmem;                      // BM x HD
  float* k_s = q_s + BM * HD;              // BK x LDK
  float* v_s = k_s + BK * LDK;             // BK x HD
  const auto* qg = static_cast<const float*>(a.q);
  const auto* kg = static_cast<const float*>(a.k);
  const auto* vg = static_cast<const float*>(a.v);

  const Tile tl = Tile::make<CAUSAL>(a);
  const int b = tl.b, hkv = tl.hkv, G = tl.G, q0 = tl.q0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = static_cast<int>((tl.kv_end + BK - 1) / BK);

  // Every load of a tile is issued before its stores, so the loads'
  // latencies overlap.
  {
    constexpr int N = BM * HD / THREADS;
    float r_q[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int idx = tid + u * THREADS, r = idx / HD, d = idx % HD;
      const int qp = q0 + r / G, h = hkv * G + r % G;
      r_q[u] = tl.row_valid(r, a.Sq)
                   ? qg[b * a.sqb + qp * a.sqs + h * a.sqh + d] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < N; ++u) q_s[tid + u * THREADS] = r_q[u];
  }

  float o[RPW][DPL], m[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[r][i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = t * BK;
    {
      constexpr int N = BK * HD / THREADS;
      float r_k[N], r_v[N];
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const int idx = tid + u * THREADS, j = idx / HD, d = idx % HD;
        const long long key = n0 + j;
        const bool ok = key < tl.kv_end;
        r_k[u] = ok ? kg[b * a.skb + key * a.sks + hkv * a.skh + d] : 0.f;
        r_v[u] = ok ? vg[b * a.svb + key * a.svs + hkv * a.svh + d] : 0.f;
      }
      __syncthreads();             // the previous tile is consumed
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const int idx = tid + u * THREADS, j = idx / HD, d = idx % HD;
        k_s[j * LDK + d] = r_k[u];
        v_s[idx] = r_v[u];
      }
    }
    __syncthreads();
    const long long key = n0 + lane;         // this lane's key
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      if (!tl.row_valid(r, a.Sq)) continue;  // uniform across the warp
      const float* qr = q_s + r * HD;
      const float* kr = k_s + lane * LDK;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kr[d], s);
      s = key < tl.row_limit<CAUSAL>(r) ? s * a.scale_log2 : -INFINITY;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[rr] - base);
      const float p = exp2f(s - base);
      l[rr] = l[rr] * corr + warp_sum(p);
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) o[rr][i] *= corr;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < HD) o[rr][i] = fmaf(pj, v_s[j * HD + d], o[rr][i]);
        }
      }
    }
  }

  auto* og = static_cast<float*>(a.out);
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    if (!tl.row_valid(r, a.Sq)) continue;
    const int qp = q0 + r / G, h = hkv * G + r % G;
    const float denom = l[rr] > 1e-20f ? l[rr] : 1e-20f;
    float* dst = og + b * a.sob + qp * a.sos + h * a.soh;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) dst[d] = o[rr][i] / denom;
    }
  }
}

template <int HD>
cudaError_t launch_hd(bool bf16, bool causal, const Args& a, dim3 grid,
                      cudaStream_t s) {
  auto kernel = bf16 ? (causal ? flash_fwd_kernel<HD, true>
                               : flash_fwd_kernel<HD, false>)
                     : (causal ? flash_fwd_f32_kernel<HD, true>
                               : flash_fwd_f32_kernel<HD, false>);
  const int smem = bf16 ? Bf16Tile<HD>::SMEM_BYTES : F32Tile<HD>::SMEM_BYTES;
  // Above 48 KB, dynamic shared memory must be opted into (per device).
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 fp32, 1 bf16 (q, k, v
// and out alike); hd: 16, 64 or 128.  Strides are in elements (batch,
// sequence, head of q, k, v and out; the head dim is unit-stride, and for
// bf16 the caller checks that bases and strides are 16-byte aligned).
// q_off / kv_len: device int64 vectors read at b * stride, or null for the
// constant beside them.  Launches on `stream`, does not synchronise, and
// returns the launch's CUDA error code (0 = launched).
extern "C" int flash_attention_launch(
    int dtype, int hd, const void* q, const void* k, const void* v, void* out,
    int B, int Sq, int Sk, int H, int Hkv, int causal, long long sqb,
    long long sqs, long long sqh, long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, long long sob, long long sos,
    long long soh, const void* q_off, int q_off_stride, long long q_off_const,
    const void* kv_len, int kv_len_stride, long long kv_len_const, float scale,
    void* stream) {
  if (B < 1 || Sq < 1 || Hkv < 1 || H % Hkv || H / Hkv > BM ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.Sq = Sq;
  a.Sk = Sk;
  a.G = H / Hkv;
  a.sqb = sqb; a.sqs = sqs; a.sqh = sqh;
  a.skb = skb; a.sks = sks; a.skh = skh;
  a.svb = svb; a.svs = svs; a.svh = svh;
  a.sob = sob; a.sos = sos; a.soh = soh;
  a.q_off = static_cast<const long long*>(q_off);
  a.q_off_stride = q_off_stride;
  a.q_off_const = q_off_const;
  a.kv_len = static_cast<const long long*>(kv_len);
  a.kv_len_stride = kv_len_stride;
  a.kv_len_const = kv_len_const;
  a.scale_log2 = scale * LOG2E;
  const int qt = BM / a.G;
  const dim3 grid((Sq + qt - 1) / qt, Hkv, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == 1, c = causal != 0;
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_hd<16>(bf16, c, a, grid, s); break;
    case 64: err = launch_hd<64>(bf16, c, a, grid, s); break;
    case 128: err = launch_hd<128>(bf16, c, a, grid, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
