// Flash attention forward with cache offsets for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py:
//   flash_fwd_pallas -> out = softmax(scale * q k^T + mask) v per head,
// an online softmax over KV tiles with fp32 statistics, and extends it to
// what repro/models/attention.py:flash_ref computes on the serve path:
// query i of batch row b sits at absolute position i + q_offset[b] and
// attends key j iff j < kv_valid_len[b] and, when causal,
// j <= i + q_offset[b].  Grouped-query attention: query head h reads KV
// head h / G, G = H / Hkv.  q (B, Sq, H, hd), k (B, Sk, Hkv, hd), v
// (B, Sk, Hkv, hd_v) and the output (B, Sq, H, hd_v) are all bf16 or all
// fp32 with a unit-stride head dim; (hd, hd_v) is (16, 16), (64, 64),
// (80, 80) or (128, 128) (128 is the width of the GQA models, 80
// HuBERT-XLarge's, 16 the reduced configurations'), or (192, 128):
// DeepSeek-V3's MLA prefill, whose q and k are nope 128 + rope 64 wide and
// whose v is 128 (repro/models/attention.py:mla_prefill; kernels 1 and 2
// take it in bf16, kernel 4 in fp32).
// q_offset and kv_valid_len are read on the device (a (B,) int64 vector or
// one constant), so the caller never syncs with the host.  In every kernel
// a row with no valid key gives 0.
//
// Rows.  Every kernel works on rows that are (query position, head of
// the GQA group) pairs: row r of a group is position r / G, head
// hkv * G + r % G, so one K/V tile read from the cache serves all G query
// heads of its KV head (no repeat over heads, no fp32 copy of the cache).
//
// Four kernels; the wrapper (ops.py, plan_launch) picks one from the
// shapes alone, never from the device-held lengths:
//
// 1. flash_split_kernel + flash_combine_kernel (bf16 and fp32, hd 16, 64,
//    128; bf16 (192, 128)): every launch at those dims whose prefill grid
//    (q tiles x Hkv x B) would not fill the card, which is every decode
//    step.  (hd 80 and fp32 (192, 128) never decode here -- HuBERT is an
//    encoder, MLA decode attends on its latent cache -- so their short
//    launches take kernel 2 or 4 whatever the grid.)  A decode step is
//    bound by the bytes of the valid cache (GLM-4.5-Air at batch 4: 45.8 MB,
//    13.7 us at 3.35 TB/s).  Blocks are (split of the keys, row tile of at
//    most RT rows, KV head, batch row); the number of splits comes from
//    the cache capacity Sk so that the grid holds at least two blocks per
//    SM, and a split that starts past its row's valid length writes an
//    empty partial (m = -inf, l = 0) and exits.  Inside a block each warp
//    streams its own 32-key tiles through its own 3-stage cp.async ring in
//    16-byte pieces, neighbouring lanes on neighbouring addresses, and
//    keeps its own online softmax, so the warps never wait for each other
//    until the end.  bf16 computes both products on the tensor cores
//    (mma.sync m16n8k16: the 16 rows of a row tile are one fragment, P is
//    fed from the registers, V through ldmatrix.trans): the same products
//    in fp32 on the CUDA cores ran slower than SDPA at Qwen3's 16 rows on
//    an H100.  fp32 keeps fp32 arithmetic on the CUDA cores: lane =
//    key for S = q k^T with q (pre-scaled) broadcast from shared memory,
//    the row max by warp shuffles, P through a small shared buffer, lane =
//    output dims for P v.  The warps' partials are merged in shared memory;
//    with one split the block writes the output, otherwise (m, l, acc) in
//    fp32 to a workspace, and the combine kernel (one warp per output row)
//    computes
//      out = sum_i 2^(m_i - m) acc_i / sum_i 2^(m_i - m) l_i.
//    At (192, 128) a K row is 24 pieces, which do not divide the warp, so
//    its lanes copy the tile's pieces in row-major order; the ring's stages
//    are 21 KB and three warps fit (four at hd 128).  MLA prefill takes it
//    at B 1 for chunks of at most 128 tokens (128 KV heads fill fewer than
//    132 SMs).
//
// 2. flash_wgmma_kernel (bf16, hd 64, 80, 128 and (192, 128)): every other
//    bf16 launch, which is every serve prefill chunk.  Bound by operations
//    (the GLM chunk at offset 4096: 412 GFLOP of causal pairs, 0.42 ms at
//    989 TFLOP/s, against 29 MB of bytes).  Warp-specialised as
//    grouped_gemm_wgmma_kernel: warpgroup 2 is the producer, one thread of
//    which issues TMA loads (4-D tensor maps over (hd, heads, positions,
//    batch), 64-column boxes with 128-byte swizzle, mbarrier completion):
//    the 128-row q tile once, as one box of 128 / G positions x G heads
//    starting at head hkv * G, and K and V tiles of 128 keys into a ring of
//    STAGES stages.  Warpgroups 0 and 1 (64 rows each) compute
//    S = Q K^T with wgmma m64n128k16 (both operands K-major in shared
//    memory), the online softmax in fp32 registers (masking only the tiles
//    that cross the causal diagonal or the valid length), round P to bf16
//    and repack the S accumulator into wgmma A fragments in registers
//    (the m64nN accumulator and the k16 A fragment share their thread
//    layout, two columns per register), then O += P V with wgmma
//    m64nHDk16, A from registers and V read N-major through the transpose
//    bit.  setmaxnreg moves registers from the producer to the consumers.
//    Keys past the valid length inside the last tile are read (TMA copies
//    whole boxes) and masked; like the plain version, the kernel takes the
//    cache there to be finite (the serve cache is zero-initialised).
//    The 1-D grid runs each (batch row, KV head)'s q tiles in reverse
//    position order, heaviest first, so the causal tail does not leave SMs
//    idle, and neighbouring blocks share their K/V in L2.  The KV loop ends
//    at min(kv_valid_len, last position + 1), read on the device.  The
//    output is written once, in bf16.  The one departure from flash_ref's
//    fp32 arithmetic is P in bf16 for the P v product.
//    Shared memory at hd 128: q 32 KB + 2 stages x (K 32 KB + V 32 KB) =
//    160 KB (hd 64: 16 KB + 4 stages x 32 KB).  At (192, 128), DeepSeek-V3's
//    MLA prefill (128 heads, Hkv = H, G 1): a q or K row is three 64-column
//    boxes and a V row two, so S = q K^T takes 12 k-steps of m64n128k16 in
//    place of 8 and P V keeps N = 128 (the registers are those of hd 128);
//    q 48 KB + 2 stages x (K 48 KB + V 32 KB) = 208 KB + the barriers, of
//    the 227 KB a block may have.  The bound is still the operations: 320
//    flops a pair (192 for S, 128 for P V) against 256 at hd 128.
//    At hd 80 (HuBERT-XLarge, bidirectional) the kernel runs the hd-128
//    tiles with tensor maps of the true width: a row is two 64-column
//    boxes, and TMA fills columns 80-127 of the second with zeros, so S
//    and P V run at 128 and 37.5% of their products multiply zeros; only
//    80 output columns are written (Args::hd_out).  A 16-column box with
//    a 32-byte swizzle would save that share at the cost of a second
//    descriptor layout.
//
// 3. flash_fwd_kernel (bf16, hd 16 only: the reduced configurations' width,
//    which no served model uses): the first, simple tensor-core version.
//    One block of 4 warps per (64-row q tile, KV head, batch row); each
//    warp owns 16 rows with its q fragments in registers; 64-key K/V tiles
//    through a 2-stage cp.async ring; mma.sync m16n8k16 for both
//    products, P fed from the registers.
//
// 4. flash_fwd_f32_kernel (fp32 prefill: fp32 serving, every prefill chunk
//    of `python -m repro_torch.launch.serve` by default, and the reduced
//    configurations; q/k and v head dims apart: (16, 16), (64, 64),
//    (80, 80), (128, 128) and MLA's (192, 128), 131 KB of shared memory
//    there, one block an SM).  flash_ref computes in fp32; on the CUDA
//    cores that work is bound by the fp32 rate (GLM's fp32 case, 1024 queries at
//    offset 1024: 25.8 GFLOP of causal pairs, 0.385 ms at 67 TFLOP/s), and
//    a kernel that feeds each FMA from shared memory reaches a fraction of
//    it.  So both products run on the tensor cores in 3xTF32: each fp32
//    operand is split into hi + lo, two TF32 values (hi the 10-bit
//    truncation, lo the rest, which the tensor core truncates in turn:
//    |x - hi - lo| < 2^-20 |x|), and a b = a_lo b_hi + a_hi b_lo +
//    a_hi b_hi on mma.sync m16n8k8 with fp32 accumulation: each product
//    keeps about 2^-20 (fp32: 2^-24; plain TF32 misses flash_ref by ~3e-3
//    of a row).  The
//    tensor core truncates as it accumulates, so P v sums each tile in
//    fresh registers that are added to O in fp32, and S keeps its small
//    terms apart from its large ones (one chain over 10k keys would miss
//    the 1e-4 tolerance).  Three products at the TF32 rate (495 TFLOP/s)
//    bound it at 0.156 ms there; at the fp32 serve path's shape (4096
//    queries at offset 4096, 8192 keys: 412 GFLOP) at 2.50 ms, where it
//    takes 7.78 ms on an H100, 0.85x the mask-free SDPA (chip_smoke.py).
//    Blocks and rows as kernel 3 (4 warps of 16 rows, q tiles in reverse
//    position order, heaviest first); q, K and V stay fp32 in shared memory
//    (rows HD + 4 floats apart: conflict-free fragment reads), K/V tiles
//    of 32 keys in a 2-stage cp.async ring (99 KB at hd 128: two blocks an
//    SM), q pre-scaled once and split as it is read, the S accumulator split
//    and repacked in registers as the A fragment of P v (keys permuted
//    within each 8-key step, V read in the same order), masking only on
//    tiles that cross a row's limit.
//
// Every kernel writes each row's logsumexp beside the output when asked
// (Args::lse): the training step's forward, whose backward kernels
// (flash_attention_bwd.cu, flash_attention_bwd_mma.cu) read it, and a
// decode step's partial over one shard of a sequence-sharded cache, whose
// shards are combined by their logsumexps (models/attention.py).  The
// split-KV kernel writes it where it writes the output: the block with one
// split, else the combine kernel from the splits' (m, l).
//
// Not yet: overlapping one tile's softmax with the next tile's products in
// the wgmma kernel (two consumer warpgroups interleave only as the
// scheduler lets them), a persistent schedule, TMA in the split kernel
// (a decode step stays at about twice its bytes bound), and wgmma for the
// fp32 kernel's TF32 products (K and V are split anew by each warp).

#include <cuda.h>   // CUtensorMap and its enums only: no link against libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_wgmma.cuh"
#include "hopper_tma.cuh"
#include "warp_mma.cuh"

namespace {

// Kernels 3 and 4.
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BM = 16 * WARPS;          // rows per block
constexpr int BN = 64;                  // keys per tile (mma.sync kernel)
constexpr int F32_BN = 32;              // keys per tile (fp32 kernel)
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory layout of the mma.sync kernel for head dim HD.
template <int HD>
struct Bf16Tile {
  static constexpr int LDS = HD + 8;    // shared row stride, elements
  static constexpr int Q_ELEMS = BM * LDS;
  static constexpr int KV_ELEMS = BN * LDS;
  static constexpr int SMEM_BYTES = (Q_ELEMS + 4 * KV_ELEMS) * 2;  // q, 2 x (k, v)
  static constexpr int CHUNKS = HD * 2 / 16;   // 16-byte pieces per row
};

// Shared-memory layout of the fp32 kernel for q/k head dim HDK and v head
// dim HDV: q, then two stages of (k, v).  q and K rows are HDK + 4 floats
// apart, V rows HDV + 4, so the m16n8k8 fragments' reads (row gid, column
// tq of q and k; rows 2 tq, 2 tq + 1, column gid of v) hit 32 distinct
// banks, and each row starts on 16 bytes.  At (192, 128) that is 131 KB,
// one block an SM.
template <int HDK, int HDV>
struct F32Tile {
  static constexpr int LDK = HDK + 4, LDV = HDV + 4;
  static constexpr int Q_FLOATS = BM * LDK;
  static constexpr int K_FLOATS = F32_BN * LDK;
  static constexpr int STAGE_FLOATS = F32_BN * (LDK + LDV);   // K then V
  static constexpr int SMEM_BYTES = (Q_FLOATS + 2 * STAGE_FLOATS) * 4;
  static constexpr int CHUNKS_K = HDK / 4;   // 16-byte pieces per row
  static constexpr int CHUNKS_V = HDV / 4;
  static_assert(SMEM_BYTES <= 232448, "above a block's shared memory");
};

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
  int B, Sq, Sk, H, Hkv, G;
  long long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, sob, sos, soh;
  const long long* q_off;   // null: q_off_const for every row
  int q_off_stride;
  long long q_off_const;
  const long long* kv_len;  // null: kv_len_const for every row
  int kv_len_stride;
  long long kv_len_const;
  float scale_log2;         // scale * log2(e): scores are kept in log2 units
  bool causal;
  // Split-KV kernel only.
  int n_rt;                 // row tiles per (KV head, batch row)
  int splits;               // key splits; 1: the blocks write the output
  int keys_per_split;
  float* ws;                // splits x (B Sq H) x (hd + 2) fp32 partials
  // Null, or (B, H, Sq) fp32 that receives each row's logsumexp of its
  // scaled scores, natural log (+inf for a row with no valid key).
  float* lse;
  // TMA + wgmma kernel only: the output columns written, hd_v (below the
  // tile's HDV where the head dim is zero-filled up to whole boxes).
  int hd_out;

  __device__ __forceinline__ long long qoff(int b) const {
    return q_off ? q_off[b * q_off_stride] : q_off_const;
  }
  // min(kv_valid_len[b], Sk), at least 0.
  __device__ __forceinline__ long long limit(int b) const {
    const long long lim = kv_len ? kv_len[b * kv_len_stride] : kv_len_const;
    return lim < 0 ? 0 : (lim < Sk ? lim : Sk);
  }
};

// Row (b, h, position)'s logsumexp of its scaled scores, natural log: m
// is the row max in log2 units, l = sum 2^(s - m); +inf for a row with no
// valid key (P = 0 in the backward, weight 0 in a combine of shards).
__device__ __forceinline__ void store_lse(const Args& a, int b, int h,
                                          int pos, float m, float l) {
  a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + pos] =
      l > 0.f ? (m + log2f(l)) * 0.6931471805599453f : INFINITY;
}

// This block's rows and KV extent, shared by kernels 3 and 4.  Row r of the
// tile is (position q0 + r / G, head hkv * G + r % G).
struct Tile {
  int b, hkv, G, QT, q0, q_rows;
  long long qoff, lim, kv_end;

  template <bool CAUSAL>
  __device__ __forceinline__ static Tile make(const Args& a, int tile) {
    Tile t;
    t.b = blockIdx.z;
    t.hkv = blockIdx.y;
    t.G = a.G;
    t.QT = BM / a.G;                       // query positions per tile
    t.q0 = tile * t.QT;
    t.qoff = a.qoff(t.b);
    t.lim = a.limit(t.b);
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

// The logsumexp of this thread's two rows of a kernel 3 or 4 tile, after
// the output is written (the accumulators are dead by then).
__device__ __forceinline__ void store_lse_rows(const Args& a, const Tile& tl,
                                               int warp, int gid,
                                               const float (&m)[2],
                                               const float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    if (tl.row_valid(r, a.Sq))
      store_lse(a, tl.b, tl.hkv * tl.G + r % tl.G, tl.q0 + r / tl.G, m[i],
                l[i]);
  }
}

// LSE: the instantiation that writes the logsumexp (the training step's
// forward); the serve path's keeps the epilogue without it.
template <int HD, bool CAUSAL, bool LSE>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Args a) {
  using L = Bf16Tile<HD>;
  constexpr int LDS = L::LDS, CHUNKS = L::CHUNKS;
  extern __shared__ __align__(128) __nv_bfloat16 smem[];
  __nv_bfloat16* q_s = smem;
  __nv_bfloat16* kv_s = smem + L::Q_ELEMS;  // stage st: k at 2 st, v at 2 st + 1
  const auto* qg = static_cast<const __nv_bfloat16*>(a.q);
  const auto* kg = static_cast<const __nv_bfloat16*>(a.k);
  const auto* vg = static_cast<const __nv_bfloat16*>(a.v);

  const Tile tl = Tile::make<CAUSAL>(a, blockIdx.x);
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
  if (LSE && tq == 0) store_lse_rows(a, tl, warp, gid, m, lsum);
}

template <int HDK, int HDV, bool CAUSAL, bool LSE>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_f32_kernel(const Args a) {
  using L = F32Tile<HDK, HDV>;
  constexpr int LD = L::LDK, LDV = L::LDV, BN = F32_BN;
  constexpr int CHUNKS = L::CHUNKS_K, CHUNKS_V = L::CHUNKS_V;
  extern __shared__ __align__(128) float fsmem[];
  float* q_s = fsmem;
  float* kv_s = fsmem + L::Q_FLOATS;  // stage st: k, then v
  const auto* qg = static_cast<const float*>(a.q);
  const auto* kg = static_cast<const float*>(a.k);
  const auto* vg = static_cast<const float*>(a.v);

  // The q tiles run in reverse position order, heaviest (longest causal
  // extent) first, so the short tiles fill the last wave.
  const Tile tl = Tile::make<CAUSAL>(a, gridDim.x - 1 - blockIdx.x);
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
    const float* src = ok ? qg + b * a.sqb + qp * a.sqs + h * a.sqh + c * 4 : qg;
    cp_async16(q_s + r * LD + c * 4, src, ok ? 16 : 0);
  }
  auto load_kv = [&](int stage, int n0) {
    float* k_s = kv_s + stage * L::STAGE_FLOATS;
    float* v_s = k_s + L::K_FLOATS;
    for (int idx = tid; idx < BN * CHUNKS; idx += THREADS) {
      const int j = idx / CHUNKS, c = idx % CHUNKS;
      const long long key = n0 + j;
      const bool ok = key < kv_end;
      const float* ks = ok ? kg + b * a.skb + key * a.sks + hkv * a.skh + c * 4 : kg;
      cp_async16(k_s + j * LD + c * 4, ks, ok ? 16 : 0);
    }
    for (int idx = tid; idx < BN * CHUNKS_V; idx += THREADS) {
      const int j = idx / CHUNKS_V, c = idx % CHUNKS_V;
      const long long key = n0 + j;
      const bool ok = key < kv_end;
      const float* vs = ok ? vg + b * a.svb + key * a.svs + hkv * a.svh + c * 4 : vg;
      cp_async16(v_s + j * LDV + c * 4, vs, ok ? 16 : 0);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // This thread's two rows, r0 = 16 warp + gid and r1 = r0 + 8, and the
  // warp's smallest key limit (its first row's): a tile below it needs no
  // mask.
  long long row_lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    row_lim[i] = tl.row_limit<CAUSAL>(warp * 16 + gid + 8 * i);
  const long long warp_lim = tl.row_limit<CAUSAL>(warp * 16);

  float o[HDV / 8][4];
#pragma unroll
  for (int nf = 0; nf < HDV / 8; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nf][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_kv((t + 1) & 1, (t + 1) * BN);
    cp_async_commit();
    cp_async_wait<1>();            // tile t (and the q tile) landed
    __syncthreads();
    if (t == 0) {                  // q *= scale log2 e, once
      for (int idx = tid; idx < BM * HDK; idx += THREADS)
        q_s[(idx / HDK) * LD + idx % HDK] *= a.scale_log2;
      __syncthreads();
    }
    if (active) {
      const float* k_s = kv_s + (t & 1) * L::STAGE_FLOATS;
      const float* v_s = k_s + L::K_FLOATS;
      const int n0 = t * BN;

      // S = (scale log2 e) q k^T: 16 rows x BN keys per warp, 3xTF32,
      // the a_hi b_hi terms in s and the two small ones in s_lo.
      float s[BN / 8][4], s_lo[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = s_lo[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < HDK / 8; ++kd) {
        const float* qp = q_s + (warp * 16 + gid) * LD + kd * 8 + tq;
        unsigned ah[4], al[4];
        split_tf32(qp[0], ah[0], al[0]);
        split_tf32(qp[8 * LD], ah[1], al[1]);
        split_tf32(qp[4], ah[2], al[2]);
        split_tf32(qp[8 * LD + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float* kp = k_s + (j * 8 + gid) * LD + kd * 8 + tq;
          unsigned bh[2], bl[2];
          split_tf32(kp[0], bh[0], bl[0]);
          split_tf32(kp[4], bh[1], bl[1]);
          mma_3xtf32(s[j], s_lo[j], ah, al, bh, bl);
        }
      }
      // Mask (only a tile that crosses a row's limit) and the online
      // softmax statistics, in log2 units.
      const bool edge = n0 + BN > warp_lim;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          const long long key = n0 + j * 8 + tq * 2 + (e & 1);
          const float sum = s[j][e] + s_lo[j][e];
          const float v = edge && key >= row_lim[i] ? -INFINITY : sum;
          s[j][e] = v;
          mx[i] = fmaxf(mx[i], v);
        }
      float base[2], corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        base[i] = m_new == -INFINITY ? 0.f : m_new;
        corr[i] = exp2f(m[i] - base[i]);
        m[i] = m_new;
        l[i] *= corr[i];
      }
      // P, split, as the A fragments of P v: the S accumulator with the
      // keys of each 8-key step permuted (A column tq holds key 2 tq,
      // column tq + 4 key 2 tq + 1), so v's rows are read in that order.
      unsigned ph[BN / 8][4], pl[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - base[e / 2]);
          l[e / 2] += p;
          const int at = (e & 1) * 2 + e / 2;    // 0, 2, 1, 3
          split_tf32(p, ph[j][at], pl[j][at]);
        }
      // O = corr O + P v, 3xTF32.  Each 8-dim column block sums this
      // tile's products in fresh registers (the tensor core's truncating
      // accumulation stays 3 BN / 8 steps long) and adds them to O in
      // fp32.
      const float* vp = v_s + 2 * tq * LDV + gid;
#pragma unroll
      for (int nf = 0; nf < HDV / 8; ++nf) {
        float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) {
          unsigned bh[2], bl[2];
          split_tf32(vp[kk * 8 * LDV + nf * 8], bh[0], bl[0]);
          split_tf32(vp[(kk * 8 + 1) * LDV + nf * 8], bh[1], bl[1]);
          mma_3xtf32(big, small, ph[kk], pl[kk], bh, bl);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[nf][e] = fmaf(o[nf][e], corr[e / 2], big[e] + small[e]);
      }
    }
    __syncthreads();               // stage t & 1 is free for tile t + 2
  }
  cp_async_wait<0>();
  if (!active) return;

  const float lsum[2] = {quad_sum(l[0]), quad_sum(l[1])};
  auto* og = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    const int qp = q0 + r / G, h = hkv * G + r % G;
    if (!tl.row_valid(r, a.Sq)) continue;
    const float denom = lsum[i] > 1e-20f ? lsum[i] : 1e-20f;
    float* dst = og + b * a.sob + qp * a.sos + h * a.soh + tq * 2;
#pragma unroll
    for (int nf = 0; nf < HDV / 8; ++nf)
      *reinterpret_cast<float2*>(dst + nf * 8) =
          make_float2(o[nf][2 * i] / denom, o[nf][2 * i + 1] / denom);
  }
  if (LSE && tq == 0) store_lse_rows(a, tl, warp, gid, m, lsum);
}

// ------------------------------------------------- 1. split-KV (decode)

constexpr int SPLIT_STAGES = 3;
constexpr int SPLIT_KW = 32;             // keys per warp tile: lane = key

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory layout of the split kernel for element T, head dims HDK
// (q, k) and HDV (v, out) and RT rows a block: per warp a ring of
// SPLIT_STAGES K and V tiles of 32 keys (rows padded by 16 bytes, so lane
// j's 16-byte reads of row j, the mma fragments' 32-bit reads and ldmatrix
// hit distinct banks), then q (bf16 rows padded likewise for the mma path,
// fp32 pre-scaled for the CUDA-core path), each warp's P (CUDA-core path:
// RT x 32 fp32) and the rows' key limits (RT ints).  bf16 takes the
// mma.sync path (RT 16, the m16 of one fragment), fp32 the CUDA-core path,
// which takes one head dim.
template <typename T, int HDK, int HDV, int RT>
struct SplitCfg {
  static constexpr bool MMA = sizeof(T) == 2;
  static_assert(!MMA || RT == 16, "the mma path computes 16 rows");
  static_assert(MMA || HDK == HDV, "the CUDA-core path takes one head dim");
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // per piece
  static constexpr int LDK = HDK + VEC;                   // q and K rows
  static constexpr int LDV = HDV + VEC;                   // V rows
  static constexpr int PIECES_K = HDK / VEC;              // pieces per row
  static constexpr int PIECES_V = HDV / VEC;
  static constexpr int K_ELEMS = SPLIT_KW * LDK;          // V follows K
  static constexpr int STAGE_ELEMS = SPLIT_KW * (LDK + LDV);
  static constexpr int STAGE_BYTES = STAGE_ELEMS * static_cast<int>(sizeof(T));
  // As many warps as their rings fit in 210 KB, at most 8: the warps of
  // one SM keep its loads in flight (4 at bf16 hd 128, 3 at bf16
  // (192, 128), 2 at fp32 hd 128).
  static constexpr int WARPS =
      210 * 1024 / (SPLIT_STAGES * STAGE_BYTES) < 8
          ? 210 * 1024 / (SPLIT_STAGES * STAGE_BYTES) : 8;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int DPL = HDV >= 32 ? HDV / 32 : 1;   // dims per lane
  static constexpr int RING_BYTES = WARPS * SPLIT_STAGES * STAGE_BYTES;
  static constexpr int Q_BYTES = MMA ? RT * LDK * 2 : RT * HDK * 4;
  static constexpr int P_BYTES = MMA ? 0 : WARPS * RT * SPLIT_KW * 4;
  static constexpr int SMEM_BYTES = RING_BYTES + Q_BYTES + P_BYTES + RT * 4;
  static_assert(WARPS * RT * (HDV + 2) * 4 <= RING_BYTES,
                "the warps' partials are merged in the ring's memory");
};

// One 32-key tile of rows of PIECES 16-byte pieces, from key row key0 of
// `src` (rows `stride` elements apart) into `dst` (rows LD apart); keys at
// or past k_hi are zero-filled (from `any`, a valid address).  Where the
// pieces of a row divide the warp, lane l copies piece l % PIECES of rows
// l / PIECES + 32 / PIECES u (one base pointer, stepped); otherwise lane l
// copies pieces l, l + 32, ... of the tile in row-major order.
template <typename T, int PIECES, int LD>
__device__ __forceinline__ void load_split_tile(T* dst, const T* src,
                                                long long stride,
                                                long long key0,
                                                long long k_hi, int lane,
                                                const T* any) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  if constexpr (32 % PIECES == 0) {
    constexpr int JSTEP = 32 / PIECES;
    const int pc = lane % PIECES, j0 = lane / PIECES;
    const T* s = src + (key0 + j0) * stride + pc * VEC;
    T* d = dst + j0 * LD + pc * VEC;
#pragma unroll
    for (int u = 0; u < SPLIT_KW / JSTEP; ++u) {
      const bool ok = key0 + j0 + u * JSTEP < k_hi;
      cp_async16(d + u * JSTEP * LD, ok ? s : any, ok ? 16 : 0);
      s += JSTEP * stride;
    }
  } else {
#pragma unroll
    for (int u = 0; u < SPLIT_KW * PIECES / 32; ++u) {
      const int idx = lane + 32 * u, j = idx / PIECES, pc = idx % PIECES;
      const bool ok = key0 + j < k_hi;
      cp_async16(dst + j * LD + pc * VEC,
                 ok ? src + (key0 + j) * stride + pc * VEC : any,
                 ok ? 16 : 0);
    }
  }
}

// N consecutive fp32 values from shared memory in one vector load (the
// CUDA-core path is fp32 only).
template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* src) {
  if constexpr (N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    dst[0] = f.x; dst[1] = f.y; dst[2] = f.z; dst[3] = f.w;
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(src);
    dst[0] = f.x; dst[1] = f.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

template <typename T, int HDK, int HDV, int RT>
__global__ void __launch_bounds__(SplitCfg<T, HDK, HDV, RT>::THREADS)
flash_split_kernel(const Args a) {
  using C = SplitCfg<T, HDK, HDV, RT>;
  constexpr int W = C::WARPS, LDK = C::LDK, LDV = C::LDV, VEC = C::VEC;
  constexpr int DPL = C::DPL, PIECES = C::PIECES_K, KW = SPLIT_KW;
  constexpr int S = SPLIT_STAGES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  unsigned char* q_raw = smem_raw + C::RING_BYTES;
  float* p_all = reinterpret_cast<float*>(q_raw + C::Q_BYTES);
  int* rl = reinterpret_cast<int*>(q_raw + C::Q_BYTES + C::P_BYTES);
  const auto* qg = static_cast<const T*>(a.q);
  const auto* kg = static_cast<const T*>(a.k);
  const auto* vg = static_cast<const T*>(a.v);

  const int split = blockIdx.x;
  const int hkv = blockIdx.y / a.n_rt, rt = blockIdx.y % a.n_rt;
  const int b = blockIdx.z;
  const int G = a.G;
  const int r0 = rt * RT;                         // first row of the tile
  const int nrows = min(RT, a.Sq * G - r0);
  const long long qoff = a.qoff(b), lim = a.limit(b);
  long long kv_end = lim;
  if (a.causal) {
    const long long last = (r0 + nrows - 1) / G + qoff + 1;
    kv_end = last < kv_end ? last : kv_end;
  }
  const long long k_lo = static_cast<long long>(split) * a.keys_per_split;
  long long k_hi = k_lo + a.keys_per_split;
  k_hi = k_hi < kv_end ? k_hi : kv_end;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long NR = static_cast<long long>(a.B) * a.Sq * a.H;
  auto out_row = [&](int r) {   // (position, head) of row r of the tile
    const int gr = r0 + r;
    return make_int2(gr / G, hkv * G + gr % G);
  };

  if (k_lo >= k_hi) {
    // Nothing to read: with one split the rows get 0 (no valid key),
    // otherwise an empty partial that the combine skips.
    for (int i = tid; i < nrows * HDV; i += C::THREADS) {
      const int r = i / HDV, d = i % HDV;
      const int2 ph = out_row(r);
      if (a.splits == 1) {
        static_cast<T*>(a.out)[b * a.sob + ph.x * a.sos + ph.y * a.soh + d] =
            from_f32<T>(0.f);
        if (a.lse != nullptr && d == 0) store_lse(a, b, ph.y, ph.x, 0.f, 0.f);
      } else if (d == 0) {
        const long long orow = (static_cast<long long>(b) * a.Sq + ph.x) * a.H
                               + ph.y;
        float* ml = a.ws + NR * a.splits * HDV + (split * NR + orow) * 2;
        ml[0] = -INFINITY;
        ml[1] = 0.f;
      }
    }
    return;
  }

  // q rows in 16-byte pieces, every load issued before its store; rows
  // past the tile are 0.  Keys below rl[r] are attended by row r (and lie
  // in this split); every lane reads the same row limit.
  {
    constexpr int QN = (RT * PIECES + C::THREADS - 1) / C::THREADS;
    uint4 qv[QN];
#pragma unroll
    for (int u = 0; u < QN; ++u) {
      const int idx = tid + u * C::THREADS, r = idx / PIECES;
      qv[u] = make_uint4(0, 0, 0, 0);
      if (idx < RT * PIECES && r < nrows) {
        const int2 ph = out_row(r);
        qv[u] = *reinterpret_cast<const uint4*>(
            qg + b * a.sqb + ph.x * a.sqs + ph.y * a.sqh + idx % PIECES * VEC);
      }
    }
#pragma unroll
    for (int u = 0; u < QN; ++u) {
      const int idx = tid + u * C::THREADS, r = idx / PIECES;
      const int d = idx % PIECES * VEC;
      if (idx >= RT * PIECES) continue;
      if constexpr (C::MMA) {
        *reinterpret_cast<uint4*>(reinterpret_cast<T*>(q_raw) + r * LDK + d) =
            qv[u];
      } else {
        const float4 f = *reinterpret_cast<const float4*>(&qv[u]);
        *reinterpret_cast<float4*>(reinterpret_cast<float*>(q_raw) + r * HDK +
                                   d) =
            make_float4(f.x * a.scale_log2, f.y * a.scale_log2,
                        f.z * a.scale_log2, f.w * a.scale_log2);
      }
    }
  }
  if (tid < RT) {
    long long v = 0;
    if (tid < nrows) {
      const long long pos = (r0 + tid) / G + qoff;
      v = a.causal && pos + 1 < lim ? pos + 1 : lim;
      v = v < k_hi ? v : k_hi;
    }
    rl[tid] = static_cast<int>(v);
  }
  __syncthreads();

  // This warp's 32-key tiles of the split: t = warp, warp + W, ...
  const int n_tiles = static_cast<int>((k_hi - k_lo + KW - 1) / KW);
  const int my_tiles = warp < n_tiles ? (n_tiles - warp + W - 1) / W : 0;
  T* my_ring = ring + warp * S * C::STAGE_ELEMS;
  const T* k_rows = kg + b * a.skb + hkv * a.skh;
  const T* v_rows = vg + b * a.svb + hkv * a.svh;
  auto load = [&](int slot, int i) {
    const long long key0 = k_lo + static_cast<long long>(warp + i * W) * KW;
    T* k_s = my_ring + slot * C::STAGE_ELEMS;
    load_split_tile<T, C::PIECES_K, LDK>(k_s, k_rows, a.sks, key0, k_hi, lane,
                                         kg);
    load_split_tile<T, C::PIECES_V, LDV>(k_s + C::K_ELEMS, v_rows, a.svs, key0,
                                         k_hi, lane, vg);
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < my_tiles) load(i, i);
    cp_async_commit();
  }
  // Wait for tile i (every lane's pieces) and return its K and V.
  auto next_tile = [&](int i) {
    if (i + S - 1 < my_tiles) load((i + S - 1) % S, i + S - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();
    __syncwarp();
    return my_ring + (i % S) * C::STAGE_ELEMS;
  };
  float* c_acc = reinterpret_cast<float*>(smem_raw);   // W x RT x HDV
  float* c_m = c_acc + W * RT * HDV;                   // W x RT
  float* c_l = c_m + W * RT;

  if constexpr (C::MMA) {
    // bf16: both products on the tensor cores (mma.sync m16n8k16, fp32
    // accumulate), the 16 rows as one m16 fragment; this thread holds
    // rows gid and gid + 8, keys / dims 8 j + 2 tq + {0, 1}.
    const int gid = lane / 4, tq = lane % 4;
    const T* q_s = reinterpret_cast<const T*>(q_raw);
    unsigned qa[HDK / 16][4];
#pragma unroll
    for (int kd = 0; kd < HDK / 16; ++kd) {
      const T* p = q_s + gid * LDK + kd * 16 + tq * 2;
      qa[kd][0] = lds32(p);
      qa[kd][1] = lds32(p + 8 * LDK);
      qa[kd][2] = lds32(p + 8);
      qa[kd][3] = lds32(p + 8 * LDK + 8);
    }
    const int row_lim[2] = {rl[gid], rl[gid + 8]};
    float o[HDV / 8][4];
#pragma unroll
    for (int nf = 0; nf < HDV / 8; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nf][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int i = 0; i < my_tiles; ++i) {
      const T* k_s = next_tile(i);
      const T* v_s = k_s + C::K_ELEMS;
      const int key0 = static_cast<int>(k_lo) + (warp + i * W) * KW;
      float s[KW / 8][4];
#pragma unroll
      for (int j = 0; j < KW / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        const T* kp = k_s + (j * 8 + gid) * LDK + tq * 2;
#pragma unroll
        for (int kd = 0; kd < HDK / 16; ++kd)
          mma_bf16(s[j], qa[kd], lds32(kp + kd * 16), lds32(kp + kd * 16 + 8));
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + j * 8 + tq * 2 + (e & 1);
          const float v =
              key < row_lim[e >> 1] ? s[j][e] * a.scale_log2 : -INFINITY;
          s[j][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      float base[2];
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const float m_new = fmaxf(m[ii], quad_max(mx[ii]));
        base[ii] = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f(m[ii] - base[ii]);
        m[ii] = m_new;
        l[ii] *= corr;
#pragma unroll
        for (int nf = 0; nf < HDV / 8; ++nf) {
          o[nf][2 * ii] *= corr;
          o[nf][2 * ii + 1] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < KW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - base[e >> 1]);
          s[j][e] = p;
          l[e >> 1] += p;
        }
      // O += P v: P (bf16) is the A operand straight from the registers,
      // V's fragments through ldmatrix.trans.
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const T* vp = v_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV
                      + (lane >> 4) * 8;
#pragma unroll
        for (int np = 0; np < HDV / 16; ++np) {
          unsigned vb[4];
          ldsm_x4_trans(vb, vp + np * 16);
          mma_bf16(o[2 * np], pa, vb[0], vb[1]);
          mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
      __syncwarp();                             // the slot is free
    }
    cp_async_wait<0>();
    const float lsum[2] = {quad_sum(l[0]), quad_sum(l[1])};
    __syncthreads();                            // every ring is drained
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int r = gid + 8 * ii;
#pragma unroll
      for (int nf = 0; nf < HDV / 8; ++nf) {
        c_acc[(warp * RT + r) * HDV + nf * 8 + tq * 2] = o[nf][2 * ii];
        c_acc[(warp * RT + r) * HDV + nf * 8 + tq * 2 + 1] = o[nf][2 * ii + 1];
      }
      if (tq == 0) {
        c_m[warp * RT + r] = m[ii];
        c_l[warp * RT + r] = lsum[ii];
      }
    }
  } else {
    // fp32: lane = key for S (q broadcast from shared memory), P through
    // a shared buffer, lane = output dims for P v, all on the CUDA cores.
    const float* q_s = reinterpret_cast<const float*>(q_raw);
    float* p_s = p_all + warp * RT * KW;
    float m[RT], l[RT], acc[RT][DPL];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[r][d] = 0.f;
    }
    const bool owns_dims = lane * DPL < HDV;    // false only at hd 16
    for (int i = 0; i < my_tiles; ++i) {
      const T* k_s = next_tile(i);
      const T* v_s = k_s + C::K_ELEMS;
      const int key = static_cast<int>(k_lo) + (warp + i * W) * KW + lane;
      float s[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) s[r] = 0.f;
#pragma unroll 4
      for (int c = 0; c < PIECES; ++c) {
        float kf[VEC];
        load_vec<VEC>(kf, k_s + lane * LDK + c * VEC);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4* qp =
              reinterpret_cast<const float4*>(q_s + r * HDK + c * VEC);
#pragma unroll
          for (int e4 = 0; e4 < VEC / 4; ++e4) {
            const float4 qv = qp[e4];
            s[r] = fmaf(qv.x, kf[4 * e4], s[r]);
            s[r] = fmaf(qv.y, kf[4 * e4 + 1], s[r]);
            s[r] = fmaf(qv.z, kf[4 * e4 + 2], s[r]);
            s[r] = fmaf(qv.w, kf[4 * e4 + 3], s[r]);
          }
        }
      }
      // Mask, online softmax (log2 units); l is this lane's partial sum.
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float x = key < rl[r] ? s[r] : -INFINITY;
        const float m_new = fmaxf(m[r], warp_max(x));
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f(m[r] - base);
        const float p = exp2f(x - base);
        l[r] = l[r] * corr + p;
        m[r] = m_new;
        p_s[r * KW + lane] = p;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[r][d] *= corr;
      }
      __syncwarp();
      // O += P v: lane owns dims lane * DPL ... + DPL - 1.
      if (owns_dims) {
#pragma unroll 2
        for (int j4 = 0; j4 < KW; j4 += 4) {
          float vf[4][DPL];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            load_vec<DPL>(vf[jj], v_s + (j4 + jj) * LDV + lane * DPL);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float4 p4 =
                *reinterpret_cast<const float4*>(p_s + r * KW + j4);
            const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int d = 0; d < DPL; ++d)
                acc[r][d] = fmaf(pj[jj], vf[jj][d], acc[r][d]);
          }
        }
      }
      __syncwarp();                             // slot and P are free
    }
    cp_async_wait<0>();
#pragma unroll
    for (int r = 0; r < RT; ++r) l[r] = warp_sum(l[r]);
    __syncthreads();                            // every ring is drained
    if (owns_dims) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int d = 0; d < DPL; ++d)
          c_acc[(warp * RT + r) * HDV + lane * DPL + d] = acc[r][d];
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        c_m[warp * RT + r] = m[r];
        c_l[warp * RT + r] = l[r];
      }
    }
  }
  __syncthreads();
  for (int r = warp; r < nrows; r += W) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < W; ++w) M = fmaxf(M, c_m[w * RT + r]);
    float cw[W], L = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float mw = c_m[w * RT + r];
      cw[w] = mw == -INFINITY ? 0.f : exp2f(mw - M);
      L += cw[w] * c_l[w * RT + r];
    }
    const int2 ph = out_row(r);
    const long long orow =
        (static_cast<long long>(b) * a.Sq + ph.x) * a.H + ph.y;
    for (int d = lane; d < HDV; d += 32) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w)
        if (cw[w] != 0.f) o = fmaf(cw[w], c_acc[(w * RT + r) * HDV + d], o);
      if (a.splits == 1) {
        const float denom = L > 1e-20f ? L : 1e-20f;
        static_cast<T*>(a.out)[b * a.sob + ph.x * a.sos + ph.y * a.soh + d] =
            from_f32<T>(o / denom);
      } else {
        a.ws[(split * NR + orow) * HDV + d] = o;
      }
    }
    if (a.splits > 1 && lane == 0) {
      float* ml = a.ws + NR * a.splits * HDV + (split * NR + orow) * 2;
      ml[0] = M;
      ml[1] = L;
    } else if (a.lse != nullptr && lane == 0) {
      store_lse(a, b, ph.y, ph.x, M, L);
    }
  }
}

// out = sum_i 2^(m_i - m) acc_i / sum_i 2^(m_i - m) l_i over the splits;
// one warp per output row (b, position, head) of HD (v's head dim) values;
// 0 where no split saw a key.
// Lane i reads split i's (m, l) (32 splits a pass); the partial sums are
// read for every split, independent loads, and an empty split's (which
// were never written) are selected away, not multiplied.
template <typename T, int HD>
__global__ void __launch_bounds__(128) flash_combine_kernel(const Args a) {
  const long long NR = static_cast<long long>(a.B) * a.Sq * a.H;
  const long long orow =
      static_cast<long long>(blockIdx.x) * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (orow >= NR) return;
  const int head = static_cast<int>(orow % a.H);
  const int pos = static_cast<int>((orow / a.H) % a.Sq);
  const int b = static_cast<int>(orow / (static_cast<long long>(a.H) * a.Sq));
  const float* ml = a.ws + NR * a.splits * HD;
  float M = -INFINITY;
  for (int s = lane; s < a.splits; s += 32)
    M = fmaxf(M, ml[(s * NR + orow) * 2]);
  M = warp_max(M);
  constexpr int DPL = (HD + 31) / 32;
  float o[DPL], L = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i) o[i] = 0.f;
  for (int s0 = 0; s0 < a.splits; s0 += 32) {
    const int s = s0 + lane;
    float w = 0.f;
    if (s < a.splits) {
      const float ms = ml[(s * NR + orow) * 2];
      w = ms == -INFINITY ? 0.f : exp2f(ms - M);
      L = fmaf(w, ml[(s * NR + orow) * 2 + 1], L);
    }
    const int n = min(32, a.splits - s0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      const float* acc = a.ws + ((s0 + j) * NR + orow) * HD;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        const float x = d < HD ? acc[d] : 0.f;
        o[i] = wj != 0.f ? fmaf(wj, x, o[i]) : o[i];
      }
    }
  }
  L = warp_sum(L);
  if (a.lse != nullptr && lane == 0) store_lse(a, b, head, pos, M, L);
  const float denom = L > 1e-20f ? L : 1e-20f;
  T* dst = static_cast<T*>(a.out) + b * a.sob + pos * a.sos + head * a.soh;
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    if (lane + 32 * i < HD) dst[lane + 32 * i] = from_f32<T>(o[i] / denom);
}

// --------------------------------------- 2. TMA + wgmma prefill (bf16)

constexpr int WG_BM = 128;               // rows per q tile: two warpgroups
constexpr int WG_BN = 128;               // keys per K/V tile
constexpr int WG_CONSUMERS = 2;
constexpr int WG_THREADS = (WG_CONSUMERS + 1) * 128;
constexpr int WG_BOX = 128 * 128;        // 128 rows x 64 bf16 (128 bytes)

// Shared memory for q/k head dim HDK and v head dim HDV: a row of q or K
// is HDK / 64 boxes of 64 columns, a row of V HDV / 64.
template <int HDK, int HDV>
struct WgCfg {
  static constexpr int BOXES_K = HDK / 64;                // per q or K row
  static constexpr int BOXES_V = HDV / 64;                // per V row
  static constexpr int Q_BYTES = BOXES_K * WG_BOX;        // 32 KB at hd 128
  static constexpr int K_BYTES = BOXES_K * WG_BOX;        // K tile
  static constexpr int V_BYTES = BOXES_V * WG_BOX;        // V tile
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int STAGES = HDK == 64 ? 4 : 2;
  static constexpr int SMEM_BYTES =
      1024 + Q_BYTES + STAGES * STAGE_BYTES + 8 * (1 + 2 * STAGES);
  static_assert(SMEM_BYTES <= 232448, "above a block's shared memory");
};

template <int HDV>
__device__ __forceinline__ void wgmma_pv(float (&o)[HDV / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HDV == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n64(o, a, db);
}

// 1-D grid: block x -> (batch row, KV head, q tile); each (batch row, KV
// head) runs its q tiles in reverse position order.  Row r of the tile is
// (position p0 + r / G, head hkv * G + r % G), r < QT * G with
// QT = 128 / G; rows at or past QT * G (G not dividing 128) are idle.
template <int HDK, int HDV, bool CAUSAL>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const Args a,
                   int n_qt) {
  using C = WgCfg<HDK, HDV>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];

  const int G = a.G, QT = WG_BM / G;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);
  const int hkv = static_cast<int>((blockIdx.x / n_qt) % a.Hkv);
  const int b = static_cast<int>(blockIdx.x / (static_cast<unsigned>(n_qt) * a.Hkv));
  const int p0 = qt * QT;
  const int q_rows = min(QT, a.Sq - p0);       // valid positions here
  const long long qoff = a.qoff(b), lim = a.limit(b);
  long long kv_end = lim, full_end = lim;      // full_end: no row masks below
  if (CAUSAL) {
    const long long last = p0 + q_rows - 1 + qoff + 1;
    const long long first = p0 + qoff + 1;
    kv_end = last < kv_end ? last : kv_end;
    full_end = first < full_end ? first : full_end;
  }
  const int n_tiles =
      kv_end <= 0 ? 0 : static_cast<int>((kv_end + WG_BN - 1) / WG_BN);
  const int t_full = full_end <= 0 ? 0 : static_cast<int>(full_end / WG_BN);
  auto* og = static_cast<__nv_bfloat16*>(a.out);

  if (n_tiles == 0) {   // no row has a valid key: zeros, no loads
    const int CH = a.hd_out / 8;
    const uint4 z = make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < q_rows * G * CH; i += WG_THREADS) {
      const int r = i / CH, c = i % CH;
      const int pos = p0 + r / G, h = hkv * G + r % G;
      *reinterpret_cast<uint4*>(og + b * a.sob + pos * a.sos + h * a.soh +
                                c * 8) = z;
      if (a.lse != nullptr && c == 0)
        a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + pos] = INFINITY;
    }
    return;
  }

  unsigned char* tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t q_u = smem_u32(tiles);
  const uint32_t ring_u = q_u + C::Q_BYTES;
  const uint32_t q_bar = ring_u + STAGES * C::STAGE_BYTES;
  const uint32_t full0 = q_bar + 8;                 // STAGES x 8 B
  const uint32_t empty0 = full0 + STAGES * 8;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, WG_CONSUMERS * 4);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == WG_CONSUMERS) {
    // ---- producer: one thread loads q once and keeps the K/V ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == WG_CONSUMERS * 128) {
      mbar_expect_tx(q_bar, static_cast<uint32_t>(C::BOXES_K * QT * G * 128));
#pragma unroll
      for (int x = 0; x < C::BOXES_K; ++x)
        tma_load_4d(q_u + x * WG_BOX, &map_q, q_bar, x * 64, hkv * G, p0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = full0 + 8 * stage;
        const uint32_t k_u = ring_u + stage * C::STAGE_BYTES;
        mbar_expect_tx(full, C::STAGE_BYTES);
#pragma unroll
        for (int x = 0; x < C::BOXES_K; ++x)
          tma_load_4d(k_u + x * WG_BOX, &map_k, full, x * 64, hkv, t * WG_BN, b);
#pragma unroll
        for (int x = 0; x < C::BOXES_V; ++x)
          tma_load_4d(k_u + C::K_BYTES + x * WG_BOX, &map_v, full, x * 64,
                      hkv, t * WG_BN, b);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // ---- consumers: 64 rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, gid = lane / 4, tq = lane % 4;
    const int rbase = wg * 64 + (threadIdx.x / 32 % 4) * 16 + gid;
    // This thread's two rows rbase and rbase + 8: keys below row_lim.
    long long row_lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long pos = p0 + (rbase + 8 * i) / G + qoff;
      row_lim[i] = CAUSAL && pos + 1 < lim ? pos + 1 : lim;
    }
    const bool active = wg * 64 < q_rows * G;     // a valid row in this wg
    float o[HDV / 2];
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(q_bar, 0);
    const uint32_t qa = q_u + wg * 64 * 128;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_tiles; ++t) {
      mbar_wait(full0 + 8 * stage, phase);
      if (active) {
        const uint32_t k_u = ring_u + stage * C::STAGE_BYTES;
        const uint32_t v_u = k_u + C::K_BYTES;
        // S = q K^T: 64 rows x 128 keys, fp32, HDK / 16 k-steps.
        float s[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) s[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDK / 16; ++kk) {
          const uint32_t off = (kk / 4) * WG_BOX + (kk % 4) * 32;
          wgmma_ss_n128(s, desc_sw128(qa + off, 16, 1024),
                        desc_sw128(k_u + off, 16, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        // Scale, mask (only tiles that cross a row's limit), and the online
        // softmax in log2 units.  Value 4 j + e sits at row rbase + 8 (e / 2),
        // key n0 + 8 j + 2 tq + e % 2.
        const int n0 = t * WG_BN;
        float mx[2] = {-INFINITY, -INFINITY};
        if (t >= t_full) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const long long key = n0 + 8 * j + 2 * tq + (e & 1);
              const float v = key < row_lim[e >> 1]
                                  ? s[4 * j + e] * a.scale_log2 : -INFINITY;
              s[4 * j + e] = v;
              mx[e >> 1] = fmaxf(mx[e >> 1], v);
            }
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = s[4 * j + e] * a.scale_log2;
              s[4 * j + e] = v;
              mx[e >> 1] = fmaxf(mx[e >> 1], v);
            }
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
          for (int j = 0; j < HDV / 8; ++j) {
            o[4 * j + 2 * i] *= corr;
            o[4 * j + 2 * i + 1] *= corr;
          }
        }
        // P in bf16, repacked into the A fragments of eight k16 slices:
        // slice kk holds keys 16 kk .. 16 kk + 15, i.e. columns 2 kk and
        // 2 kk + 1 of the accumulator's n8 groups.
        uint32_t pa[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          float p[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            p[e] = exp2f(s[8 * kk + e] - base[(e >> 1) & 1]);
            l[(e >> 1) & 1] += p[e];
          }
          pa[kk][0] = pack_bf16(p[0], p[1]);
          pa[kk][1] = pack_bf16(p[2], p[3]);
          pa[kk][2] = pack_bf16(p[4], p[5]);
          pa[kk][3] = pack_bf16(p[6], p[7]);
        }
        // O += P V: V's 16-key slices, N-major through the transpose bit.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_pv<HDV>(o, pa[kk], desc_sw128(v_u + kk * 2048, WG_BOX, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }

    // out = O / l, written once in bf16.  Every lane takes part in the
    // shuffles before any lane skips its row.
    const float lsum[2] = {quad_sum(l[0]), quad_sum(l[1])};
    if (active) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rbase + 8 * i;
        const int pos = p0 + r / G, h = hkv * G + r % G;
        if (r >= QT * G || pos >= a.Sq) continue;
        const float denom = lsum[i] > 1e-20f ? lsum[i] : 1e-20f;
        __nv_bfloat16* dst = og + b * a.sob + pos * a.sos + h * a.soh + 2 * tq;
#pragma unroll
        for (int j = 0; j < HDV / 8; ++j)
          if (8 * j < a.hd_out)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                __floats2bfloat162_rn(o[4 * j + 2 * i] / denom,
                                      o[4 * j + 2 * i + 1] / denom);
        // m is in log2 units of the scaled scores, l = sum 2^(s - m).
        if (a.lse != nullptr && tq == 0)
          a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + pos] =
              lsum[i] > 0.f ? (m[i] + log2f(lsum[i])) * 0.6931471805599453f
                            : INFINITY;
      }
    }
  }
}

// The tensor maps have the operands' true head dims (hd, hd_v); a row of
// fewer columns than the tile's HDK (HDV) whole boxes is zero-filled past
// them by TMA, and only hd_v output columns are written.
template <int HDK, int HDV>
int launch_wgmma(bool causal, const Args& a, cudaStream_t s, int hd = HDK,
                 int hd_v = HDV) {
  const int QT = WG_BM / a.G;
  CUtensorMap mq, mk, mv;
  int err = make_map_4d(&mq, a.q, hd, a.H, a.Sq, a.B, a.sqh, a.sqs, a.sqb,
                        a.G, QT);
  if (!err)
    err = make_map_4d(&mk, a.k, hd, a.Hkv, a.Sk, a.B, a.skh, a.sks, a.skb,
                      1, WG_BN);
  if (!err)
    err = make_map_4d(&mv, a.v, hd_v, a.Hkv, a.Sk, a.B, a.svh, a.svs, a.svb,
                      1, WG_BN);
  if (err) return err;
  auto kernel = causal ? flash_wgmma_kernel<HDK, HDV, true>
                       : flash_wgmma_kernel<HDK, HDV, false>;
  const int smem = WgCfg<HDK, HDV>::SMEM_BYTES;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_qt = (a.Sq + QT - 1) / QT;
  const long long blocks = static_cast<long long>(n_qt) * a.Hkv * a.B;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), WG_THREADS, smem, s>>>(mq, mk, mv,
                                                                 a, n_qt);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- launch

cudaError_t set_smem(const void* kernel, int bytes) {
  // Above 48 KB, dynamic shared memory must be opted into (per device).
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int HDK, int HDV, int RT>
cudaError_t launch_split_rt(const Args& a, cudaStream_t s) {
  using C = SplitCfg<T, HDK, HDV, RT>;
  auto kernel = flash_split_kernel<T, HDK, HDV, RT>;
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel),
                             C::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.splits, a.Hkv * a.n_rt, a.B);
  kernel<<<grid, C::THREADS, C::SMEM_BYTES, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long rows = static_cast<long long>(a.B) * a.Sq * a.H;
  flash_combine_kernel<T, HDV>
      <<<static_cast<unsigned>((rows + 3) / 4), 128, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int HDK, int HDV = HDK>
cudaError_t launch_split(const Args& a, int row_tile, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) return launch_split_rt<T, HDK, HDV, 16>(a, s);
  else
    return row_tile == 4 ? launch_split_rt<T, HDK, HDV, 4>(a, s)
                         : launch_split_rt<T, HDK, HDV, 16>(a, s);
}

// Kernels 3 and 4: one block per (64-row q tile, KV head, batch row).
template <typename Kernel>
cudaError_t launch_tile(Kernel kernel, int smem, const Args& a,
                        cudaStream_t s) {
  const cudaError_t attr =
      set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (attr != cudaSuccess) return attr;
  const int qt = BM / a.G;
  const dim3 grid((a.Sq + qt - 1) / qt, a.Hkv, a.B);
  kernel<<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int HDK, int HDV = HDK>
cudaError_t launch_f32(bool causal, const Args& a, cudaStream_t s) {
  const bool lse = a.lse != nullptr;
  const auto kernel =
      causal ? (lse ? flash_fwd_f32_kernel<HDK, HDV, true, true>
                    : flash_fwd_f32_kernel<HDK, HDV, true, false>)
             : (lse ? flash_fwd_f32_kernel<HDK, HDV, false, true>
                    : flash_fwd_f32_kernel<HDK, HDV, false, false>);
  // Two blocks of 99 KB an SM (hd 128) need the largest shared carveout.
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return launch_tile(kernel, F32Tile<HDK, HDV>::SMEM_BYTES, a, s);
}

}  // namespace

// Plain C entry point, bound with ctypes.
//   (hd, hd_v): the head dims of q and k, and of v and out: (16, 16),
//   (64, 64), (80, 80), (128, 128), or (192, 128) (MLA prefill).
//   kernel: 0 TMA + wgmma prefill (bf16, (64, 64), (80, 80), (128, 128),
//   (192, 128)), 1 split-KV (bf16 at every pair but (80, 80), fp32 at
//   (16, 16), (64, 64), (128, 128); splits, keys_per_split, row_tile 16
//   (fp32: 4 or 16) and, for splits > 1, a workspace of splits * B * Sq *
//   H * (hd_v + 2) floats), 2 mma.sync prefill (bf16, (16, 16)), 3 fp32
//   prefill (every pair).
//   dtype: 0 fp32, 1 bf16 (q, k, v and out alike).  Strides are in
//   elements (batch, sequence, head of q, k, v and out; the head dim is
//   unit-stride, and for bf16 the caller checks that bases and strides are
//   16-byte aligned).  q_off / kv_len: device int64 vectors read at
//   b * stride, or null for the constant beside them.  lse: null, or for
//   the prefill kernels (0, 2, 3) a (B, H, Sq) fp32 buffer that receives
//   each row's logsumexp (natural log) of its scaled scores.  Launches on
//   `stream`, does not synchronise, and returns the launch's CUDA error
//   code (0 = launched; 1000 and up: a tensor map could not be made).
extern "C" int flash_attention_launch(
    int kernel, int dtype, int hd, int hd_v, const void* q, const void* k,
    const void* v, void* out, int B, int Sq, int Sk, int H, int Hkv,
    int causal, long long sqb, long long sqs, long long sqh, long long skb,
    long long sks, long long skh, long long svb, long long svs, long long svh,
    long long sob, long long sos, long long soh, const void* q_off,
    int q_off_stride, long long q_off_const, const void* kv_len,
    int kv_len_stride, long long kv_len_const, float scale, int splits,
    int keys_per_split, int row_tile, void* workspace, void* lse,
    void* stream) {
  const int inval = static_cast<int>(cudaErrorInvalidValue);
  const bool mla = hd == 192 && hd_v == 128;
  if (B < 1 || Sq < 1 || Hkv < 1 || H % Hkv || (dtype != 0 && dtype != 1) ||
      !(mla || (hd == hd_v && (hd == 16 || hd == 64 || hd == 80 ||
                               hd == 128))))
    return inval;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.Hkv = Hkv;
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
  a.causal = causal != 0;
  a.splits = 1;
  a.keys_per_split = 0;
  a.n_rt = 1;
  a.ws = static_cast<float*>(workspace);
  a.lse = static_cast<float*>(lse);
  a.hd_out = hd_v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == 1, c = a.causal;
  cudaError_t err = cudaErrorInvalidValue;
  switch (kernel) {
    case 0:   // TMA + wgmma prefill
      if (!bf16 || hd == 16 || a.G > WG_BM || B > 65535 || Hkv > 65535)
        return inval;
      if (mla) return launch_wgmma<192, 128>(c, a, s);
      // hd 80: two 64-column boxes a row, zero-filled past column 80.
      if (hd == 80) return launch_wgmma<128, 128>(c, a, s, 80, 80);
      return hd == 128 ? launch_wgmma<128, 128>(c, a, s)
                       : launch_wgmma<64, 64>(c, a, s);
    case 1: {  // split-KV
      if (hd == 80 || (mla && !bf16)) return inval;
      if (splits < 1 || keys_per_split < 1 ||
          (row_tile != 16 && (bf16 || row_tile != 4)) ||
          static_cast<long long>(splits - 1) * keys_per_split >= (Sk > 0 ? Sk : 1) ||
          (splits > 1 && workspace == nullptr))
        return inval;
      a.splits = splits;
      a.keys_per_split = keys_per_split;
      a.n_rt = static_cast<int>((static_cast<long long>(Sq) * a.G + row_tile - 1) /
                                row_tile);
      if (static_cast<long long>(a.n_rt) * Hkv > 65535 || B > 65535)
        return inval;
      if (mla) {
        err = launch_split<__nv_bfloat16, 192, 128>(a, row_tile, s);
      } else if (bf16) {
        switch (hd) {
          case 16: err = launch_split<__nv_bfloat16, 16>(a, row_tile, s); break;
          case 64: err = launch_split<__nv_bfloat16, 64>(a, row_tile, s); break;
          default: err = launch_split<__nv_bfloat16, 128>(a, row_tile, s);
        }
      } else {
        switch (hd) {
          case 16: err = launch_split<float, 16>(a, row_tile, s); break;
          case 64: err = launch_split<float, 64>(a, row_tile, s); break;
          default: err = launch_split<float, 128>(a, row_tile, s);
        }
      }
      return static_cast<int>(err);
    }
    case 2:   // mma.sync prefill, hd 16
      if (!bf16 || hd != 16 || a.G > BM || B > 65535 || Hkv > 65535)
        return inval;
      err = launch_tile(
          c ? (a.lse ? flash_fwd_kernel<16, true, true>
                     : flash_fwd_kernel<16, true, false>)
            : (a.lse ? flash_fwd_kernel<16, false, true>
                     : flash_fwd_kernel<16, false, false>),
          Bf16Tile<16>::SMEM_BYTES, a, s);
      return static_cast<int>(err);
    case 3:   // fp32 prefill
      if (bf16 || a.G > BM || B > 65535 || Hkv > 65535) return inval;
      if (mla) {
        err = launch_f32<192, 128>(c, a, s);
      } else {
        switch (hd) {
          case 16: err = launch_f32<16>(c, a, s); break;
          case 64: err = launch_f32<64>(c, a, s); break;
          case 80: err = launch_f32<80>(c, a, s); break;
          default: err = launch_f32<128>(c, a, s);
        }
      }
      return static_cast<int>(err);
    default:
      return inval;
  }
}
