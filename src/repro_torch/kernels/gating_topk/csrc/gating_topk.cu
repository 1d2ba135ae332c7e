// Fused router top-k for Hopper (sm_90a): scores, selection and histogram.
//
// Replaces the Pallas kernel repro/kernels/gating_topk/kernel.py:
//   gating_topk_pallas -> for each token row t of logits (T, E) fp32:
//       scores[t]  = softmax(logits[t]) or sigmoid(logits[t])
//       k rounds of: a = argmax(s) (the lowest index among equal
//       maxima, as lax.top_k and argmax), ids[t, i] = a,
//       weights[t, i] = s[a], s[a] = -inf
//       counts[e] = number of rows that selected e
// with ids int64 (the port's id dtype), weights fp32, counts int64 and,
// when the caller passes a buffer, the scores (T, E) fp32.  With an
// aux-free selection bias (E,) (DeepSeek), the rounds select on
// scores + bias while the weights stay the unbiased scores, as
// repro/moe/gating.py:gate does.
//
// What bounds it on an H100 SXM (3.35 TB/s): by the data sheet, bytes: at
// the GLM-4.5-Air and Qwen3-235B-A22B prefill shape (T 4096, E 128, k 8)
// it reads 2.1 MB of logits and writes 0.4 MB of ids and weights and 2.1
// MB of scores, 1.37 us.  On the card the work is too small for that
// bound to be reached: a graph node costs ~1.3 us before any work, and
// each row is a chain of dependent steps (max, exp, sum, sort, k rounds),
// so the time is the chain of one pass, the instructions of 32 rows on an
// SM, and the cross-block histogram after the last row.  The design keeps
// the logits read once, into registers, the scores, the selection and the
// histogram on the chip, each output written once, and shortens the chain.
//
// Design.  What held the first kernel of this port back: k rounds of a
// 5-level warp butterfly moving three values (15 dependent shuffles a
// round), lane 0 writing every id and weight, a global atomic per expert
// and block into counts that the wrapper zeroed first, and a whole warp
// even for 16 experts.  This one:
// 1. A row belongs to a group of G lanes (G a power of two with a lane for
//    each 16-byte chunk of the row, two chunks past E 128, and for each of
//    the k selections: 32 at E 128 and 256, 4 at Jamba's E 16, so a warp
//    serves 32 / G rows).  Lane r holds the chunks r, r + G of the row
//    (experts 4c .. 4c + 3 of chunk c), read with one 16-byte load each,
//    so a warp's load reads whole 128-byte lines; experts past E are
//    masked.  The softmax's max and sum reduce over the group: for a whole
//    warp the max is one redux.sync over the fp32 values' order-preserving
//    bits; the sum, and a sub-warp group's max, take log2 G xor shuffles.
//    Each expert's selection word is 64 bits: the order-preserving bits of
//    the fp32 key (-0.0 made +0.0 first, as the plain version's stable
//    sort treats them as equal) above the complement of the expert index,
//    so the larger word is the larger key or, among equal keys, the lower
//    index.  Each lane sorts its 4 (or 8) words once, in registers (a
//    bitonic network).  A round is one group max of the lanes' heads, and
//    the lane that held the winner drops its head: no rescan of a lane's
//    experts.  For a whole warp the max is two redux.sync (the largest key,
//    then the lowest index among the heads that hold it); for a sub-warp
//    group, log2 G 64-bit xor shuffles (redux.sync under a mask of part of
//    a warp measured slower).  Sub-warp groups of 8 lanes holding 16
//    experts each at E 128 (16 lanes at E 256) measured slower: their sort
//    of 16 words and shuffle rounds make a longer chain (PERF.md).
// 2. Lane r < k of the group keeps round r's id; its weight (the unbiased
//    score) is read after the rounds from the row's scores, which the group
//    put in shared memory.  The group writes the row's k ids and k weights
//    with one store instruction each, after the rounds.
// 3. The histogram: the group's lanes add their selections into a
//    block-shared histogram; each block writes its partial (int32, E
//    words) to a scratch buffer, with no atomics on global memory, then
//    takes a ticket with one atomic add (release: the block's partial is
//    visible before its ticket; acquire: the last block then reads every
//    partial).  The block that draws the last ticket sums the partials
//    (int4 columns spread over its threads, eight loads in flight each,
//    then a fixed order through shared memory) into `counts` and resets
//    the ticket.  Integer sums: the counts are the same on every run.
//    `counts` is written, not accumulated, so the caller need not zero it.
//    The grid is capped at MAX_BLOCKS (rows past MAX_BLOCKS * 32 are walked
//    by the same blocks), which fixes the scratch's size; a one-block grid
//    (decode) writes `counts` from shared memory directly.  A block takes
//    its ticket before it stores its last rows, so the release does not
//    wait on those stores.
// 4. Rack-limited routing (DeepSeek-V3's node-limited routing, repro/moe/
//    gating.py:112-139, `_rack_limited_top_k`): with num_racks G, rack_limit
//    M < G and group top-k gk, rack g owns the contiguous experts [g E / G,
//    (g + 1) E / G).  Each rack is scored by the sum of its gk largest
//    selection keys (scores + bias), the M best racks are kept (ties to the
//    lower rack index, as lax.top_k), and every other rack's experts take
//    part in the k rounds as -inf.  The keys are already in registers, and
//    a rack is W = E / (4 G) whole 16-byte chunks, which the lane layout
//    puts on W aligned lanes of one chunk column (chunk c is on lane c % G
//    lanes, column c / G lanes): at E 256 and G 8 a rack is 8 chunks on 8
//    lanes.  So a lane sorts its chunk's 4 keys, and log2 W xor-shuffle
//    rounds merge the sorted top-4 lists of the rack's lanes (the max of
//    one list against the other reversed, then a 4-wide bitonic cleanup),
//    after which every lane of the rack holds the rack's top 4 and sums its
//    first gk in descending order, as the plain version does.  The racks'
//    packed (score, complement of the rack index) words are then shuffled
//    to every lane of the row, which counts the words above its own: a
//    rack is live when fewer than M are.  No second pass over global
//    memory.  The wrapper takes W a power of two and gk <= 4, and sends M
//    == G to the free kernel (the mask is then all-true and the selection
//    the free one, bit for bit).
// The entry point derives the launch geometry from (T, E, k) (`plan`) and
// `gating_topk_plan` reports it and the scratch's size, so the wrapper
// keeps no copy of these constants.
// CUDA C++ rather than Triton: the port's kernels are CUDA C++ for sm_90a,
// bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_E = 256;
constexpr int MAX_K = 8;
constexpr int MAX_ROWS = 32;        // token rows per block and pass
constexpr int MAX_BLOCKS = 256;     // grid cap; the scratch holds this many partials
constexpr int SCRATCH_HEAD = 4;     // int32 words before the partials: [0] the ticket
constexpr unsigned FULL = 0xffffffffu;

// fp32 bits whose unsigned order is the float order, -0.0 equal to +0.0.
__device__ __forceinline__ unsigned order_bits(float f) {
  const unsigned u = __float_as_uint(f == 0.f ? 0.f : f);
  return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned b) {
  return __uint_as_float(b & 0x80000000u ? b ^ 0x80000000u : ~b);
}

__device__ __forceinline__ unsigned long long pack(float key, int e) {
  return (static_cast<unsigned long long>(order_bits(key)) << 32) |
         static_cast<unsigned>(~e);
}

// The ticket: an atomic add with release semantics for the partials the
// block wrote before its barrier, and acquire semantics for the partials
// the last block then reads (after its barrier), at device scope.
__device__ __forceinline__ unsigned take_ticket(unsigned* ticket) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
               : "=r"(old) : "l"(ticket) : "memory");
  return old;
}

// The max over a group of G lanes (mask `gmask`).  A whole warp reduces
// with redux.sync: a 64-bit word as the max of its high halves, then the
// max low half among the lanes that hold it.  A sub-warp group uses xor
// shuffles.
template <int G>
__device__ __forceinline__ float group_max(unsigned gmask, float v) {
  if constexpr (G == 32) {
    return from_order_bits(__reduce_max_sync(gmask, order_bits(v)));
  } else {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(gmask, v, o));
    return v;
  }
}

template <int G>
__device__ __forceinline__ unsigned long long group_max(unsigned gmask,
                                                        unsigned long long v) {
  if constexpr (G == 32) {
    const unsigned hi = static_cast<unsigned>(v >> 32);
    const unsigned mh = __reduce_max_sync(gmask, hi);
    const unsigned ml = __reduce_max_sync(gmask, hi == mh ? static_cast<unsigned>(v) : 0u);
    return (static_cast<unsigned long long>(mh) << 32) | ml;
  } else {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      const unsigned long long w = __shfl_xor_sync(gmask, v, o);
      v = w > v ? w : v;
    }
    return v;
  }
}

// Compare-exchange: after it, a >= b when `desc`, a <= b otherwise.
__device__ __forceinline__ void cas(unsigned long long& a, unsigned long long& b,
                                    bool desc) {
  const bool swap = desc ? a < b : a > b;
  const unsigned long long x = swap ? b : a, y = swap ? a : b;
  a = x;
  b = y;
}

// Bitonic sort of p[0 .. N) into descending order, N a power of two: the
// stages K = 2, 4, .., N of steps J = K / 2, .., 1, unrolled by recursion so
// every index is a constant and p stays in registers.
template <int N, int K, int J>
__device__ __forceinline__ void bitonic(unsigned long long (&p)[N]) {
  if constexpr (K <= N) {
    if constexpr (J > 0) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        if ((i ^ J) > i) cas(p[i], p[i ^ J], (i & K) == 0);
      bitonic<N, K, J / 2>(p);
    } else {
      bitonic<N, 2 * K, K>(p);
    }
  }
}

// Experts e0 .. e0 + 3 of a row: one 16-byte load where the chunk lies
// inside E and the row is aligned, else element loads; `pad` past E.
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int e0, int E,
                                        bool vec, float pad) {
  if (vec && e0 + 3 < E) return __ldg(reinterpret_cast<const float4*>(row + e0));
  float4 v;
  v.x = e0 < E ? __ldg(row + e0) : pad;
  v.y = e0 + 1 < E ? __ldg(row + e0 + 1) : pad;
  v.z = e0 + 2 < E ? __ldg(row + e0 + 2) : pad;
  v.w = e0 + 3 < E ? __ldg(row + e0 + 3) : pad;
  return v;
}

__device__ __forceinline__ void store4(float* __restrict__ row, int e0, int E, bool vec,
                                       float a, float b, float c, float d) {
  if (vec && e0 + 3 < E) {
    *reinterpret_cast<float4*>(row + e0) = make_float4(a, b, c, d);
    return;
  }
  if (e0 < E) row[e0] = a;
  if (e0 + 1 < E) row[e0 + 1] = b;
  if (e0 + 2 < E) row[e0 + 2] = c;
  if (e0 + 3 < E) row[e0 + 3] = d;
}

// Compare-exchange of floats: after it, a >= b.
__device__ __forceinline__ void cas_desc(float& a, float& b) {
  const float x = fmaxf(a, b), y = fminf(a, b);
  a = x;
  b = y;
}

// The rack-limited routing's live mask of this lane's chunks (bit j: the
// rack of chunk column j is among the M best); see the header, item 4.
template <int G, int PER>
__device__ __forceinline__ unsigned rack_live(unsigned gmask, const float (&key)[PER], int r,
                                              int W, int M, int gk) {
  constexpr int CH = PER / 4;
  unsigned long long word[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    float t[4] = {key[4 * j], key[4 * j + 1], key[4 * j + 2], key[4 * j + 3]};
    cas_desc(t[0], t[1]);                     // sort 4, descending
    cas_desc(t[2], t[3]);
    cas_desc(t[0], t[2]);
    cas_desc(t[1], t[3]);
    cas_desc(t[1], t[2]);
    for (int o = 1; o < W; o <<= 1) {         // merge the rack's lanes
      float u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) u[q] = __shfl_xor_sync(gmask, t[q], o, G);
#pragma unroll
      for (int q = 0; q < 4; ++q) t[q] = fmaxf(t[q], u[3 - q]);   // bitonic: the top 4
      cas_desc(t[0], t[2]);
      cas_desc(t[1], t[3]);
      cas_desc(t[0], t[1]);
      cas_desc(t[2], t[3]);
    }
    float sum = t[0];
#pragma unroll
    for (int q = 1; q < 4; ++q)
      if (q < gk) sum += t[q];
    word[j] = pack(sum, (r + G * j) / W);     // rack index of chunk r + G j
  }
  int above[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) above[j] = 0;
#pragma unroll
  for (int jj = 0; jj < CH; ++jj)
    for (int src = 0; src < G; src += W) {    // one lane of every rack
      const unsigned long long w = __shfl_sync(gmask, word[jj], src, G);
#pragma unroll
      for (int j = 0; j < CH; ++j) above[j] += w > word[j];
    }
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < CH; ++j) live |= (above[j] < M ? 1u : 0u) << j;
  return live;
}

template <int G, int PER, int SCORE_FN, bool RACK>   // SCORE_FN 0 softmax, 1 sigmoid
__global__ void __launch_bounds__(G * MAX_ROWS)
gating_topk_kernel(const float* __restrict__ logits, long long srow,
                   const float* __restrict__ bias, int64_t* __restrict__ ids,
                   float* __restrict__ weights, long long* __restrict__ counts,
                   float* __restrict__ scores, int* __restrict__ scratch, int T,
                   int E, int k, int W, int M, int gk) {
  constexpr int CH = PER / 4;                 // 16-byte chunks a lane holds
  // The pass's scores (for the weights); the last block's sums after that.
  __shared__ float4 rows[MAX_ROWS][G * CH];
  __shared__ int hist[MAX_E];
  __shared__ int last;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int r = tid % G;                      // lane within the row's group
  const int grp = tid / G;                    // the group's row in the pass
  const unsigned gmask = G == 32 ? FULL : ((1u << G) - 1) << ((tid % 32) & ~(G - 1));
  for (int e = tid; e < E; e += nthreads) hist[e] = 0;

  const bool vec_in = ((reinterpret_cast<uintptr_t>(logits) | (srow * 4)) & 15) == 0;
  const bool vec_out = ((reinterpret_cast<uintptr_t>(scores) | (E * 4)) & 15) == 0;
  float b[PER];                               // the bias of this lane's experts
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const float4 v = bias != nullptr
        ? load4(bias, 4 * (r + G * j), E,
                (reinterpret_cast<uintptr_t>(bias) & 15) == 0, 0.f)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    b[4 * j] = v.x; b[4 * j + 1] = v.y; b[4 * j + 2] = v.z; b[4 * j + 3] = v.w;
  }
  __syncthreads();

  float s[PER];                               // this lane's scores of the row
  long long my_id = 0;                        // round r's selection (r < k)
  float my_w = 0.f;
  int t = 0;
  bool pending = false;                       // a row whose outputs are unwritten
  auto store_row = [&]() {
    if (scores != nullptr) {
      float* out = scores + static_cast<long long>(t) * E;
#pragma unroll
      for (int j = 0; j < CH; ++j)
        store4(out, 4 * (r + G * j), E, vec_out, s[4 * j], s[4 * j + 1],
               s[4 * j + 2], s[4 * j + 3]);
    }
    if (r < k) {                              // one store instruction each
      ids[static_cast<long long>(t) * k + r] = my_id;
      weights[static_cast<long long>(t) * k + r] = my_w;
    }
  };

  const int R = nthreads / G;                 // rows a pass
  for (int row0 = blockIdx.x * R; row0 < T; row0 += gridDim.x * R) {
    if (pending) store_row();                 // an earlier pass's row
    pending = false;
    t = row0 + grp;
    if (t >= T) continue;                     // the whole group, so no waits
    const float* x = logits + static_cast<long long>(t) * srow;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const float4 v = load4(x, 4 * (r + G * j), E, vec_in, -INFINITY);
      s[4 * j] = v.x; s[4 * j + 1] = v.y; s[4 * j + 2] = v.z; s[4 * j + 3] = v.w;
    }
    if (SCORE_FN == 0) {
      float m = s[0];
#pragma unroll
      for (int i = 1; i < PER; ++i) m = fmaxf(m, s[i]);
      m = group_max<G>(gmask, m);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        s[i] = expf(s[i] - m);                // 0 past E (-inf)
        sum += s[i];
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(gmask, sum, o);
      const float inv = 1.f / sum;
#pragma unroll
      for (int i = 0; i < PER; ++i) s[i] *= inv;
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) s[i] = 1.f / (1.f + expf(-s[i]));   // 0 past E
    }
    __syncwarp(gmask);                        // the last pass's reads are done
#pragma unroll
    for (int j = 0; j < CH; ++j)
      rows[grp][r + G * j] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2],
                                         s[4 * j + 3]);
    // Packed selection words, sorted.  Experts past E take part as -inf:
    // never selected, since k <= E and every real key is finite.  So do a
    // dead rack's experts under rack-limited routing (k <= M E / G).
    float key[PER];
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = 4 * (r + G * j) + q;
        key[4 * j + q] = e < E ? s[4 * j + q] + b[4 * j + q] : -INFINITY;
      }
    unsigned live = ~0u;
    if constexpr (RACK) live = rack_live<G, PER>(gmask, key, r, W, M, gk);
    unsigned long long p[PER];
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        p[4 * j + q] = pack((live >> j) & 1u ? key[4 * j + q] : -INFINITY,
                            4 * (r + G * j) + q);
    bitonic<PER, 2, 1>(p);
    // k rounds: the group's largest word among its lanes' heads; the lane
    // that held it drops its head.
    for (int round = 0; round < k; ++round) {
      const unsigned long long g = group_max<G>(gmask, p[0]);
      if (r == round) my_id = static_cast<int>(~static_cast<unsigned>(g));
      if (p[0] == g) {
#pragma unroll
        for (int i = 0; i + 1 < PER; ++i) p[i] = p[i + 1];
        p[PER - 1] = 0ull;
      }
    }
    __syncwarp(gmask);
    if (r < k) {
      my_w = reinterpret_cast<const float*>(rows[grp])[my_id];
      atomicAdd(&hist[my_id], 1);
    }
    pending = true;
  }
  __syncthreads();

  if (gridDim.x == 1) {                       // the block saw every row
    for (int e = tid; e < E; e += nthreads) counts[e] = hist[e];
    if (pending) store_row();
    return;
  }
  const int Ep = (E + 3) & ~3;                // partial pitch: whole int4s
  int4* parts = reinterpret_cast<int4*>(scratch + SCRATCH_HEAD);
  int* mine = scratch + SCRATCH_HEAD + blockIdx.x * Ep;
  for (int e = tid; e < Ep; e += nthreads) mine[e] = e < E ? hist[e] : 0;
  __syncthreads();
  if (tid == 0) last = take_ticket(reinterpret_cast<unsigned*>(scratch)) == gridDim.x - 1;
  __syncthreads();
  if (pending) store_row();
  if (!last) return;

  // The last block: sum the partials.  Thread i reads int4 column i % ncol
  // of blocks i / ncol, i / ncol + slices, ...; then slice sums in order.
  // A multi-block grid has 32 rows a block, so ncol <= 2 G <= nthreads.
  const int nb = gridDim.x;
  const int ncol = Ep / 4;
  const int slices = nthreads / ncol;
  const int col = tid % ncol, sl = tid / ncol;
  int4 acc = make_int4(0, 0, 0, 0);
  if (sl < slices) {
    for (int blk0 = sl; blk0 < nb; blk0 += 8 * slices) {
      int4 v[8];                              // eight loads in flight at once
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int blk = blk0 + u * slices;
        v[u] = blk < nb ? __ldcg(parts + blk * ncol + col) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        acc.x += v[u].x; acc.y += v[u].y; acc.z += v[u].z; acc.w += v[u].w;
      }
    }
  }
  int4* red = reinterpret_cast<int4*>(&rows[0][0]);   // >= nthreads int4s
  red[tid] = acc;                             // the rows were read before the barrier
  __syncthreads();
  const int* sums = reinterpret_cast<const int*>(red);
  for (int e = tid; e < E; e += nthreads) {
    long long c = 0;
    for (int i = 0; i < slices; ++i) c += sums[(i * ncol + e / 4) * 4 + e % 4];
    counts[e] = c;
  }
  if (tid == 0) scratch[0] = 0;               // the next launch's ticket
}

template <int G, int PER, int SCORE_FN>
void launch_r(bool rack, int rows, int blocks, cudaStream_t s, const float* x,
              long long srow, const float* bs, int64_t* i64, float* w, long long* c,
              float* sc, int* scratch, int T, int E, int k, int W, int M, int gk) {
  if (rack)
    gating_topk_kernel<G, PER, SCORE_FN, true><<<blocks, G * rows, 0, s>>>(
        x, srow, bs, i64, w, c, sc, scratch, T, E, k, W, M, gk);
  else
    gating_topk_kernel<G, PER, SCORE_FN, false><<<blocks, G * rows, 0, s>>>(
        x, srow, bs, i64, w, c, sc, scratch, T, E, k, W, M, gk);
}

template <int G, int PER>
int launch_g(int score_fn, int rows, int blocks, cudaStream_t s, const float* x,
             long long srow, const float* bs, int64_t* i64, float* w, long long* c,
             float* sc, int* scratch, int T, int E, int k, int W, int M, int gk) {
  const bool rack = W > 0;
  if (score_fn == 0)
    launch_r<G, PER, 0>(rack, rows, blocks, s, x, srow, bs, i64, w, c, sc, scratch, T, E, k,
                        W, M, gk);
  else
    launch_r<G, PER, 1>(rack, rows, blocks, s, x, srow, bs, i64, w, c, sc, scratch, T, E, k,
                        W, M, gk);
  return static_cast<int>(cudaGetLastError());
}

struct Plan {
  int group, per, rows, blocks;
};

// A lane holds one 16-byte chunk of the row (two past E 128), and G is the
// smallest power of two with a lane for each chunk and for each of the k
// selections: 32 at E 128 and 256, 4 at E 16.  A block takes 32 rows, or
// all T rows (in whole warps) when T is smaller; the grid is capped at
// MAX_BLOCKS.
Plan plan(int T, int E, int k) {
  Plan p;
  p.per = E <= 128 ? 4 : 8;
  const int need = k > (E + p.per - 1) / p.per ? k : (E + p.per - 1) / p.per;
  p.group = 1;
  while (p.group < need) p.group *= 2;
  const int per_warp = 32 / p.group;
  const int whole = (T + per_warp - 1) / per_warp * per_warp;
  p.rows = whole < per_warp ? per_warp : (whole < MAX_ROWS ? whole : MAX_ROWS);
  const int blocks = (T + p.rows - 1) / p.rows;
  p.blocks = blocks < 1 ? 1 : (blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
  return p;
}

// The scratch: a 16-byte head (word 0: the ticket), then one partial
// histogram (E int32 words, padded to whole int4s) per block.
constexpr int SCRATCH_INTS = SCRATCH_HEAD + MAX_BLOCKS * MAX_E;

}  // namespace

// out = {G lanes a row, experts a lane, rows a block, blocks, scratch int32s}.
extern "C" void gating_topk_plan(int T, int E, int k, int* out) {
  const Plan p = plan(T, E, k);
  out[0] = p.group;
  out[1] = p.per;
  out[2] = p.rows;
  out[3] = p.blocks;
  out[4] = SCRATCH_INTS;
}

// The rack-limited routing's chunks a rack (W, a power of two), or 0 when
// (num_racks, rack_limit, gk) is free routing or a geometry the kernel does
// not take (-1): racks of whole 16-byte chunks, gk <= 4, k <= M E / G.
extern "C" int gating_topk_rack_chunks(int E, int k, int num_racks, int rack_limit, int gk) {
  if (num_racks <= 1 || rack_limit <= 0 || rack_limit >= num_racks) return 0;
  if (E % num_racks != 0) return -1;
  const int epg = E / num_racks;
  const int W = epg / 4;
  if (epg % 4 != 0 || (W & (W - 1)) != 0 || gk < 1 || (gk < epg ? gk : epg) > 4 ||
      k > rack_limit * epg)
    return -1;
  return W;
}

// `scratch`: SCRATCH_INTS int32 words, 16-byte aligned, its ticket 0 before
// the first launch (every launch leaves it 0 again).  num_racks 1 (or
// rack_limit 0 or >= num_racks) is free routing.
extern "C" int gating_topk_launch(int score_fn, const void* logits, const void* bias,
                                  void* ids, void* weights, void* counts, void* scores,
                                  void* scratch, int T, int E, int k, long long srow,
                                  int num_racks, int rack_limit, int gk, void* stream) {
  const int W = gating_topk_rack_chunks(E, k, num_racks, rack_limit, gk);
  if (E < 1 || E > MAX_E || k < 1 || k > MAX_K || k > E || T < 0 || W < 0 ||
      (score_fn != 0 && score_fn != 1) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int egk = W > 0 ? (gk < 4 * W ? gk : 4 * W) : 0;   // gk clamped to the rack
  const Plan p = plan(T, E, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(logits);
  const auto* bs = static_cast<const float*>(bias);
  auto* i64 = static_cast<int64_t*>(ids);
  auto* w = static_cast<float*>(weights);
  auto* c = static_cast<long long*>(counts);
  auto* sc = static_cast<float*>(scores);
  auto* scr = static_cast<int*>(scratch);
  switch (p.group * 100 + p.per) {
#define GATING_CASE(G, PER) \
    case G * 100 + PER:     \
      return launch_g<G, PER>(score_fn, p.rows, p.blocks, s, x, srow, bs, i64, w, c, sc, \
                              scr, T, E, k, W, rack_limit, egk);
    GATING_CASE(1, 4)
    GATING_CASE(2, 4)
    GATING_CASE(4, 4)
    GATING_CASE(8, 4)
    GATING_CASE(16, 4)
    GATING_CASE(32, 4)
    GATING_CASE(32, 8)
#undef GATING_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
