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
//    index.  Each lane sorts its 4 (or 8) words once, in registers (an
//    odd-even merge network).  A round is one group max of the lanes' heads, and
//    the lane that held the winner drops its head: no rescan of a lane's
//    experts.  For a whole warp the max is two redux.sync (the largest key,
//    then the lowest index among the heads that hold it); for a sub-warp
//    group, log2 G 64-bit xor shuffles (redux.sync under a mask of part of
//    a warp measured slower).  Sub-warp groups of 8 lanes holding 16
//    experts each at E 128 (16 lanes at E 256) measured slower: their sort
//    of 16 words and shuffle rounds make a longer chain (PERF.md).
// 2. Lane r < k of the group keeps round r's id; its weight (the unbiased
//    score) is read after the rounds from the row's scores, which the group
//    put in shared memory.  The scores are stored as soon as they are
//    computed, so their writes drain under the sort and the rounds; the
//    group writes the row's k ids and k weights with one store instruction
//    each, after the rounds.
// 3. The histogram: the group's lanes add their selections into a
//    block-shared histogram; each block adds its nonzero bins into one
//    int32 accumulator of E words in a scratch buffer (`red.global.add`,
//    at most E reductions a block; one a selection, issued as the rounds
//    end, measured 1.9x slower at GLM-4.5-Air's prefill shape: the hot
//    experts' words serialise), then takes a ticket with one atomic add
//    (release: the block's reductions are performed before its ticket;
//    acquire: the last block then reads the sums).  The block that
//    draws the last ticket reads the accumulator and clears it in one
//    atomic exchange a word, writes `counts` and resets the ticket, so it
//    reads E words and not one partial a block (the first design summed
//    128 partials of E words there, about 2 us at DeepSeek-V3's prefill
//    shape, PERF.md).  Integer sums: the counts are the same on every run.
//    `counts` is written, not accumulated, so the caller need not zero it.
//    The grid is capped at MAX_BLOCKS (rows past MAX_BLOCKS * 32 are walked
//    by the same blocks); a one-block grid (decode) writes `counts` from
//    shared memory directly.  A block takes its ticket before it stores
//    its last rows, so the release does not wait on those stores.
// 4. Rack-limited routing (DeepSeek-V3's node-limited routing, repro/moe/
//    gating.py:112-139, `_rack_limited_top_k`): with num_racks NR,
//    rack_limit M < NR and group top-k gk (clamped to the rack), rack g
//    owns the contiguous experts [g E / NR, (g + 1) E / NR).  Each rack is
//    scored by the sum of its gk largest selection keys (scores + bias),
//    added in descending order as the plain version adds them, the M best
//    racks are kept (ties to the lower rack index, as lax.top_k), and
//    every other rack's experts take no part in the k rounds.  In rack
//    mode a lane's keys are PER contiguous experts (lane r: experts r PER ..
//    r PER + PER - 1), taken from the row's scores in shared memory after
//    the coalesced load (a lane reading its own 32 bytes from device memory
//    cost 2.2 us more at DeepSeek-V3's prefill shape: half-used sectors on
//    every load and store), so a rack is a run of whole lanes or a part of
//    one.  Every geometry the reference routes takes one of two paths:
//    (a) lanes: a rack is L = E / (NR PER) aligned lanes, L a power of two,
//        and gk <= PER (DeepSeek-V3: 4 lanes of 8 experts at NR 8, 16 at
//        NR 2); the list width (2, or PER past a gk of 2) is a template
//        parameter, so each kernel holds one merge.  The lane's packed words are sorted for the rounds anyway,
//        so its first gk hold its top gk keys in order; log2 L xor-shuffle
//        rounds merge the rack's lists (the max of one list against the
//        other reversed, then a bitonic cleanup of the next power of two
//        >= gk), after which every lane of the rack holds the rack's top gk
//        and sums them in order.  Each lane then reads the NR rack scores
//        (one shuffle each, from the racks' first lanes) and counts those
//        above its own rack's (the larger order bits, or the same and the
//        lower rack): a rack is live when fewer than M are.  A dead lane
//        clears its head, so it wins no round.  12 shuffles a row at
//        DeepSeek-V3's NR 8, against 40 in the first design, which held a
//        rack's chunks on 8 lanes of two chunk columns and merged sorted
//        lists of 4.
//    (b) shared: every other geometry (racks of 1-3 experts, racks that
//        straddle lanes, as DeepSeek-V2's 20 experts a rack over lanes of
//        8, gk > PER, L not a power of two).  The row's key order bits go
//        to shared memory (E words a row, dynamic); each lane ranks each of
//        its keys within its rack (the keys above it, or equal and of a
//        lower expert) and writes the key to slot (rack, rank) when the
//        rank is below gk; lane r sums the slots of racks r, r + G, ... in
//        order, ranks the rack words the same way, and the lanes read back
//        their racks' live flags.  E / NR compares a key: slower, and not
//        on any path the port's models take by default.
//    The wrapper sends M == NR (or no limit) to the free kernel: the mask
//    is then all-true and the selection the free one, bit for bit.
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
constexpr int MAX_BLOCKS = 256;     // grid cap
constexpr int SCRATCH_HEAD = 4;     // int32 words before the accumulator: [0] the ticket
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

// Sorts p[0 .. N) (N 4 or 8) into descending order with the fewest
// compare-exchanges: Batcher's odd-even merge networks of 5 and 19 (a
// bitonic network takes 6 and 24; the words are distinct, so any network
// gives the same order).
template <int N>
__device__ __forceinline__ void sort_desc(unsigned long long (&p)[N]) {
  static_assert(N == 4 || N == 8, "4 or 8 words a lane");
  if constexpr (N == 4) {
    cas(p[0], p[1], true); cas(p[2], p[3], true);
    cas(p[0], p[2], true); cas(p[1], p[3], true);
    cas(p[1], p[2], true);
  } else {
    cas(p[0], p[1], true); cas(p[2], p[3], true);
    cas(p[4], p[5], true); cas(p[6], p[7], true);
    cas(p[0], p[2], true); cas(p[1], p[3], true);
    cas(p[4], p[6], true); cas(p[5], p[7], true);
    cas(p[1], p[2], true); cas(p[5], p[6], true);
    cas(p[0], p[4], true); cas(p[1], p[5], true);
    cas(p[2], p[6], true); cas(p[3], p[7], true);
    cas(p[2], p[4], true); cas(p[3], p[5], true);
    cas(p[1], p[2], true); cas(p[3], p[4], true);
    cas(p[5], p[6], true);
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

// Sorts a bitonic t[0 .. N) into descending order (the half-cleaners of
// strides N / 2, .., 1).
template <int N>
__device__ __forceinline__ void bitonic_merge(float (&t)[N]) {
#pragma unroll
  for (int J = N / 2; J > 0; J >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i)
      if ((i & J) == 0) cas_desc(t[i], t[i | J]);
}

// Rounds ROUND .. k - 1 of the selection: the group's largest word among
// its lanes' heads (lane ROUND keeps its expert); the lane that held it
// drops its head.  After round i a lane can win at most MAX_K - 1 - i more
// rounds, so it keeps only that many words (half the moves of a full
// shift at PER 8).
template <int ROUND, int G, int PER>
__device__ __forceinline__ void select_rounds(unsigned gmask, unsigned long long (&p)[PER],
                                              int r, int k, long long& my_id) {
  if constexpr (ROUND < MAX_K) {
    if (ROUND < k) {
      const unsigned long long g = group_max<G>(gmask, p[0]);
      if (r == ROUND) my_id = static_cast<int>(~static_cast<unsigned>(g));
      if (p[0] == g) {
        constexpr int keep = PER < MAX_K - 1 - ROUND ? PER : MAX_K - 1 - ROUND;
#pragma unroll
        for (int i = 0; i < keep; ++i) p[i] = i + 1 < PER ? p[i + 1] : 0ull;
      }
      select_rounds<ROUND + 1, G, PER>(gmask, p, r, k, my_id);
    }
  }
}

// Rack mode, path (a): whether this lane's rack is among the M best.  p:
// the lane's packed words sorted descending (PER keys of one rack); a rack
// is L aligned lanes; GKP the power of two >= gk.  See the header, item 4.
template <int GKP, int G, int PER>
__device__ __forceinline__ bool rack_live_lanes(unsigned gmask,
                                                const unsigned long long (&p)[PER],
                                                int r, int L, int nracks, int M,
                                                int gk) {
  float t[GKP];                               // the lane's top gk, then -inf
#pragma unroll
  for (int q = 0; q < GKP; ++q)
    t[q] = q < gk ? from_order_bits(static_cast<unsigned>(p[q] >> 32)) : -INFINITY;
  for (int o = 1; o < L; o <<= 1) {           // merge the rack's lanes
    float u[GKP];
#pragma unroll
    for (int q = 0; q < GKP; ++q) u[q] = __shfl_xor_sync(gmask, t[q], o, G);
#pragma unroll
    for (int q = 0; q < GKP; ++q) t[q] = fmaxf(t[q], u[GKP - 1 - q]);   // bitonic: the top GKP
    bitonic_merge<GKP>(t);
  }
  float sum = t[0];
#pragma unroll
  for (int q = 1; q < GKP; ++q)
    if (q < gk) sum += t[q];
  const unsigned mine = order_bits(sum);
  const int rack = r / L;
  int above = 0;
  for (int g = 0; g < nracks; ++g) {          // the racks' first lanes
    const unsigned w = __shfl_sync(gmask, mine, g * L, G);
    above += (w > mine) | ((w == mine) & (g < rack));
  }
  return rack < nracks && above < M;
}

// Rack mode, path (b): the live bits of this lane's keys (bit q: expert
// r PER + q), through `buf`, the row's E words of shared memory.  See the
// header, item 4.
template <int G, int PER>
__device__ __forceinline__ unsigned rack_live_shared(unsigned gmask, const float (&key)[PER],
                                                     int r, int E, int epg, int nracks,
                                                     int M, int gk, unsigned* buf) {
  unsigned ob[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    ob[q] = order_bits(key[q]);
    if (r * PER + q < E) buf[r * PER + q] = ob[q];
  }
  __syncwarp(gmask);
  int rank[PER];                              // within the rack
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = r * PER + q;
    rank[q] = gk;
    if (e < E) {
      const int base = e / epg * epg;
      int n = 0;
      for (int j = base; j < base + epg; ++j) {
        const unsigned w = buf[j];
        n += (w > ob[q]) | ((w == ob[q]) & (j < e));
      }
      rank[q] = n;
    }
  }
  __syncwarp(gmask);
  float* slot = reinterpret_cast<float*>(buf);   // (rack, rank < gk)
#pragma unroll
  for (int q = 0; q < PER; ++q)
    if (rank[q] < gk) slot[(r * PER + q) / epg * gk + rank[q]] = key[q];
  __syncwarp(gmask);
  unsigned rw[PER];                           // racks r, r + G, ...
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int g = r + G * i;
    rw[i] = 0u;
    if (g < nracks) {
      float s = slot[g * gk];
      for (int q = 1; q < gk; ++q) s += slot[g * gk + q];
      rw[i] = order_bits(s);
    }
  }
  __syncwarp(gmask);
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (r + G * i < nracks) buf[r + G * i] = rw[i];
  __syncwarp(gmask);
  bool lv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int g = r + G * i;
    int above = 0;
    if (g < nracks)
      for (int h = 0; h < nracks; ++h) {
        const unsigned w = buf[h];
        above += (w > rw[i]) | ((w == rw[i]) & (h < g));
      }
    lv[i] = above < M;
  }
  __syncwarp(gmask);
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (r + G * i < nracks) buf[r + G * i] = lv[i];
  __syncwarp(gmask);
  unsigned live = 0;
#pragma unroll
  for (int q = 0; q < PER; ++q)
    if (r * PER + q < E && buf[(r * PER + q) / epg]) live |= 1u << q;
  return live;
}

// MODE 0: free routing; MODE 1 and 2: rack mode, paths (a) and (b), GKP the
// power of two >= the group top-k on path (a).  Every mode reads the logits
// and writes the scores with chunk c of the row on lane c % G, column c / G
// (whole 128-byte lines a warp); in rack mode a lane then takes its PER
// contiguous scores back from the row's copy in shared memory.
template <int G, int PER, int SCORE_FN, int MODE, int GKP>   // SCORE_FN 0 softmax, 1 sigmoid
__global__ void __launch_bounds__(G * MAX_ROWS)
gating_topk_kernel(const float* __restrict__ logits, long long srow,
                   const float* __restrict__ bias, int64_t* __restrict__ ids,
                   float* __restrict__ weights, long long* __restrict__ counts,
                   float* __restrict__ scores, int* __restrict__ scratch, int T,
                   int E, int k, int L, int epg, int nracks, int M, int gk) {
  constexpr int CH = PER / 4;                 // 16-byte chunks a lane holds
  // The pass's scores (the rack mode's keys and the weights).
  __shared__ float4 rows[MAX_ROWS][G * CH];
  __shared__ int hist[MAX_E];
  __shared__ int last;
  extern __shared__ unsigned rack_buf[];      // path (b): E words a row

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int r = tid % G;                      // lane within the row's group
  const int grp = tid / G;                    // the group's row in the pass
  const unsigned gmask = G == 32 ? FULL : ((1u << G) - 1) << ((tid % 32) & ~(G - 1));
  // Chunk j of this lane's keys: its 16-byte index in the row.
  auto chunk = [&](int j) { return MODE == 0 ? r + G * j : r * CH + j; };
  for (int e = tid; e < E; e += nthreads) hist[e] = 0;

  const bool vec_in = ((reinterpret_cast<uintptr_t>(logits) | (srow * 4)) & 15) == 0;
  const bool vec_out = ((reinterpret_cast<uintptr_t>(scores) | (E * 4)) & 15) == 0;
  float b[PER];                               // the bias of this lane's keys
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const float4 v = bias != nullptr
        ? load4(bias, 4 * chunk(j), E,
                (reinterpret_cast<uintptr_t>(bias) & 15) == 0, 0.f)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    b[4 * j] = v.x; b[4 * j + 1] = v.y; b[4 * j + 2] = v.z; b[4 * j + 3] = v.w;
  }
  __syncthreads();

  long long my_id = 0;                        // round r's selection (r < k)
  float my_w = 0.f;
  int t = 0;
  bool pending = false;                       // a row whose ids are unwritten
  auto store_row = [&]() {
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
    float s[PER];                             // the scores of chunks r, r + G, ..
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
    if (scores != nullptr) {                  // written now, under the rounds
      float* out = scores + static_cast<long long>(t) * E;
#pragma unroll
      for (int j = 0; j < CH; ++j)
        store4(out, 4 * (r + G * j), E, vec_out, s[4 * j], s[4 * j + 1],
               s[4 * j + 2], s[4 * j + 3]);
    }
#pragma unroll
    for (int j = 0; j < CH; ++j)
      rows[grp][r + G * j] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2],
                                         s[4 * j + 3]);
    if constexpr (MODE != 0) {                // this lane's contiguous scores
      __syncwarp(gmask);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float4 v = rows[grp][chunk(j)];
        s[4 * j] = v.x; s[4 * j + 1] = v.y; s[4 * j + 2] = v.z; s[4 * j + 3] = v.w;
      }
    }
    // Packed selection words, sorted.  Experts past E take part as -inf:
    // never selected, since k <= E and every real key is finite.  So do a
    // dead rack's experts under rack-limited routing (k <= M E / NR).
    float key[PER];
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = 4 * chunk(j) + q;
        key[4 * j + q] = e < E ? s[4 * j + q] + b[4 * j + q] : -INFINITY;
      }
    if constexpr (MODE == 2) {
      const unsigned live = rack_live_shared<G, PER>(gmask, key, r, E, epg, nracks, M, gk,
                                                     rack_buf + grp * E);
#pragma unroll
      for (int q = 0; q < PER; ++q)
        if (!((live >> q) & 1u)) key[q] = -INFINITY;
    }
    unsigned long long p[PER];
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) p[4 * j + q] = pack(key[4 * j + q], 4 * chunk(j) + q);
    sort_desc<PER>(p);
    if constexpr (MODE == 1) {
      if (!rack_live_lanes<GKP, G, PER>(gmask, p, r, L, nracks, M, gk))
        p[0] = 0ull;                          // below every key: wins no round
    }
    select_rounds<0, G, PER>(gmask, p, r, k, my_id);
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
  int* acc = scratch + SCRATCH_HEAD;          // E words, zero between launches
  for (int e = tid; e < E; e += nthreads)
    if (hist[e] != 0) atomicAdd(acc + e, hist[e]);   // red.global.add
  __syncthreads();
  if (tid == 0) last = take_ticket(reinterpret_cast<unsigned*>(scratch)) == gridDim.x - 1;
  __syncthreads();
  if (pending) store_row();
  if (!last) return;
  // The last block: every block's reductions are performed; read and
  // clear the accumulator.
  for (int e = tid; e < E; e += nthreads) counts[e] = atomicExch(acc + e, 0);
  if (tid == 0) scratch[0] = 0;               // the next launch's ticket
}

template <int G, int PER, int SCORE_FN, int MODE, int GKP>
int launch_m(int rows, int blocks, cudaStream_t s, const float* x, long long srow,
             const float* bs, int64_t* i64, float* w, long long* c, float* sc,
             int* scratch, int T, int E, int k, int L, int epg, int nracks, int M,
             int gk) {
  const size_t dyn = MODE == 2 ? static_cast<size_t>(rows) * E * sizeof(unsigned) : 0;
  if (MODE == 2) {                            // path (b)'s rows of E words, set once
    static const cudaError_t set = cudaFuncSetAttribute(
        gating_topk_kernel<G, PER, SCORE_FN, MODE, GKP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(MAX_ROWS * MAX_E * sizeof(unsigned)));
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  gating_topk_kernel<G, PER, SCORE_FN, MODE, GKP><<<blocks, G * rows, dyn, s>>>(
      x, srow, bs, i64, w, c, sc, scratch, T, E, k, L, epg, nracks, M, gk);
  return static_cast<int>(cudaGetLastError());
}

// The kernels of one lane geometry: free, path (a) with GKP 2 (gk <= 2) or
// PER (gk <= PER), path (b).
template <int G, int PER>
int launch_g(int score_fn, int mode, int rows, int blocks, cudaStream_t s, const float* x,
             long long srow, const float* bs, int64_t* i64, float* w, long long* c,
             float* sc, int* scratch, int T, int E, int k, int L, int epg, int nracks,
             int M, int gk) {
  const int gkp = mode == 1 && gk > 2 ? PER : (mode == 1 ? 2 : 1);
#define GATING_MODE(SF, MD, GKP)                                                            \
  if (score_fn == SF && mode == MD && gkp == GKP)                                           \
    return launch_m<G, PER, SF, MD, GKP>(rows, blocks, s, x, srow, bs, i64, w, c, sc,      \
                                         scratch, T, E, k, L, epg, nracks, M, gk);
  GATING_MODE(0, 0, 1) GATING_MODE(0, 1, 2) GATING_MODE(0, 1, PER) GATING_MODE(0, 2, 1)
  GATING_MODE(1, 0, 1) GATING_MODE(1, 1, 2) GATING_MODE(1, 1, PER) GATING_MODE(1, 2, 1)
#undef GATING_MODE
  return static_cast<int>(cudaErrorInvalidValue);
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

// The scratch: a 16-byte head (word 0: the ticket), then the accumulator
// of the blocks' histograms (E int32 words).
constexpr int SCRATCH_INTS = SCRATCH_HEAD + MAX_E;

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

// The rack-limited routing's path: 0 free routing (one rack, no limit, or
// a limit that does not bind), 1 path (a) (lanes; *lanes_a_rack set), 2
// path (b) (shared), -1 a geometry the reference does not route either (NR
// not dividing E, gk < 1, k > M E / NR).  E and k within the free kernel's
// limits are the caller's check.
extern "C" int gating_topk_rack_mode(int E, int k, int num_racks, int rack_limit, int gk,
                                     int* lanes_a_rack) {
  *lanes_a_rack = 0;
  if (num_racks <= 1 || rack_limit <= 0 || rack_limit >= num_racks) return 0;
  if (E % num_racks != 0 || gk < 1) return -1;
  const int epg = E / num_racks;
  if (k > rack_limit * epg) return -1;
  const int per = E <= 128 ? 4 : 8;
  const int egk = gk < epg ? gk : epg;
  const int L = epg / per;
  if (epg % per == 0 && (L & (L - 1)) == 0 && egk <= per) {
    *lanes_a_rack = L;
    return 1;
  }
  return 2;
}

// `scratch`: SCRATCH_INTS int32 words, 16-byte aligned, zero before the
// first launch (every launch leaves it zero again).  num_racks 1 (or
// rack_limit 0 or >= num_racks) is free routing.
extern "C" int gating_topk_launch(int score_fn, const void* logits, const void* bias,
                                  void* ids, void* weights, void* counts, void* scores,
                                  void* scratch, int T, int E, int k, long long srow,
                                  int num_racks, int rack_limit, int gk, void* stream) {
  int L = 0;
  const int mode = gating_topk_rack_mode(E, k, num_racks, rack_limit, gk, &L);
  if (E < 1 || E > MAX_E || k < 1 || k > MAX_K || k > E || T < 0 || mode < 0 ||
      (score_fn != 0 && score_fn != 1) ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int epg = mode > 0 ? E / num_racks : 0;
  const int egk = mode > 0 ? (gk < epg ? gk : epg) : 0;    // gk clamped to the rack
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
      return launch_g<G, PER>(score_fn, mode, p.rows, p.blocks, s, x, srow, bs, i64, w, c, \
                              sc, scr, T, E, k, L, epg, num_racks, rack_limit, egk);
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
