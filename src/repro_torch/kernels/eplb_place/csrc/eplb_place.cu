// EPLB's greedy replica placement for Hopper (sm_90a), one launch.
//
// Replaces the JAX package's device-resident EPLB placement, which is no
// Pallas kernel but a lax.while_loop (repro/core/eplb.py:154-174, the body
// :158-171): while replica slots remain and some expert is eligible,
//   e = argmax over eligible experts of lam_e[e] / counts[e] (ties to the
//       lowest id),
//   adm[t] = slots[t] < n_slot and rank t does not host e,
//   est[t] = sum_e hosted[e, t] * lam_e[e] / counts[e]   (f32),
//   t = argmin over admissible ranks of est (ties to the lowest rank),
// and, if some rank is admissible, e has fewer than max_rep instances and a
// positive load per instance, e is replicated onto t; otherwise e is
// retired.  It writes hosted (E, R) bytes (0/1, a torch.bool tensor) and
// optionally (steps, placements).
//
// Parity.  JAX sums est as an f32 matrix-vector product whose order XLA
// does not document.  The kernel sums each rank's hosted experts in
// ascending expert id, in f32 with no fused operations; the terms of the
// experts a rank does not host are exact zeros, so that is the product
// summed by expert id.  The plain version sums in the same order.
//
// What bounds it: latency.  It reads E loads and writes E * R bytes, but
// each step depends on the last one's placement.  A step has two dependent
// chains, which run side by side (the design below):
//   * the argmin: its two redux.sync rounds over the ranks' estimates, then
//     the re-sum of the chosen rank's estimate (REG: RCAP pairs in
//     registers, the new term by a select; otherwise the list of E / R +
//     n_slot pairs from shared memory), which the next argmin reads;
//   * the argmax: the vote on whether e is placed, then its two redux.sync
//     rounds, whose expert the next step's host test and vote read.
// So its least time is the steps times the longer of the two, which
// step_chain_kernel times on the card, one chain at a time.
//
// Design: the loop runs in one warp, with no block barrier inside a step;
// the block's other warps only build the state before it and write hosted
// after it.  A single warp's step costs the latencies of its instructions
// one after another, so the step keeps its state in registers, and its
// two halves are independent:
//   * Lane l owns experts l, l + 32, ... (EPL a lane, 8 at E 256): their
//     argmax keys (the f32 bits of the load per instance + 1, 0 once
//     retired) and counts are in its registers, with its best key and the
//     lowest id that holds it.  It owns ranks l, l + 32, ... (RPL, 2 at R
//     64): their estimates, slots and lists of hosted (expert id, load per
//     instance) pairs in ascending id.  Where every list fits in RCAP (8)
//     pairs (E / R + n_slot <= 8: R 64 at E 128 and 256) and a lane's
//     keys, counts and lists fit in 160 registers (R <= 128, or R 256 at
//     E <= 512) the lists are in registers, padded with empty pairs that
//     sort last and add +0.0; otherwise they are in shared memory.  E <=
//     1024 (32 experts a lane) and R <= 256 (8 ranks a lane).  Shared
//     memory holds the loads and hosted as bits (a word per 32 ranks) for
//     the output.
//   * The argmax is two redux.sync rounds over the lanes' best keys; the
//     argmin two more over the f32 bits of the lanes' admissible ranks'
//     estimates (0xffffffff where a rank is not admissible).  Whether e is
//     placed is known from one vote before the argmin's rounds, so every
//     lane computes e's new load per instance (__fdiv_rn, the reference's
//     division) and key, the owner's key and count change by selects,
//     every lane takes its best again and the next step's argmax runs,
//     beside the argmin: nothing there waits for the chosen rank.
//   * A placement changes e's term in the lists that hold it and puts
//     (e, its new load per instance) into the chosen rank's, at its place.
//     Register lists: e's value replaced by selects in every list, the pair
//     inserted by selects in the owner's, and every estimate summed again
//     (eight adds; the unchanged ones come to the same bits).  Shared
//     lists: the pair inserted by all lanes at once (a ballot gives the
//     place, each lane moves one pair), then only the owners of the ranks
//     that host e re-sum theirs, eight pairs at a time into registers.
//     Either way each estimate is the same adds in the same order as a
//     full recomputation, so the same bits.
//   The register lists matter: with the lists in shared memory, the
//   insert and the re-sums (8.5 ranks hosting e a step on average at
//   E 256, R 64) took 70% of a step in a chain of shared stores, loads and
//   warp barriers.
// Nothing is read back, so a CUDA graph can capture it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // the state's set-up and hosted's output
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;
constexpr int SMALL_SMEM = 48 * 1024;
constexpr int CHUNK = 8;         // list pairs a lane holds at once
constexpr int RCAP = 8;          // pairs of a register list
constexpr int NONE = 0x7fffffff; // a register list's empty id
constexpr int MAX_E = 1024;      // 32 experts a lane
constexpr int MAX_R = 256;       // 8 ranks a lane
constexpr int REG_WORDS = 160;   // a lane's keys, counts and lists at most
constexpr int CHAIN_LIST = 1032; // step_chain_kernel's longest list
constexpr unsigned FULL = 0xffffffffu;

// The kernel's template arguments: experts and ranks a lane, rounded up
// to a power of two.
inline int experts_a_lane(int E) {
  return E <= 32 ? 1 : E <= 64 ? 2 : E <= 128 ? 4 : E <= 256 ? 8
         : E <= 512 ? 16 : 32;
}
inline int ranks_a_lane(int R) {
  return R <= 32 ? 1 : R <= 64 ? 2 : R <= 128 ? 4 : 8;
}

// Whether a lane's keys and counts (2 EPL) and its ranks' register lists
// (2 RCAP RPL) fit in REG_WORDS registers.
__host__ __device__ constexpr bool reg_fits(int EPL, int RPL) {
  return 2 * EPL + 2 * RCAP * RPL <= REG_WORDS;
}

// A rank's list: E / R mains + n_slot replicas, rounded up to whole chunks.
__host__ __device__ inline int list_stride(int E, int R, int n_slot) {
  return (E / R + n_slot + CHUNK - 1) / CHUNK * CHUNK;
}

inline long long smem_words(int E, int R, int n_slot) {
  // loads and homes (E each); hosted bits (E x ranks_a_lane(R)); each
  // rank's list of ids and of values (R x list_stride each) and length.
  return 2LL * E + static_cast<long long>(E) * ranks_a_lane(R) +
         2LL * R * list_stride(E, R, n_slot) + R;
}

// The f32 sum, from zero in list order, of the values of the list of n
// (id, value) pairs at ids / vals, expert e's value first set to v (and
// stored): eight pairs at a time into registers, every select static.
__device__ __forceinline__ float list_resum(const int* ids, float* vals,
                                            int n, int e, float v) {
  float s = 0.0f;
  for (int c = 0; c < n; c += CHUNK) {
    const int4 i0 = *reinterpret_cast<const int4*>(ids + c);
    const int4 i1 = *reinterpret_cast<const int4*>(ids + c + 4);
    float4 v0 = *reinterpret_cast<const float4*>(vals + c);
    float4 v1 = *reinterpret_cast<const float4*>(vals + c + 4);
    v0.x = i0.x == e ? v : v0.x;
    v0.y = i0.y == e ? v : v0.y;
    v0.z = i0.z == e ? v : v0.z;
    v0.w = i0.w == e ? v : v0.w;
    v1.x = i1.x == e ? v : v1.x;
    v1.y = i1.y == e ? v : v1.y;
    v1.z = i1.z == e ? v : v1.z;
    v1.w = i1.w == e ? v : v1.w;
    const float vl[CHUNK] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int k = 0; k < CHUNK; ++k)
      if (c + k < n) s = __fadd_rn(s, vl[k]);
    *reinterpret_cast<float4*>(vals + c) = v0;
    *reinterpret_cast<float4*>(vals + c + 4) = v1;
  }
  return s;
}

// Insert (e, v) into the ascending list of n pairs at ids / vals, all lanes
// of the warp at once: a ballot counts the pairs below e (its place), and
// each lane moves one pair of a 32-pair chunk up by one, the chunks from
// the last down.
__device__ __forceinline__ void list_insert(int* ids, float* vals, int n,
                                            int e, float v, int lane) {
  int pos = 0;
  for (int c = 0; c < n; c += 32)
    pos += __popc(__ballot_sync(FULL, c + lane < n && ids[c + lane] < e));
  for (int c = (n / 32) * 32; c >= 0; c -= 32) {
    const int i = c + lane;   // pair i of the new list
    int id = e;
    float val = v;
    if (i > pos && i <= n) {
      id = ids[i - 1];
      val = vals[i - 1];
    }
    __syncwarp();
    if (i >= pos && i <= n) {
      ids[i] = id;
      vals[i] = val;
    }
  }
}

// (max key, smallest tag among the lanes that hold it), in every lane.
__device__ __forceinline__ void warp_argmax(unsigned key, unsigned tag,
                                            unsigned& out_key,
                                            unsigned& out_tag) {
  out_key = __reduce_max_sync(FULL, key);
  out_tag = __reduce_min_sync(FULL, key == out_key ? tag : FULL);
}

// (min key, smallest tag among the lanes that hold it), in every lane.
__device__ __forceinline__ void warp_argmin(unsigned key, unsigned tag,
                                            unsigned& out_key,
                                            unsigned& out_tag) {
  out_key = __reduce_min_sync(FULL, key);
  out_tag = __reduce_min_sync(FULL, key == out_key ? tag : FULL);
}

// This lane's best expert: the largest of its keys and the lowest id that
// holds it (experts lane + 32 i below E; 0 and 0xffffffff where none).
template <int EPL>
__device__ __forceinline__ void lane_best(const unsigned (&k)[EPL], int E,
                                          int lane, unsigned& key,
                                          unsigned& id) {
  key = 0u;
  id = FULL;
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const bool better = lane + 32 * i < E && (id == FULL || k[i] > key);
    key = better ? k[i] : key;
    id = better ? static_cast<unsigned>(lane + 32 * i) : id;
  }
}

// Register lists (the kernel's REG form, where E / R + n_slot <= RCAP):
// RCAP pairs a rank, ascending id, the empty ones (NONE, +0.0) last, so a
// sum over all RCAP values is the sum over the list (+0.0 adds nothing to
// a sum of non-negative terms) and every index is static.
__device__ __forceinline__ bool reg_hosts(const int (&ids)[RCAP], int e) {
  bool h = false;
#pragma unroll
  for (int k = 0; k < RCAP; ++k) h = h || ids[k] == e;
  return h;
}

__device__ __forceinline__ float reg_sum(const float (&vals)[RCAP]) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < RCAP; ++k) s = __fadd_rn(s, vals[k]);
  return s;
}

// (e, v) into its place (the count of ids below e), later pairs moved up
// by one; the list has room.
__device__ __forceinline__ void reg_insert(int (&ids)[RCAP],
                                           float (&vals)[RCAP], int e,
                                           float v) {
  unsigned below = 0u;
#pragma unroll
  for (int k = 0; k < RCAP; ++k) below |= (ids[k] < e ? 1u : 0u) << k;
  const int p = __popc(below);
#pragma unroll
  for (int k = RCAP - 1; k >= 0; --k) {
    const int up_id = k > 0 ? ids[k - 1] : 0;
    const float up_v = k > 0 ? vals[k - 1] : 0.0f;
    ids[k] = k > p ? up_id : (k == p ? e : ids[k]);
    vals[k] = k > p ? up_v : (k == p ? v : vals[k]);
  }
}

// REG: each lane's lists in registers (no list loads or stores in a step);
// otherwise in shared memory (list_insert, list_resum).
template <int EPL, int RPL, bool REG>
__global__ void __launch_bounds__(THREADS, 1)
eplb_place_kernel(const float* __restrict__ lam_g,
                  const long long* __restrict__ home_g, int E, int R,
                  int n_slot, int max_rep,
                  unsigned char* __restrict__ hosted_out,
                  int* __restrict__ stats) {
  extern __shared__ int smem[];
  const int stride = list_stride(E, R, n_slot);
  int* ids = smem;                                            // R x stride
  float* vals = reinterpret_cast<float*>(ids + R * stride);   // R x stride
  float* lam_s = vals + R * stride;                           // E
  int* home_s = reinterpret_cast<int*>(lam_s + E);            // E
  unsigned* bits = reinterpret_cast<unsigned*>(home_s + E);   // E x RPL
  int* lens = reinterpret_cast<int*>(bits + E * RPL);         // R
  const int tid = threadIdx.x, lane = tid & 31;

  // ---- set-up, the whole block: loads; homes; hosted as the mains' bits;
  // each rank's mains in ascending id (an expert's place: the experts
  // below it with the same home) with their loads per instance.
  for (int e = tid; e < E; e += THREADS) {
    lam_s[e] = lam_g[e];
    home_s[e] = static_cast<int>(home_g[e]);
  }
  for (int i = tid; i < E * RPL; i += THREADS) bits[i] = 0u;
  for (int t = tid; t < R; t += THREADS) lens[t] = 0;
  __syncthreads();
  for (int e = tid; e < E; e += THREADS) {
    const int h = home_s[e];
    int pos = 0;
    for (int i = 0; i < e; ++i) pos += home_s[i] == h ? 1 : 0;
    if (pos < stride) {
      ids[h * stride + pos] = e;
      vals[h * stride + pos] = __fdiv_rn(lam_s[e], 1.0f);
      atomicAdd(&lens[h], 1);
    }
    atomicOr(&bits[e * RPL + (h >> 5)], 1u << (h & 31));
  }
  __syncthreads();

  if (tid < 32) {
    // ---- the loop, one warp.
    unsigned k[EPL];
    int cnt[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int e = lane + 32 * i;
      k[i] = e < E ? __float_as_uint(__fdiv_rn(lam_s[e], 1.0f)) + 1u : 0u;
      cnt[i] = 1;
    }
    float est[RPL];
    int slot[RPL], len[RPL];
    int rid[REG ? RPL : 1][RCAP];
    float rv[REG ? RPL : 1][RCAP];
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
      const int t = lane + 32 * j;
      len[j] = t < R ? lens[t] : 0;
      slot[j] = 0;
      if constexpr (REG) {
#pragma unroll
        for (int c = 0; c < RCAP; ++c) {
          rid[j][c] = c < len[j] ? ids[t * stride + c] : NONE;
          rv[j][c] = c < len[j] ? vals[t * stride + c] : 0.0f;
        }
        est[j] = reg_sum(rv[j]);
      } else {
        est[j] = t < R ? list_resum(ids + t * stride, vals + t * stride,
                                    len[j], -1, 0.0f)
                       : 0.0f;
      }
    }
    unsigned bkey, bid;
    lane_best<EPL>(k, E, lane, bkey, bid);
    int budget = R * n_slot, left = E, steps = 0, placed = 0;
    unsigned ekey, esel;
    warp_argmax(bkey, bid, ekey, esel);
    while (budget > 0 && left > 0) {
      const int e = static_cast<int>(esel), we = e >> 5;
      const bool owner = lane == (e & 31);
      const float lam_e = lam_s[e];
      int cnt_mine = 0;
#pragma unroll
      for (int i = 0; i < EPL; ++i) cnt_mine = i == we ? cnt[i] : cnt_mine;
      const int cnt_e = __shfl_sync(FULL, cnt_mine, e & 31);
      // This lane's ranks: hosting e?  the admissible one with the lowest
      // estimate.
      unsigned host = 0u;
      unsigned rkey = FULL, rtag = FULL;
#pragma unroll
      for (int j = 0; j < RPL; ++j) {
        const int t = lane + 32 * j;
        bool h;
        if constexpr (REG)
          h = reg_hosts(rid[j], e);
        else
          h = (bits[e * RPL + j] >> lane) & 1u;
        host |= (h ? 1u : 0u) << j;
        const bool ok = t < R && !h && slot[j] < n_slot;
        const unsigned kk = ok ? __float_as_uint(est[j]) : FULL;
        const bool lower = kk < rkey;
        rkey = lower ? kk : rkey;
        rtag = lower ? static_cast<unsigned>(t) : rtag;
      }
      const bool feasible =
          __any_sync(FULL, rkey != FULL) && cnt_e < max_rep && ekey > 1u;
      // e's new load per instance and key (0: retired), in every lane; the
      // owner's key and count by selects; every lane's best; the next
      // argmax.
      const float pi_e = __fdiv_rn(lam_e, static_cast<float>(cnt_e + 1));
      const unsigned key_e = feasible ? __float_as_uint(pi_e) + 1u : 0u;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        k[i] = owner && i == we ? key_e : k[i];
        cnt[i] += owner && i == we && feasible ? 1 : 0;
      }
      lane_best<EPL>(k, E, lane, bkey, bid);
      unsigned rmin, tsel;
      warp_argmin(rkey, rtag, rmin, tsel);
      warp_argmax(bkey, bid, ekey, esel);
      ++steps;
      if (feasible) {
        const int t = static_cast<int>(tsel), jt = t >> 5;
        const bool mine_t = (t & 31) == lane;
        if (lane == 0) bits[e * RPL + jt] |= 1u << (t & 31);
        if constexpr (REG) {
          // e's value in every list that holds it; e into t's; every
          // estimate again (the unchanged ones to the same bits).
#pragma unroll
          for (int j = 0; j < RPL; ++j) {
#pragma unroll
            for (int c = 0; c < RCAP; ++c)
              rv[j][c] = rid[j][c] == e ? pi_e : rv[j][c];
            if (j == jt && mine_t) reg_insert(rid[j], rv[j], e, pi_e);
            slot[j] += j == jt && mine_t ? 1 : 0;
            est[j] = reg_sum(rv[j]);
          }
        } else {
          // t's list: its owner's length, e inserted by all lanes.
          int n_mine = 0;
#pragma unroll
          for (int j = 0; j < RPL; ++j) n_mine = j == jt ? len[j] : n_mine;
          const int n = __shfl_sync(FULL, n_mine, t & 31);
          const bool room = n < stride;
          if (room)
            list_insert(ids + t * stride, vals + t * stride, n, e, pi_e,
                        lane);
#pragma unroll
          for (int j = 0; j < RPL; ++j) {
            len[j] += j == jt && mine_t && room ? 1 : 0;
            slot[j] += j == jt && mine_t ? 1 : 0;
          }
          __syncwarp();
          // The ranks of this lane that host e now: their estimates again.
          unsigned stale = host | (mine_t ? 1u << jt : 0u);
          while (stale != 0u) {
            const int jj = __ffs(stale) - 1;
            stale &= stale - 1u;
            const int r = lane + 32 * jj;
            int nr = 0;
#pragma unroll
            for (int j = 0; j < RPL; ++j) nr = j == jj ? len[j] : nr;
            const float sum = list_resum(ids + r * stride, vals + r * stride,
                                         nr, e, pi_e);
#pragma unroll
            for (int j = 0; j < RPL; ++j) est[j] = j == jj ? sum : est[j];
          }
          __syncwarp();
        }
        --budget;
        ++placed;
      } else {
        --left;
      }
    }
    if (lane == 0 && stats != nullptr) {
      stats[0] = steps;
      stats[1] = placed;
    }
  }
  __syncthreads();
  // hosted: four ranks' bytes a 32-bit store where R allows it.
  const int q = R % 4 == 0 ? 4 : 1;
  for (int e = tid >> 5; e < E; e += WARPS)
    for (int t = lane * q; t < R; t += 32 * q) {
      const unsigned b = bits[e * RPL + (t >> 5)] >> (t & 31);
      if (q == 4)
        *reinterpret_cast<unsigned*>(hosted_out + e * R + t) =
            (b & 1u) | (b & 2u) << 7 | (b & 4u) << 14 | (b & 8u) << 21;
      else
        hosted_out[e * R + t] = static_cast<unsigned char>(b & 1u);
    }
}

// The units of the bound: `rounds` dependent copies of one of a step's two
// chains, in one warp, timed by the caller.  PART 0: the argmin's two
// redux.sync rounds, then a register re-sum of RCAP pairs, one of them set
// by a select on the chosen rank (REG); PART 1: the same rounds, then the
// re-sum of a shared list of `len` pairs at the chosen rank's place; PART
// 2: the vote on whether e is placed, then the argmax's two rounds.
template <int PART>
__global__ void __launch_bounds__(32, 1)
step_chain_kernel(int rounds, int len, unsigned* out) {
  __shared__ __align__(16) int ids[4 * CHAIN_LIST];
  __shared__ __align__(16) float vals[4 * CHAIN_LIST];
  const int lane = threadIdx.x;
  for (int i = lane; i < 4 * CHAIN_LIST; i += 32) {
    ids[i] = 2 * (i % CHAIN_LIST);
    vals[i] = 1.0f + (i % CHAIN_LIST);
  }
  __syncwarp();
  int rid[RCAP];
  float rv[RCAP];
#pragma unroll
  for (int c = 0; c < RCAP; ++c) {
    rid[c] = 2 * c;
    rv[c] = 1.0f + c;
  }
  unsigned key = lane, tag = lane;
  for (int r = 0; r < rounds; ++r) {
    unsigned k, t;
    if constexpr (PART == 2) {
      const bool placed = __any_sync(FULL, ((key ^ tag) & 31u) == 5u);
      warp_argmax(placed ? key + lane : lane, tag, k, t);
      key = k ^ lane;
      tag = t ^ lane;
    } else {
      warp_argmin(key + lane, tag, k, t);
      float s;
      if constexpr (PART == 0) {
        const int e = 2 * static_cast<int>(t & 7u);
#pragma unroll
        for (int c = 0; c < RCAP; ++c) rv[c] = rid[c] == e ? 0.5f : rv[c];
        s = reg_sum(rv);
      } else {
        const int l = static_cast<int>(t & 3u) * CHAIN_LIST;
        s = list_resum(ids + l, vals + l, len, 1, 0.5f);
      }
      key = k + __float_as_uint(s);
      tag = t ^ lane;
    }
  }
  if (lane == 0) *out = key + tag;
}

template <int EPL, int RPL>
cudaError_t launch_form(bool reg, const float* lam, const long long* home,
                        int E, int R, int n_slot, int max_rep,
                        unsigned char* hosted, int* stats, size_t smem,
                        cudaStream_t stream) {
  void (*kernel)(const float*, const long long*, int, int, int, int,
                 unsigned char*, int*) = eplb_place_kernel<EPL, RPL, false>;
  if constexpr (reg_fits(EPL, RPL)) {
    if (reg) kernel = eplb_place_kernel<EPL, RPL, true>;
  }
  if (smem > SMALL_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
  }
  kernel<<<1, THREADS, smem, stream>>>(lam, home, E, R, n_slot, max_rep,
                                       hosted, stats);
  return cudaGetLastError();
}

// R <= E, so a lane owns no more ranks than experts: only RPL <= EPL is
// built.
template <int EPL>
cudaError_t launch_epl(int rpl, bool reg, const float* lam,
                       const long long* home, int E, int R, int n_slot,
                       int max_rep, unsigned char* hosted, int* stats,
                       size_t smem, cudaStream_t stream) {
  if (rpl == 1)
    return launch_form<EPL, 1>(reg, lam, home, E, R, n_slot, max_rep,
                               hosted, stats, smem, stream);
  if constexpr (EPL >= 2)
    if (rpl == 2)
      return launch_form<EPL, 2>(reg, lam, home, E, R, n_slot, max_rep,
                                 hosted, stats, smem, stream);
  if constexpr (EPL >= 4)
    if (rpl == 4)
      return launch_form<EPL, 4>(reg, lam, home, E, R, n_slot, max_rep,
                                 hosted, stats, smem, stream);
  if constexpr (EPL >= 8)
    if (rpl == 8)
      return launch_form<EPL, 8>(reg, lam, home, E, R, n_slot, max_rep,
                                 hosted, stats, smem, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
extern "C" long long eplb_place_smem_bytes(int E, int R, int n_slot) {
  return 4 * smem_words(E, R, n_slot);
}

// 1 where the kernel keeps the lists in registers: every rank's (its mains
// and n_slot) fits in RCAP pairs and a lane's state in REG_WORDS.
extern "C" int eplb_place_reg_lists(int E, int R, int n_slot) {
  return E / R + n_slot <= RCAP &&
         reg_fits(experts_a_lane(E), ranks_a_lane(R));
}

// part 0, 1, 2: step_chain_kernel<part>; len: part 1's list length.
extern "C" int eplb_place_step_chain(int rounds, int part, int len, void* out,
                                     void* stream) {
  if (part < 0 || part > 2 || len < 0 || len > CHAIN_LIST)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<unsigned*>(out);
  if (part == 0)
    step_chain_kernel<0><<<1, 32, 0, s>>>(rounds, len, o);
  else if (part == 1)
    step_chain_kernel<1><<<1, 32, 0, s>>>(rounds, len, o);
  else
    step_chain_kernel<2><<<1, 32, 0, s>>>(rounds, len, o);
  return static_cast<int>(cudaGetLastError());
}

// lam (E,) f32 estimated loads (non-negative), home (E,) int64 (each rank
// the home of E / R experts); hosted (E, R) uint8 output; stats (2,) int32
// or null: (steps, placements).  E <= MAX_E, R <= MAX_R.
extern "C" int eplb_place_launch(const void* lam, const void* home, int E,
                                 int R, int n_slot, int max_rep, void* hosted,
                                 void* stats, void* stream) {
  if (R < 1 || E < R || E % R != 0 || n_slot < 0 || max_rep < 1 ||
      E > MAX_E || R > MAX_R)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = eplb_place_smem_bytes(E, R, n_slot);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const int rpl = ranks_a_lane(R);
  const int epl = experts_a_lane(E);
  const bool reg = eplb_place_reg_lists(E, R, n_slot) != 0;
  const auto* l = static_cast<const float*>(lam);
  const auto* h = static_cast<const long long*>(home);
  auto* o = static_cast<unsigned char*>(hosted);
  auto* st = static_cast<int*>(stats);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t b = static_cast<size_t>(smem);
  cudaError_t err;
  if (epl == 1)
    err = launch_epl<1>(rpl, reg, l, h, E, R, n_slot, max_rep, o, st, b, s);
  else if (epl == 2)
    err = launch_epl<2>(rpl, reg, l, h, E, R, n_slot, max_rep, o, st, b, s);
  else if (epl == 4)
    err = launch_epl<4>(rpl, reg, l, h, E, R, n_slot, max_rep, o, st, b, s);
  else if (epl == 8)
    err = launch_epl<8>(rpl, reg, l, h, E, R, n_slot, max_rep, o, st, b, s);
  else if (epl == 16)
    err = launch_epl<16>(rpl, reg, l, h, E, R, n_slot, max_rep, o, st, b,
                         s);
  else
    err = launch_epl<32>(rpl, reg, l, h, E, R, n_slot, max_rep, o, st, b,
                         s);
  return static_cast<int>(err);
}
