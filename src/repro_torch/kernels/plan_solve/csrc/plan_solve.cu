// UltraEP plan solve for Hopper (sm_90a): the threshold search and the
// greedy feasibility oracle of the paper's Alg. 1 in one launch.
//
// Replaces the device-resident solve of the JAX package, which is no Pallas
// kernel but two lax.while_loop in repro/core/planner.py:
//   solve_replication (:349, the search over the threshold tau: bisection,
//   or the k-ary round of :316-343 at probe_parallelism P > 1) around
//   _greedy_oracle (:198, the flat cursor walk over (rank, expert)),
// flat or rack-aware, with or without health weights.  Given lam_e (E,)
// (per-expert load), ell (R,) (per-rank home load), home (E,) and
// rank_experts (R, E/R) (each rank's mains by descending load, stable by
// id), it writes the quota table u (E, R) and the solved tau, both int64,
// and optionally (probes, oracle steps, critical-path steps).  The
// arithmetic is int32, as in JAX (repro/core/planner.py:256-257); the
// wrapper raises where the shapes allow a total load that overflows it.
//
// Rack mode (rack_size L > 0, ranks per rack; repro/core/planner.py:79-198):
// the argmax over candidate hosts t scores
//   bonus_scale * (adm ? slk[t] : -1) + 2 * demand[rack(t), e]
//       + [rack(t) == rack(home e)],
// ties to the lowest rank, with bonus_scale 4 when the (G, E) demand
// incidence is on (lam given: demand[g, e] = sum of lam over rack g's ranks
// > 0) and 2 otherwise.  The kernel computes the incidence from lam itself,
// once, into shared memory, so nothing is read back.
//
// Health mode (w given, (R,) f32 raw weights; repro/core/planner.py:274-287
// and :125-128): the kernel normalises w / max(wmax, 1e-12) (ones where
// wmax is 0), sums the normalised weights in f32 in rank order, starts the
// search at tau_lo = ceil(f32(total) / max(sum w, 1e-12)) and tau_hi =
// max(total, max ell), and caps rank r at floor(f32(tau) * w[r]) in f32, so
// a rank of weight 0 drains.
//
// k-ary probing (P > 1): a round probes the P thresholds
//   tau_j = min(lo + (j + 1) * (hi - lo) / (P + 1), hi - 1),  j < P,
// takes the smallest feasible one as the new hi and the largest infeasible
// one below it, plus one, as the new lo.  P = 1 is the bisection.  Warps
// take the probes in batches of WARPS, in ascending order; a batch that
// holds a feasible probe ends the round, since no later probe can change
// its outcome (every probe before the first feasible one is infeasible and
// below it).  So every P works, at any block size.
//
// What bounds it on an H100: latency.  It reads a few KB and writes E * R
// int64 words, but the oracle is a chain of dependent steps: every step
// reads the cursor's rank and expert, scores every rank, reduces the scores
// across the warp and applies one transfer before the next step can read
// the state.  So its least time is the critical path of serial oracle steps
// (per round, the longest probe of each batch) times one step's latency.
//
// Design:
// 1. One block per solve; every EP rank solves the same plan redundantly
//    (as JAX does), so nothing is exchanged after the load gather.
// 2. A probe's state is compact and lives in shared memory, one region per
//    warp: exc, slk, slots, order (R each), nrep and the home column of u
//    (E each), the replica bits (E x ceil(R / 32) words) and a log of the
//    accepted transfers (at most R * n_slot: each takes a slot).  The full
//    u is not stored: a transfer moves load from u[e, home e] (the only
//    column the oracle reads, its cap) to an off-home u[e, t] that was 0
//    and is written once (hosted[e, t] is then set), so u is the home
//    column plus the log.  A region is ~6 KB at E 256, R 64, so eight
//    probes fit beside each other (a full u per probe would be 64 KB).
// 3. The block resets the batch's regions (caps from each probe's tau) and
//    sorts each region's ranks by excess (stable, descending; a rank's
//    place is a count over the others); then warp j walks probe j's cursor.
//    A step scores the ranks lane by lane (lane l holds ranks l, l + 32,
//    ...: the first maximum among its own), then takes the warp's largest
//    score+1 with one redux.sync and the lowest rank among the lanes that
//    hold it with a second, so ties pick the lowest rank, as jnp.argmax
//    does.  Lane 0 applies the transfer; __syncwarp orders it before the
//    next step's reads.
// 4. The round's winner (the smallest feasible probe) copies its home
//    column and log into the best region.  At the end the block writes u:
//    the home column (lam_e while no probe was feasible), then the log.
// 5. Nothing is read back to the host, so a CUDA graph can capture it.
// CUDA C++ rather than Triton: the port's kernels are CUDA C++ for sm_90a,
// bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;     // 227 KB: an H100 block's dynamic limit
constexpr int SMALL_SMEM = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

struct Layout {
  // Offsets in 4-byte words into the dynamic shared memory.
  int ell, w, lam_e, home, rexp, dem, bcast, best_hl, best_log, region, region_words;
  int rw, log_max;
};

__host__ __device__ inline Layout layout(int E, int R, int L, int demand, int n_slot,
                                         int regions) {
  Layout s;
  s.rw = (R + 31) / 32;
  s.log_max = R * (n_slot > 0 ? n_slot : 0);
  const int dem = (L > 0 && demand) ? (R / L) * E : 0;
  int o = 0;
  s.ell = o; o += R;
  s.w = o; o += R;
  s.lam_e = o; o += E;
  s.home = o; o += E;
  s.rexp = o; o += E;
  s.dem = o; o += dem;
  s.bcast = o; o += 16;
  s.best_hl = o; o += E;
  s.best_log = o; o += 1 + 2 * s.log_max;
  // A region: exc, slk, slots, order (R); nrep, hl (E); bits (E * rw);
  // feasible, steps, log count, then the log (2 words an entry).
  s.region_words = 4 * R + 2 * E + E * s.rw + 3 + 2 * s.log_max;
  s.region = o; o += regions * s.region_words;
  return s;
}

__host__ __device__ inline long long smem_words(int E, int R, int L, int demand, int n_slot,
                                                int regions) {
  const Layout s = layout(E, R, L, demand, n_slot, regions);
  return static_cast<long long>(s.region) + static_cast<long long>(regions) * s.region_words;
}

// The j-th of P probes of the round [lo, hi): lo + (j + 1) * span / (P + 1),
// at most hi - 1 (repro/core/planner.py:320-322), in 64 bits.
__device__ inline int probe_tau(int lo, int hi, int j, int P) {
  const long long off = (static_cast<long long>(j) + 1) * (hi - lo) / (P + 1);
  return static_cast<int>(min(static_cast<long long>(lo) + off, static_cast<long long>(hi) - 1));
}

__device__ inline int cap_of(int tau, float w, bool health) {
  // JAX: floor(tau.astype(f32) * w).astype(int32), one f32 rounding.
  return health ? static_cast<int>(floorf(__fmul_rn(static_cast<float>(tau), w))) : tau;
}

__global__ void __launch_bounds__(THREADS, 1)
plan_solve_kernel(const long long* __restrict__ lam_e_g, const long long* __restrict__ ell_g,
                  const long long* __restrict__ home_g,
                  const long long* __restrict__ rank_experts_g,
                  const long long* __restrict__ lam_g, const float* __restrict__ w_g, int E,
                  int R, int n_slot, int u_min, int max_rep, int L, int P,
                  long long* __restrict__ u_out, long long* __restrict__ tau_out,
                  int* __restrict__ stats, int n_stats) {
  extern __shared__ int smem[];
  const int regions = P < WARPS ? P : WARPS;
  const Layout s = layout(E, R, L, lam_g != nullptr, n_slot, regions);
  int* ell = smem + s.ell;
  float* w = reinterpret_cast<float*>(smem + s.w);
  int* lam_e = smem + s.lam_e;
  int* home = smem + s.home;
  int* rexp = smem + s.rexp;
  int* dem = smem + s.dem;
  int* bcast = smem + s.bcast;   // [0] total, [1] max ell, [2] lo, [3] hi
  int* best_hl = smem + s.best_hl;
  int* best_log = smem + s.best_log;   // [0] count, then (index, delta) pairs
  const bool health = w_g != nullptr;
  const unsigned bonus_scale = lam_g != nullptr ? 4u : 2u;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int epr = E / R;
  const int rw = s.rw;

  for (int i = tid; i < E; i += THREADS) {
    lam_e[i] = static_cast<int>(lam_e_g[i]);
    home[i] = static_cast<int>(home_g[i]);
    rexp[i] = static_cast<int>(rank_experts_g[i]);
    best_hl[i] = lam_e[i];
  }
  for (int r = tid; r < R; r += THREADS) {
    ell[r] = static_cast<int>(ell_g[r]);
    w[r] = health ? w_g[r] : 1.0f;
  }
  if (lam_g != nullptr) {
    for (int i = tid; i < (R / L) * E; i += THREADS) {
      const int g = i / E, e = i - g * E;
      bool any = false;
      for (int l = 0; l < L; ++l) any |= lam_g[static_cast<long long>(g * L + l) * E + e] > 0;
      dem[i] = any;
    }
  }
  if (tid == 0) best_log[0] = 0;
  __syncthreads();
  if (tid == 0) {
    // Sequential, in rank order: the total, the largest home load and, in
    // health mode, the weights' normalisation and f32 sum.
    int total = 0, m = 0;
    for (int r = 0; r < R; ++r) {
      total += ell[r];
      m = max(m, ell[r]);
    }
    int lo, hi;
    if (health) {
      float wmax = w[0];
      for (int r = 1; r < R; ++r) wmax = fmaxf(wmax, w[r]);
      float sum = 0.0f;
      for (int r = 0; r < R; ++r) {
        w[r] = wmax > 0.0f ? __fdiv_rn(w[r], fmaxf(wmax, 1e-12f)) : 1.0f;
        sum = __fadd_rn(sum, w[r]);
      }
      lo = static_cast<int>(ceilf(__fdiv_rn(static_cast<float>(total), fmaxf(sum, 1e-12f))));
      hi = max(total, m);
    } else {
      lo = total / R + (total % R != 0);   // ceil of the mean rank load
      hi = m;
    }
    bcast[0] = total;
    bcast[1] = m;
    bcast[2] = lo;
    bcast[3] = hi;
  }
  __syncthreads();
  int lo = bcast[2], hi = bcast[3];
  int probes = 0, steps = 0, crit = 0;
  const int max_iters = R * (n_slot + epr + 2) + 2;
  while (lo < hi) {
    bool found = false;
    int last_inf = lo - 1;      // tau of the last infeasible probe, if any
    int new_hi = hi;
    for (int b0 = 0; b0 < P && !found; b0 += WARPS) {
      const int nb = min(WARPS, P - b0);
      // Reset the batch's regions.
      for (int j = 0; j < nb; ++j) {
        int* reg = smem + s.region + j * s.region_words;
        const int tau = probe_tau(lo, hi, b0 + j, P);
        int* exc = reg;
        int* slk = exc + R;
        int* slots = slk + R;
        int* nrep = reg + 4 * R;
        int* hl = nrep + E;
        unsigned* bits = reinterpret_cast<unsigned*>(hl + E);
        int* tail = hl + E + E * rw;   // feasible, steps, log count
        for (int r = tid; r < R; r += THREADS) {
          const int cap = cap_of(tau, w[r], health);
          exc[r] = max(ell[r] - cap, 0);
          slk[r] = max(cap - ell[r], 0);
          slots[r] = 0;
        }
        for (int e = tid; e < E; e += THREADS) {
          nrep[e] = 0;
          hl[e] = lam_e[e];
        }
        for (int i = tid; i < E * rw; i += THREADS) bits[i] = 0u;
        if (tid == 0) tail[2] = 0;
      }
      __syncthreads();
      // Stable descending order of each region's excess.
      for (int i = tid; i < nb * R; i += THREADS) {
        const int j = i / R, r = i - j * R;
        int* reg = smem + s.region + j * s.region_words;
        const int x = reg[r];
        int pos = 0;
        for (int q = 0; q < R; ++q) {
          const int y = reg[q];
          pos += (y > x) || (y == x && q < r);
        }
        reg[3 * R + pos] = r;
      }
      __syncthreads();
      if (warp < nb) {
        int* reg = smem + s.region + warp * s.region_words;
        int* exc = reg;
        int* slk = exc + R;
        int* slots = slk + R;
        const int* order = slots + R;
        int* nrep = reg + 4 * R;
        int* hl = nrep + E;
        unsigned* bits = reinterpret_cast<unsigned*>(hl + E);
        int* tail = hl + E + E * rw;
        int* log = tail + 3;
        // The cursor walk; every branch below is uniform across the warp.
        int it = 0, ri = 0, ei = 0, nlog = 0;
        while (ri < R && it < max_iters) {
          const int r = order[ri];
          const int ex = exc[r];
          const bool next_rank = ex <= 0 || ei >= epr;
          bool accept = false;
          if (!next_rank) {
            const int e = rexp[r * epr + ei];
            const int cap = hl[e];    // u[e, r]: r is e's home
            const int he = home[e];
            const unsigned* be = bits + e * rw;
            const bool rep_ok = nrep[e] < max_rep;
            unsigned best = 0u, bt = FULL;
            const int hr = L > 0 ? he / L : 0;
            for (int t = lane; t < R; t += 32) {
              const int sl = slk[t];
              const bool hosted = t == he || ((be[t >> 5] >> (t & 31)) & 1u);
              const bool adm = rep_ok && sl > 0 && slots[t] < n_slot && !hosted;
              unsigned sc;
              if (L == 0) {
                sc = adm ? static_cast<unsigned>(sl) + 1u : 0u;
              } else {
                // Rack mode: bonus_scale * slack + the tie-break bonuses,
                // + 1 so that any admissible host scores above every other.
                const int rt = t / L;
                const unsigned bonus = (rt == hr ? 1u : 0u) +
                                       (lam_g != nullptr && dem[rt * E + e] ? 2u : 0u);
                sc = adm ? bonus_scale * static_cast<unsigned>(sl) + bonus + 1u : 0u;
              }
              if (bt == FULL || sc > best) {
                best = sc;
                bt = static_cast<unsigned>(t);
              }
            }
            const unsigned m = __reduce_max_sync(FULL, best);
            const unsigned t = __reduce_min_sync(FULL, best == m ? bt : FULL);
            if (m > 0u && cap > 0) {
              const int st = L == 0 ? static_cast<int>(m - 1u) : slk[t];
              const int delta = min(min(ex, st), cap);
              accept = delta >= u_min;
              if (accept && lane == 0) {
                hl[e] = cap - delta;
                exc[r] = ex - delta;
                slk[t] -= delta;
                slots[t] += 1;
                nrep[e] += 1;
                bits[e * rw + (t >> 5)] |= 1u << (t & 31);
                log[2 * nlog] = e * R + static_cast<int>(t);
                log[2 * nlog + 1] = delta;
              }
              nlog += accept;
            }
            __syncwarp();
          }
          if (next_rank) {
            ++ri;
            ei = 0;
          } else if (!accept) {
            ++ei;
          }
          ++it;
        }
        int sum = 0;
        for (int r = lane; r < R; r += 32) sum += exc[r];
        sum = __reduce_add_sync(FULL, sum);
        if (lane == 0) {
          tail[0] = sum == 0;
          tail[1] = it;
          tail[2] = nlog;
        }
      }
      __syncthreads();
      // Every thread reads the batch's outcome the same way.
      int first = -1, longest = 0;
      for (int j = 0; j < nb; ++j) {
        const int* tail = smem + s.region + j * s.region_words + 4 * R + 2 * E + E * rw;
        steps += tail[1];
        longest = max(longest, tail[1]);
        if (first < 0) {
          if (tail[0]) {
            first = j;
          } else {
            last_inf = probe_tau(lo, hi, b0 + j, P);
          }
        }
      }
      probes += nb;
      crit += longest;
      if (first >= 0) {
        found = true;
        new_hi = probe_tau(lo, hi, b0 + first, P);
        const int* reg = smem + s.region + first * s.region_words;
        const int* hl = reg + 4 * R + E;
        const int* tail = hl + E + E * rw;
        for (int e = tid; e < E; e += THREADS) best_hl[e] = hl[e];
        for (int i = tid; i < 2 * tail[2]; i += THREADS) best_log[1 + i] = tail[3 + i];
        if (tid == 0) best_log[0] = tail[2];
      }
      __syncthreads();
    }
    // The smallest feasible probe is the new hi; the largest infeasible one
    // below it, plus one, bounds lo (repro/core/planner.py:331-342).
    lo = max(lo, last_inf + 1);
    hi = new_hi;
  }
  for (int i = tid; i < E * R; i += THREADS) {
    const int e = i / R;
    u_out[i] = (i - e * R == home[e]) ? best_hl[e] : 0;
  }
  __syncthreads();
  for (int i = tid; i < best_log[0]; i += THREADS) u_out[best_log[1 + 2 * i]] = best_log[2 + 2 * i];
  if (tid == 0) {
    *tau_out = hi;
    if (stats != nullptr) {
      const int vals[3] = {probes, steps, crit};
      for (int i = 0; i < n_stats && i < 3; ++i) stats[i] = vals[i];
    }
  }
}

// The latency of one warp-reduction round, the unit of the solve's bound:
// one warp runs `rounds` dependent redux.sync max reductions (each round's
// input is the last round's result plus the lane), timed by the caller.
__global__ void redux_chain_kernel(int rounds, unsigned* out) {
  unsigned v = threadIdx.x;
  for (int i = 0; i < rounds; ++i) v = __reduce_max_sync(FULL, v + threadIdx.x);
  if (threadIdx.x == 0) *out = v;
}

}  // namespace

extern "C" int plan_solve_redux_chain(int rounds, void* out, void* stream) {
  redux_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      rounds, static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long plan_solve_smem_bytes(int E, int R, int L, int demand, int n_slot, int P) {
  return 4 * smem_words(E, R, L, demand, n_slot, P < WARPS ? P : WARPS);
}

// lam_e (E,), ell (R,), home (E,), rank_experts (R * E / R) int64, contiguous;
// lam (R, E) int64 or null (the demand tie-break, rack mode only); w (R,)
// f32 raw health weights or null; L the ranks per rack, 0 for the flat
// solve; P >= 1 the probes a round; u (E, R) and tau () int64 outputs;
// stats (n_stats,) int32 or null: probes, oracle steps, critical-path steps.
extern "C" int plan_solve_launch(const void* lam_e, const void* ell, const void* home,
                                 const void* rank_experts, const void* lam, const void* w, int E,
                                 int R, int n_slot, int u_min, int max_rep, int L, int P, void* u,
                                 void* tau, void* stats, int n_stats, void* stream) {
  if (R < 2 || E < R || E % R != 0 || n_slot < 0 || L < 0 || (L > 0 && R % L != 0) ||
      (lam != nullptr && L == 0) || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = plan_solve_smem_bytes(E, R, L, lam != nullptr, n_slot, P);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > SMALL_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        plan_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  plan_solve_kernel<<<1, THREADS, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(lam_e), static_cast<const long long*>(ell),
      static_cast<const long long*>(home), static_cast<const long long*>(rank_experts),
      static_cast<const long long*>(lam), static_cast<const float*>(w), E, R, n_slot, u_min,
      max_rep, L, P, static_cast<long long*>(u), static_cast<long long*>(tau),
      static_cast<int*>(stats), n_stats);
  return static_cast<int>(cudaGetLastError());
}
