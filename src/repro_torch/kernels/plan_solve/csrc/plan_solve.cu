// UltraEP plan solve for Hopper (sm_90a): the threshold bisection and the
// greedy feasibility oracle of the paper's Alg. 1 in one launch.
//
// Replaces the device-resident solve of the JAX package, which is no Pallas
// kernel but two lax.while_loop in repro/core/planner.py:
//   solve_replication (:349, bisection over the threshold tau) around
//   _greedy_oracle (:198, the flat cursor walk over (rank, expert)),
// at probe_parallelism=1 without health weights, flat or rack-aware.  Given
// lam_e (E,) (per-expert load), ell (R,) (per-rank home load), home (E,)
// and rank_experts (R, E/R) (each rank's mains by descending load, stable
// by id), it writes the quota table u (E, R) and the solved tau, both
// int64, and optionally (probes, oracle steps).  The arithmetic is int32,
// as in JAX (repro/core/planner.py:256-257); the wrapper raises where the
// shapes allow a total load of 2^31 or more.
//
// Rack mode (rack_size L > 0, ranks per rack; repro/core/planner.py:79-198):
// the argmax over candidate hosts t scores
//   bonus_scale * (adm ? slk[t] : -1) + 2 * demand[rack(t), e]
//       + [rack(t) == rack(home e)],
// ties to the lowest rank, with bonus_scale 4 when the (G, E) demand
// incidence is on (lam given: demand[g, e] = sum of lam over rack g's ranks
// > 0) and 2 otherwise.  The kernel computes the incidence from lam itself,
// once, into shared memory beside the state, so nothing is read back.  JAX
// scores in int32; the wrapper bounds the total load below 2^31 /
// bonus_scale, so bonus_scale * slk + 3 + 1 fits the unsigned score word.
// With one rack every bonus is the same for every host and the plan is the
// flat one.
//
// What bounds it on an H100: latency.  It reads a few KB and writes E * R
// int64 words (64 KB at E 128, R 64), but the oracle is a chain of
// dependent steps: every step reads the cursor's rank and expert, scores
// every rank, reduces the scores across the warp and applies one transfer
// before the next step can read the state.  So its least time is the
// number of serial oracle steps (summed over the bisection's probes) times
// the latency of one step's shared-memory reads and warp reductions.
//
// Design, kept simple:
// 1. One block per solve; every EP rank solves the same plan redundantly
//    (as JAX does), so nothing is exchanged after the load gather.
// 2. The state lives in shared memory: u (E * R int32, 32 KB at E 128 and
//    R 64, 64 KB at E 256; above 48 KB the launch opts in to the larger
//    dynamic size), exc, slk, slots (R), nrep (E), the rank order, and the
//    inputs converted to int32.  JAX's `hosted` table is not stored: a
//    transfer moves at least one item (exc, slk and cap are all positive
//    when it is accepted) and an off-home u[e, t] only ever grows, so
//    hosted[e, t] == (t == home[e] || u[e, t] > 0).
// 3. The whole block (256 threads) resets the state for each probe and
//    sorts the ranks by excess (a rank's place is a count over the others:
//    R^2 / 256 compares); one warp walks the cursor.  A step scores the
//    ranks lane by lane (lane l holds ranks l, l + 32, ...: the first
//    maximum among its own), then takes the warp's largest score+1 with one
//    redux.sync and the lowest rank among the lanes that hold it with a
//    second, so ties pick the lowest rank, as torch.argmax and jnp.argmax
//    do.  Lane 0 applies the transfer; __syncwarp orders it before the next
//    step's reads.  The other warps wait at the barrier: the block is wide
//    enough for P warps to run P probes of a k-ary search later
//    (probe_parallelism > 1), which is not built.
// 4. best_u is the output buffer itself: the home quota first, then the u
//    of every feasible probe, written by the whole block.
// 5. Nothing is read back to the host, so a CUDA graph can capture it.
// CUDA C++ rather than Triton: the port's kernels are CUDA C++ for sm_90a,
// bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;     // 227 KB: an H100 block's dynamic limit
constexpr int SMALL_SMEM = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline long long smem_ints(int E, int R, int L, int demand) {
  // u, then exc, slk, slots, order, ell (R each), then lam_e, home, nrep,
  // rank_experts (E each), then 4 words of flags, then the demand
  // incidence (R / L racks x E) in rack mode with demand.
  const long long dem = (L > 0 && demand) ? static_cast<long long>(R / L) * E : 0;
  return static_cast<long long>(E) * R + 5LL * R + 4LL * E + 4 + dem;
}

__global__ void __launch_bounds__(THREADS, 1)
plan_solve_kernel(const long long* __restrict__ lam_e_g, const long long* __restrict__ ell_g,
                  const long long* __restrict__ home_g,
                  const long long* __restrict__ rank_experts_g,
                  const long long* __restrict__ lam_g, int E, int R, int n_slot,
                  int u_min, int max_rep, int L, long long* __restrict__ u_out,
                  long long* __restrict__ tau_out, int* __restrict__ stats) {
  extern __shared__ int smem[];
  int* u = smem;
  int* exc = u + E * R;
  int* slk = exc + R;
  int* slots = slk + R;
  int* order = slots + R;
  int* ell = order + R;
  int* lam_e = ell + R;
  int* home = lam_e + E;
  int* nrep = home + E;
  int* rexp = nrep + E;
  int* flag = rexp + E;   // [0] feasible, [1] total load, [2] max rank load
  int* dem = flag + 4;    // (R / L, E) demand incidence (rack mode with lam)
  const unsigned bonus_scale = lam_g != nullptr ? 4u : 2u;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int epr = E / R;
  const int ER = E * R;

  for (int i = tid; i < E; i += THREADS) {
    lam_e[i] = static_cast<int>(lam_e_g[i]);
    home[i] = static_cast<int>(home_g[i]);
    rexp[i] = static_cast<int>(rank_experts_g[i]);
  }
  for (int r = tid; r < R; r += THREADS) ell[r] = static_cast<int>(ell_g[r]);
  if (lam_g != nullptr) {
    for (int i = tid; i < (R / L) * E; i += THREADS) {
      const int g = i / E, e = i - g * E;
      bool any = false;
      for (int l = 0; l < L; ++l) any |= lam_g[static_cast<long long>(g * L + l) * E + e] > 0;
      dem[i] = any;
    }
  }
  __syncthreads();
  if (tid < 32) {
    int s = 0, m = 0;   // loads are non-negative
    for (int r = lane; r < R; r += 32) {
      s += ell[r];
      m = max(m, ell[r]);
    }
    s = __reduce_add_sync(FULL, s);
    m = __reduce_max_sync(FULL, m);
    if (lane == 0) {
      flag[1] = s;
      flag[2] = m;
    }
  }
  // best_u starts as the home quota (what an empty interval returns).
  for (int i = tid; i < ER; i += THREADS) {
    const int e = i / R;
    u_out[i] = (i - e * R == home[e]) ? lam_e[e] : 0;
  }
  __syncthreads();
  const int total = flag[1];
  int lo = total / R + (total % R != 0);   // ceil of the mean rank load
  int hi = flag[2];
  int probes = 0, steps = 0;
  while (lo < hi) {
    const int tau = lo + (hi - lo) / 2;    // == (lo + hi) // 2, no overflow
    for (int i = tid; i < ER; i += THREADS) {
      const int e = i / R;
      u[i] = (i - e * R == home[e]) ? lam_e[e] : 0;
    }
    for (int r = tid; r < R; r += THREADS) {
      exc[r] = max(ell[r] - tau, 0);
      slk[r] = max(tau - ell[r], 0);
      slots[r] = 0;
    }
    for (int e = tid; e < E; e += THREADS) nrep[e] = 0;
    __syncthreads();
    // Stable descending order of the excess (argsort(-exc, stable=True)).
    for (int r = tid; r < R; r += THREADS) {
      const int x = exc[r];
      int pos = 0;
      for (int q = 0; q < R; ++q) {
        const int y = exc[q];
        pos += (y > x) || (y == x && q < r);
      }
      order[pos] = r;
    }
    __syncthreads();
    if (tid < 32) {
      // The cursor walk; every branch below is uniform across the warp.
      const int max_iters = R * (n_slot + epr + 2) + 2;
      int it = 0, ri = 0, ei = 0;
      while (ri < R && it < max_iters) {
        const int r = order[ri];
        const int ex = exc[r];
        const bool next_rank = ex <= 0 || ei >= epr;
        bool accept = false;
        if (!next_rank) {
          const int e = rexp[r * epr + ei];
          const int* ue = u + e * R;
          const int cap = ue[r];
          const int he = home[e];
          const bool rep_ok = nrep[e] < max_rep;
          unsigned best = 0u, bt = FULL;
          if (L == 0) {
            for (int t = lane; t < R; t += 32) {
              const int s = slk[t];
              const bool adm = rep_ok && s > 0 && slots[t] < n_slot && t != he && ue[t] <= 0;
              const unsigned sc = adm ? static_cast<unsigned>(s) + 1u : 0u;
              if (bt == FULL || sc > best) {
                best = sc;
                bt = static_cast<unsigned>(t);
              }
            }
          } else {
            // Rack mode: bonus_scale * slack + the tie-break bonuses, + 1
            // so that any admissible host scores above every other.
            const int hr = he / L;
            const int* de = dem + e;
            for (int t = lane; t < R; t += 32) {
              const int s = slk[t];
              const bool adm = rep_ok && s > 0 && slots[t] < n_slot && t != he && ue[t] <= 0;
              const int rt = t / L;
              const unsigned bonus = (rt == hr ? 1u : 0u) +
                                     (lam_g != nullptr && de[rt * E] ? 2u : 0u);
              const unsigned sc = adm ? bonus_scale * static_cast<unsigned>(s) + bonus + 1u : 0u;
              if (bt == FULL || sc > best) {
                best = sc;
                bt = static_cast<unsigned>(t);
              }
            }
          }
          const unsigned m = __reduce_max_sync(FULL, best);
          const unsigned t = __reduce_min_sync(FULL, best == m ? bt : FULL);
          if (m > 0u && cap > 0) {
            const int st = L == 0 ? static_cast<int>(m - 1u) : slk[t];
            const int delta = min(min(ex, st), cap);
            accept = delta >= u_min;
            if (accept && lane == 0) {
              u[e * R + r] -= delta;
              u[e * R + t] += delta;
              exc[r] = ex - delta;
              slk[t] -= delta;
              slots[t] += 1;
              nrep[e] += 1;
            }
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
      steps += it;
      int s = 0;
      for (int r = lane; r < R; r += 32) s += exc[r];
      s = __reduce_add_sync(FULL, s);
      if (lane == 0) flag[0] = (s == 0);
    }
    __syncthreads();
    if (flag[0]) {
      for (int i = tid; i < ER; i += THREADS) u_out[i] = u[i];
      hi = tau;
    } else {
      lo = tau + 1;
    }
    ++probes;
    __syncthreads();
  }
  if (tid == 0) {
    *tau_out = hi;
    if (stats != nullptr) {
      stats[0] = probes;
      stats[1] = steps;
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

extern "C" long long plan_solve_smem_bytes(int E, int R, int L, int demand) {
  return 4 * smem_ints(E, R, L, demand);
}

// lam_e (E,), ell (R,), home (E,), rank_experts (R * E / R) int64, contiguous;
// lam (R, E) int64 or null (the demand tie-break, rack mode only); L the
// ranks per rack, 0 for the flat solve; u (E, R) and tau () int64 outputs;
// stats (2,) int32 or null.
extern "C" int plan_solve_launch(const void* lam_e, const void* ell, const void* home,
                                 const void* rank_experts, const void* lam, int E, int R,
                                 int n_slot, int u_min, int max_rep, int L, void* u, void* tau,
                                 void* stats, void* stream) {
  if (R < 2 || E < R || E % R != 0 || n_slot < 0 || L < 0 || (L > 0 && R % L != 0) ||
      (lam != nullptr && L == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = plan_solve_smem_bytes(E, R, L, lam != nullptr);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > SMALL_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        plan_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  plan_solve_kernel<<<1, THREADS, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(lam_e), static_cast<const long long*>(ell),
      static_cast<const long long*>(home), static_cast<const long long*>(rank_experts),
      static_cast<const long long*>(lam), E, R, n_slot, u_min, max_rep, L,
      static_cast<long long*>(u), static_cast<long long*>(tau),
      static_cast<int*>(stats));
  return static_cast<int>(cudaGetLastError());
}
