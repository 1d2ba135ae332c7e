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
// each step depends on the last one's placement, and a step is two block
// reductions (the argmax over experts, the argmin over ranks), each a
// redux.sync round in every warp, a barrier, a second round in one warp
// and a barrier.  So its least time is the steps times two such
// reductions; the wrapper's chain kernel times one.
//
// Design: one block of 256 threads; the state in shared memory: counts,
// eligible (E), slots (R), hosted as bits (E x ceil(R / 32) words), and
// each rank's hosted expert ids in ascending order (its mains, then each
// replica inserted in place: at most E / R + n_slot a rank), so est[t] is a
// short sequential sum by the thread that owns rank t.  Argmax keys are
// the f32 bit patterns of the non-negative loads per instance plus one (0
// for an ineligible expert), so two 32-bit redux.sync rounds give the
// maximum and then the lowest id that holds it; the argmin over ranks the
// same, with 0xffffffff for a rank that is not admissible.  Nothing is read
// back, so a CUDA graph can capture it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;
constexpr int SMALL_SMEM = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline long long smem_words(int E, int R, int n_slot) {
  const int rw = (R + 31) / 32;
  const int cap = E / R + n_slot;
  // lam, pi (f32), counts, eligible (E); slots, len (R); lists (R x cap);
  // bits (E x rw); reduction scratch and broadcasts (4 * WARPS + 8).
  return 4LL * E + 2LL * R + static_cast<long long>(R) * cap +
         static_cast<long long>(E) * rw + 4 * WARPS + 8;
}

// Block-wide (max key, lowest index holding it); every thread gets it.
// scratch: 2 * WARPS words.  Ends with a barrier.
__device__ inline void block_argmax(unsigned key, unsigned idx, unsigned* scratch,
                                    unsigned& out_key, unsigned& out_idx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned m = __reduce_max_sync(FULL, key);
  unsigned i = __reduce_min_sync(FULL, key == m ? idx : FULL);
  if (lane == 0) {
    scratch[warp] = m;
    scratch[WARPS + warp] = i;
  }
  __syncthreads();
  const unsigned k2 = lane < WARPS ? scratch[lane] : 0u;
  const unsigned i2 = lane < WARPS ? scratch[WARPS + lane] : FULL;
  m = __reduce_max_sync(FULL, k2);
  i = __reduce_min_sync(FULL, k2 == m ? i2 : FULL);
  out_key = m;
  out_idx = i;
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
eplb_place_kernel(const float* __restrict__ lam_g, const long long* __restrict__ home_g, int E,
                  int R, int n_slot, int max_rep, unsigned char* __restrict__ hosted_out,
                  int* __restrict__ stats) {
  extern __shared__ int smem[];
  const int rw = (R + 31) / 32;
  const int cap = E / R + n_slot;
  float* lam = reinterpret_cast<float*>(smem);
  float* pi = lam + E;
  int* counts = smem + 2 * E;
  int* eligible = counts + E;
  int* slots = eligible + E;
  int* len = slots + R;
  int* lists = len + R;
  unsigned* bits = reinterpret_cast<unsigned*>(lists + R * cap);
  unsigned* scratch = bits + E * rw;           // 2 * WARPS for each reduction
  int* bc = reinterpret_cast<int*>(scratch + 4 * WARPS);   // [0] budget, [1] eligible
  const int tid = threadIdx.x;

  for (int e = tid; e < E; e += THREADS) {
    lam[e] = lam_g[e];
    counts[e] = 1;
    eligible[e] = 1;
  }
  for (int i = tid; i < E * rw; i += THREADS) bits[i] = 0u;
  __syncthreads();
  for (int e = tid; e < E; e += THREADS) {
    const int h = static_cast<int>(home_g[e]);
    atomicOr(&bits[e * rw + (h >> 5)], 1u << (h & 31));
  }
  // Each rank's mains, in ascending id (the layout gives each E / R).
  for (int t = tid; t < R; t += THREADS) {
    int n = 0;
    for (int e = 0; e < E; ++e)
      if (static_cast<int>(home_g[e]) == t && n < cap) lists[t * cap + n++] = e;
    len[t] = n;
    slots[t] = 0;
  }
  if (tid == 0) {
    bc[0] = R * n_slot;
    bc[1] = E;
  }
  __syncthreads();
  int steps = 0, placed = 0;
  while (bc[0] > 0 && bc[1] > 0) {
    // 1. The expert with the largest load per instance.
    unsigned key = 0u, idx = FULL;
    for (int e = tid; e < E; e += THREADS) {
      const float p = __fdiv_rn(lam[e], static_cast<float>(counts[e]));
      pi[e] = p;
      const unsigned k = eligible[e] ? __float_as_uint(p) + 1u : 0u;
      if (idx == FULL || k > key) {
        key = k;
        idx = static_cast<unsigned>(e);
      }
    }
    unsigned ekey, esel;
    block_argmax(key, idx, scratch, ekey, esel);   // its barrier publishes pi
    const int e = static_cast<int>(esel);
    // Read before the update below can write it.
    const bool rep_ok = counts[e] < max_rep;
    // 2. The admissible rank with the lowest estimated load.
    unsigned rkey = FULL, ridx = FULL;
    for (int t = tid; t < R; t += THREADS) {
      const bool hosted = (bits[e * rw + (t >> 5)] >> (t & 31)) & 1u;
      if (slots[t] < n_slot && !hosted) {
        float est = 0.0f;
        for (int j = 0; j < len[t]; ++j) est = __fadd_rn(est, pi[lists[t * cap + j]]);
        const unsigned k = __float_as_uint(est);
        if (k < rkey) {
          rkey = k;
          ridx = static_cast<unsigned>(t);
        }
      }
    }
    // argmin as argmax of the complement.
    unsigned nkey, tsel;
    block_argmax(~rkey, ridx, scratch + 2 * WARPS, nkey, tsel);
    const bool any_adm = nkey != 0u;
    const bool feasible = any_adm && rep_ok && ekey > 1u;
    ++steps;
    if (feasible) {
      const int t = static_cast<int>(tsel);
      if (tid == 0) {
        bits[e * rw + (t >> 5)] |= 1u << (t & 31);
        slots[t] += 1;
        counts[e] += 1;
        bc[0] -= 1;
        // Insert e into t's ascending list.
        int n = len[t];
        int* l = lists + t * cap;
        if (n < cap) {
          int j = n;
          while (j > 0 && l[j - 1] > e) {
            l[j] = l[j - 1];
            --j;
          }
          l[j] = e;
          len[t] = n + 1;
        }
      }
      ++placed;
    } else if (tid == 0) {
      eligible[e] = 0;
      bc[1] -= 1;
    }
    __syncthreads();
  }
  for (int i = tid; i < E * R; i += THREADS) {
    const int e = i / R, t = i - e * R;
    hosted_out[i] = static_cast<unsigned char>((bits[e * rw + (t >> 5)] >> (t & 31)) & 1u);
  }
  if (tid == 0 && stats != nullptr) {
    stats[0] = steps;
    stats[1] = placed;
  }
}

// The unit of the bound: `rounds` dependent block reductions of the kind a
// step makes twice, timed by the caller.
__global__ void __launch_bounds__(THREADS, 1) block_reduce_chain_kernel(int rounds, unsigned* out) {
  __shared__ unsigned scratch[2 * WARPS];
  unsigned key = threadIdx.x, idx = threadIdx.x;
  for (int i = 0; i < rounds; ++i) {
    unsigned k, j;
    block_argmax(key + threadIdx.x, idx, scratch, k, j);
    key = k;
    idx = j ^ threadIdx.x;
  }
  if (threadIdx.x == 0) *out = key + idx;
}

}  // namespace

extern "C" long long eplb_place_smem_bytes(int E, int R, int n_slot) {
  return 4 * smem_words(E, R, n_slot);
}

extern "C" int eplb_place_block_reduce_chain(int rounds, void* out, void* stream) {
  block_reduce_chain_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rounds, static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}

// lam (E,) f32 estimated loads (non-negative), home (E,) int64 (each rank
// the home of E / R experts); hosted (E, R) uint8 output; stats (2,) int32
// or null: (steps, placements).
extern "C" int eplb_place_launch(const void* lam, const void* home, int E, int R, int n_slot,
                                 int max_rep, void* hosted, void* stats, void* stream) {
  if (R < 1 || E < R || E % R != 0 || n_slot < 0 || max_rep < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = eplb_place_smem_bytes(E, R, n_slot);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > SMALL_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        eplb_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  eplb_place_kernel<<<1, THREADS, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lam), static_cast<const long long*>(home), E, R, n_slot, max_rep,
      static_cast<unsigned char*>(hosted), static_cast<int*>(stats));
  return static_cast<int>(cudaGetLastError());
}
