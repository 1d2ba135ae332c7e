"""UltraEP plan solve: a hand-written Hopper kernel and its plain version.

``plan_solve`` takes the place of the JAX package's device-resident solve,
the two ``lax.while_loop`` of ``repro.core.planner`` (``solve_replication``
at :349, the threshold search, around ``_greedy_oracle`` at :198, the flat
cursor walk): flat or rack-aware, with or without health weights, at any
``probe_parallelism``.  It is no
Pallas kernel there, but it is the one loop of the MoE layer that runs for
a data-dependent number of steps, so in eager PyTorch its faithful
translation reads the device on every step; the kernel runs the whole
solve in one launch and reads nothing back.  The CUDA source is
``csrc/plan_solve.cu``; its header says what bounds the kernel on an H100
and what the design does about it.

Dispatch is by the tensors' device only: CPU tensors run the plain version
(:func:`plan_solve_ref`, Python loops whose conditions read scalars), CUDA
tensors launch the kernel or raise.  The wrapper counts its launches in
``plan_solve.launches``.  On the card nothing is read back, so a CUDA graph
can capture the call.

Inputs: ``lam_e`` (E,) per-expert load, ``ell`` (R,) per-rank home load,
``home`` (E,) home rank of each expert and ``rank_experts`` (R, E/R) each
rank's mains by descending load (stable by id), all int64; R >= 2.  Outputs:
``u`` (E, R) int64, the quota table, and ``tau`` () int64, the solved
threshold.  The kernel's arithmetic is int32, as the JAX solve's: the
caller passes ``load_bound``, a bound on the total load that the host
knows from the shapes (ranks x tokens per rank x top-k), and the wrapper
raises where it reaches 2^31; it never reads the load itself.

Rack mode (``rack_size`` L, ranks per rack of a two-level topology): the
oracle's argmax over candidate hosts scores each rank t by
``bonus_scale * (adm ? slack : -1) + 2 * demand[rack(t), e] + [rack(t) ==
rack(home e)]`` (``repro.core.planner._greedy_oracle``, :156-162), ties to
the lowest rank.  ``demand`` is the (G, E) incidence ``lam.reshape(G, L,
E).sum(1) > 0`` of the (R, E) load ``lam``, passed only with the demand
tie-break; then ``bonus_scale`` is 4, else 2.  JAX computes the score in
int32, so in rack mode the bound on the load is ``2^31 / bonus_scale``.

Health mode (``health_weight`` (R,), ``repro.core.planner`` :274-287):
the weights are normalised to ``w / max(wmax, 1e-12)`` (ones where ``wmax``
is 0), the search starts at ``ceil(f32(total) / max(sum w, 1e-12))`` and
``max(total, max ell)``, and each probe caps rank r at ``floor(f32(tau) *
w[r])``.  The f32 sum runs in rank order here and on the card; XLA does not
document its order, so a last-bit difference would move the start of the
search (the tests hold the plans against JAX's).  The bound on the load is
2^30 there: f32(tau) rounds up to 2^31 just below it.

k-ary probing (``probe_parallelism`` P > 1, :316-343): a round probes P
evenly spaced thresholds and keeps the smallest feasible one and the
largest infeasible one below it.  The kernel's warps take the probes in
batches of :data:`PROBE_WARPS`, in ascending order, and a batch holding a
feasible probe ends the round (no later probe can change its outcome); the
plain version runs the same batches, so the statistics agree.  JAX forms
``P * span`` in int32, so the bound on the load is also ``2^31 / P``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.build import KernelLibrary

__all__ = ["plan_solve", "plan_solve_ref", "rack_bonus", "load_limit",
           "redux_round_ms", "LIBRARY", "INT32_LIMIT", "PROBE_WARPS"]

LIBRARY = KernelLibrary("plan_solve",
                        Path(__file__).parent / "csrc" / "plan_solve.cu")

_I64 = torch.int64
INT32_LIMIT = 2 ** 31
MAX_SMEM = 232448          # 227 KB: the dynamic shared memory of an H100 block
PROBE_WARPS = 8            # the kernel's warps: probes run in batches of this


def _greedy_oracle(lam_e, ell, home, rank_experts, cap_r, *, n_slot: int,
                   u_min: int, max_replicas_per_expert: int, bonus=None,
                   bonus_scale: int = 1):
    """One feasibility probe (Alg. 1 lines 6-19).  Returns (feasible, u,
    steps).

    Mirrors the cursor walk of ``repro.core.planner._greedy_oracle``: the
    state lives in tensors, the cursor (rank index, expert index,
    iteration) in Python ints, and each step reads the scalars that decide
    whether it transfers load and where the cursor moves.  ``cap_r`` is
    each rank's capacity under the probe's threshold (R,).  ``bonus`` (E, R),
    in rack mode, is each (expert, host) pair's tie-break bonus, added to
    ``bonus_scale`` times the slack score.
    """
    E = lam_e.shape[0]
    R = ell.shape[0]
    epr = E // R
    dev = lam_e.device
    exc = (ell - cap_r).clamp(min=0)
    slk = (cap_r - ell).clamp(min=0)
    u = torch.nn.functional.one_hot(home, R).to(_I64) * lam_e[:, None]
    hosted = torch.nn.functional.one_hot(home, R).bool()        # (E, R)
    rank_order = torch.sort(-exc, stable=True).indices.tolist()
    slots = torch.zeros(R, dtype=_I64, device=dev)
    nrep = torch.zeros(E, dtype=_I64, device=dev)

    max_iters = R * (n_slot + epr + 2) + 2
    it = ri = ei = 0
    while ri < R and it < max_iters:
        r = rank_order[ri]
        rank_done = int(exc[r]) <= 0
        experts_done = ei >= epr
        accept = False
        if not (rank_done or experts_done):
            e = int(rank_experts[r, ei])
            cap = int(u[e, r])
            adm = ((slk > 0) & (slots < n_slot) & ~hosted[e, :]
                   & (nrep[e] < max_replicas_per_expert))
            # Slack first; torch.argmax returns the first (lowest-rank) max.
            score = torch.where(adm, slk, -1) * bonus_scale
            if bonus is not None:
                score = score + bonus[e]
            t = int(torch.argmax(score))
            if bool(adm.any()) and cap > 0:
                delta = min(int(exc[r]), int(slk[t]), cap)
                if delta >= u_min:
                    accept = True
                    u[e, r] -= delta
                    u[e, t] += delta
                    exc[r] -= delta
                    slk[t] -= delta
                    slots[t] += 1
                    hosted[e, t] = True
                    nrep[e] += 1
        if rank_done or experts_done:
            ri, ei = ri + 1, 0
        elif not accept:
            ei += 1
        it += 1
    return bool(exc.sum() == 0), u, it


def rack_bonus(home: torch.Tensor, R: int, rack_size: int,
               lam: torch.Tensor | None = None) -> tuple[torch.Tensor, int]:
    """(bonus (E, R), bonus_scale) of the rack-aware oracle: ``2 *
    demand[rack(t), e] + [rack(t) == rack(home e)]`` with ``demand`` the
    rack incidence of ``lam`` (R, E) when given, and the slack's scale (4
    with demand, else 2)."""
    ranks = torch.arange(R, dtype=_I64, device=home.device)
    rack = ranks // rack_size
    bonus = (rack[None, :] == (home // rack_size)[:, None]).to(_I64)
    if lam is None:
        return bonus, 2
    E = home.shape[0]
    demand = (lam.reshape(R // rack_size, rack_size, E).sum(dim=1) > 0)
    return bonus + 2 * demand.T[:, rack].to(_I64), 4


def _health_start(health_weight: torch.Tensor, total: int, ell_max: int):
    """Health mode's normalised weights (R,) float32 numpy and the search's
    start (lo, hi): the f32 arithmetic of ``repro.core.planner`` :274-287,
    with the weights summed in rank order, as the kernel sums them."""
    w = health_weight.detach().to("cpu", torch.float32).numpy().reshape(-1)
    tiny = np.float32(1e-12)
    wmax = np.float32(w.max())
    if wmax > 0:
        w = (w / np.maximum(wmax, tiny)).astype(np.float32)
    else:
        w = np.ones_like(w)
    s = np.float32(0.0)
    for v in w:
        s = np.float32(s + v)
    lo = int(np.ceil(np.float32(total) / np.maximum(s, tiny)))
    return w, lo, max(total, ell_max)


def plan_solve_ref(lam_e: torch.Tensor, ell: torch.Tensor, home: torch.Tensor,
                   rank_experts: torch.Tensor, *, n_slot: int, u_min: int,
                   max_replicas_per_expert: int,
                   stats: torch.Tensor | None = None,
                   rack_size: int | None = None,
                   lam: torch.Tensor | None = None,
                   health_weight: torch.Tensor | None = None,
                   probe_parallelism: int = 1):
    """Plain version: the threshold search of ``repro.core.planner.
    solve_replication`` (bisection, or the k-ary round at
    ``probe_parallelism`` P > 1, in the kernel's batches of PROBE_WARPS) as
    Python loops over the oracle's probes.  Returns ``(u, tau)``;
    ``stats`` (2,) or (3,), if given, receives (probes, oracle steps, and
    the critical path: the longest probe of each batch, summed).
    ``rack_size`` and ``lam``: rack mode; ``health_weight``: health mode
    (the module's notes)."""
    R = ell.shape[0]
    P = probe_parallelism
    if P < 1:
        raise ValueError(f"probe_parallelism={P} must be >= 1")
    bonus, scale = (None, 1) if rack_size is None else rack_bonus(
        home, R, rack_size, lam)
    total, ell_max = torch.stack([ell.sum(), ell.max()]).tolist()
    if health_weight is None:
        w = None
        lo, hi = -(-total // R), ell_max
    else:
        w, lo, hi = _health_start(health_weight, total, ell_max)

    def caps(tau):
        if w is None:
            return torch.full((R,), tau, dtype=_I64, device=ell.device)
        c = np.floor(np.float32(tau) * w).astype(np.int64)
        return torch.from_numpy(c).to(ell.device)

    best_u = torch.nn.functional.one_hot(home, R).to(_I64) * lam_e[:, None]
    probes = steps = crit = 0
    while lo < hi:
        span = hi - lo
        last_inf, new_hi = lo - 1, hi
        for b0 in range(0, P, PROBE_WARPS):
            first = None
            longest = 0
            for j in range(b0, min(b0 + PROBE_WARPS, P)):
                tau = min(lo + (j + 1) * span // (P + 1), hi - 1)
                feasible, u, it = _greedy_oracle(
                    lam_e, ell, home, rank_experts, caps(tau), n_slot=n_slot,
                    u_min=u_min,
                    max_replicas_per_expert=max_replicas_per_expert,
                    bonus=bonus, bonus_scale=scale)
                probes, steps = probes + 1, steps + it
                longest = max(longest, it)
                if first is None:
                    if feasible:
                        first, new_hi, best_u = j, tau, u
                    else:
                        last_inf = tau
            crit += longest
            if first is not None:
                break
        lo, hi = max(lo, last_inf + 1), new_hi
    if stats is not None:
        stats.copy_(torch.tensor([probes, steps, crit][:stats.shape[0]],
                                 dtype=stats.dtype))
    return best_u, torch.tensor(hi, dtype=_I64, device=lam_e.device)


@functools.cache
def _library():
    """The C entry point, its ctypes signature set once, at load."""
    lib = LIBRARY.load()
    lib.plan_solve_launch.restype = ctypes.c_int
    lib.plan_solve_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_void_p])
    lib.plan_solve_smem_bytes.restype = ctypes.c_longlong
    lib.plan_solve_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.plan_solve_redux_chain.restype = ctypes.c_int
    lib.plan_solve_redux_chain.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_void_p]
    return lib


def redux_round_ms(device=None, rounds: int = 1 << 16) -> float:
    """The card's latency of one warp-reduction round (``redux.sync``), in
    ms: one warp runs ``rounds`` dependent reductions, timed with CUDA
    events against a chain of 1 round.  The solve's bound is its serial
    oracle steps times this."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = torch.empty(1, dtype=torch.int32, device=device)
    stream = torch._C._cuda_getCurrentRawStream(out.device.index)
    lib = _library()

    def run(n):
        err = lib.plan_solve_redux_chain(n, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"redux chain launch failed: CUDA error {err}")

    run(rounds)
    times = []
    for n in (1, rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(n)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return (times[1] - times[0]) / (rounds - 1)


def load_limit(rack_size: int | None, demand: bool,
               probe_parallelism: int = 1, health: bool = False) -> int:
    """The kernel's exclusive bound on the total load: 2^31, over the rack
    score's slack scale (2, or 4 with demand) in rack mode, over P at
    ``probe_parallelism`` P (JAX's int32 ``P * span``), and at most 2^30 in
    health mode (f32(tau) must stay below 2^31)."""
    limit = INT32_LIMIT
    if rack_size is not None:
        limit = INT32_LIMIT // (4 if demand else 2)
    limit = min(limit, INT32_LIMIT // probe_parallelism)
    if health:
        limit = min(limit, INT32_LIMIT // 2)
    return limit


def _check(lam_e, ell, home, rank_experts, load_bound, rack_size,
           lam, *, n_slot: int, health_weight=None, P: int = 1) -> None:
    E, R = lam_e.shape[0], ell.shape[0]
    if R < 2:
        raise ValueError("plan_solve solves R >= 2 ranks; at R = 1 the "
                         "interval is empty and the plan is the home quota")
    if E % R != 0:
        raise ValueError(f"E={E} must be a multiple of R={R}")
    for name, t, shape in (("lam_e", lam_e, (E,)), ("ell", ell, (R,)),
                           ("home", home, (E,)),
                           ("rank_experts", rank_experts, (R, E // R))):
        if t.dtype != _I64 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"plan_solve: {name} must be contiguous int64 "
                             f"{shape}, not {t.dtype} {tuple(t.shape)}")
        if t.device != lam_e.device:
            raise ValueError(f"plan_solve: {name} is on {t.device}, not "
                             f"{lam_e.device}")
    if rack_size is not None and (rack_size < 1 or R % rack_size != 0):
        raise ValueError(f"rack_size={rack_size} must divide R={R}")
    if lam is not None:
        if rack_size is None:
            raise ValueError("plan_solve: the demand tie-break (lam) needs "
                             "rack_size")
        if (lam.dtype != _I64 or tuple(lam.shape) != (R, E)
                or not lam.is_contiguous() or lam.device != lam_e.device):
            raise ValueError(f"plan_solve: lam must be contiguous int64 "
                             f"{(R, E)} on {lam_e.device}")
    if health_weight is not None and (
            tuple(health_weight.shape) != (R,)
            or health_weight.device != lam_e.device):
        raise ValueError(f"plan_solve: health_weight must be ({R},) on "
                         f"{lam_e.device}")
    if P < 1:
        raise ValueError(f"probe_parallelism={P} must be >= 1")
    limit = load_limit(rack_size, lam is not None, P,
                       health_weight is not None)
    if load_bound is None or load_bound >= limit:
        scale = "" if limit == INT32_LIMIT else (
            f" / {INT32_LIMIT // limit} (the rack score's slack scale, "
            f"probe_parallelism, or health mode's f32 threshold)")
        raise ValueError(f"plan_solve's int32 arithmetic needs a total load "
                         f"below 2^31{scale}; the shapes allow {load_bound}")
    smem = _library().plan_solve_smem_bytes(
        E, R, rack_size or 0, 0 if lam is None else 1, n_slot, P)
    if smem > MAX_SMEM:
        raise ValueError(f"plan_solve: E={E}, R={R} need {smem} B of shared "
                         f"memory, more than {MAX_SMEM}")


def plan_solve(lam_e: torch.Tensor, ell: torch.Tensor, home: torch.Tensor,
               rank_experts: torch.Tensor, *, n_slot: int, u_min: int,
               max_replicas_per_expert: int, load_bound: int | None,
               stats: torch.Tensor | None = None,
               rack_size: int | None = None, lam: torch.Tensor | None = None,
               health_weight: torch.Tensor | None = None,
               probe_parallelism: int = 1):
    """Quota table ``u`` (E, R) and threshold ``tau`` () of one solve.

    ``stats``, if given, is an int32 (2,) or (3,) tensor on the inputs'
    device that receives (probes, oracle steps, critical-path steps).
    ``load_bound`` is needed on the card only (see the module docstring).
    ``rack_size`` switches on rack mode; ``lam`` (R, E) int64, with it, the
    demand tie-break; ``health_weight`` (R,) the health mode (raw weights,
    on the inputs' device: the kernel normalises them);
    ``probe_parallelism`` the probes a round."""
    if lam_e.device.type == "cpu":
        return plan_solve_ref(lam_e, ell, home, rank_experts, n_slot=n_slot,
                              u_min=u_min,
                              max_replicas_per_expert=max_replicas_per_expert,
                              stats=stats, rack_size=rack_size, lam=lam,
                              health_weight=health_weight,
                              probe_parallelism=probe_parallelism)
    if lam_e.device.type != "cuda":
        raise ValueError(f"no plan solve for device {lam_e.device}")
    _check(lam_e, ell, home, rank_experts, load_bound, rack_size, lam,
           n_slot=n_slot, health_weight=health_weight, P=probe_parallelism)
    if stats is not None and (stats.dtype != torch.int32
                              or tuple(stats.shape) not in ((2,), (3,))
                              or stats.device != lam_e.device):
        raise ValueError("plan_solve: stats must be int32 (2,) or (3,) on "
                         "the inputs' device")
    w = None
    if health_weight is not None:
        w = health_weight.to(torch.float32).contiguous()
    E, R = lam_e.shape[0], ell.shape[0]
    u = lam_e.new_empty((E, R))
    tau = lam_e.new_empty(())
    stream = torch._C._cuda_getCurrentRawStream(lam_e.device.index)
    err = _library().plan_solve_launch(
        lam_e.data_ptr(), ell.data_ptr(), home.data_ptr(),
        rank_experts.data_ptr(), None if lam is None else lam.data_ptr(),
        None if w is None else w.data_ptr(), E, R, n_slot, u_min,
        max_replicas_per_expert, rack_size or 0, probe_parallelism,
        u.data_ptr(), tau.data_ptr(),
        None if stats is None else stats.data_ptr(),
        0 if stats is None else stats.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"plan_solve kernel launch failed: CUDA error "
                           f"{err}")
    plan_solve.launches += 1
    return u, tau


plan_solve.launches = 0
