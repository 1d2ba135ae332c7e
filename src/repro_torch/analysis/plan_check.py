"""Static verifier for solved balancing plans (mirrors
``repro.analysis.plan_check``; DESIGN.md S10).

``verify_plan`` checks a :class:`repro_torch.core.planner.Plan` against the
paper's conservation and topology invariants *without executing anything*: it
is pure host-side numpy over the plan's integer tables (torch tensors, on any
device, read back as numpy), so a wrong quota table, a
reroute split that drops or duplicates tokens, or a replica placement that
targets a rank holding no instance is caught before a single token moves.

Checked invariants (rule ids):

* ``shape``                  -- table shapes agree with (E, R) and the topology.
* ``token-conservation``     -- ``q.sum(dst) == lam``, ``q.sum(src) == u``,
                                ``u.sum(rank) == lam_e``: no token created,
                                dropped, or duplicated across reroute tiers.
* ``quota-nonnegative``      -- all quota / reroute entries are >= 0.
* ``cumsum-consistency``     -- ``cum_q`` / ``cum_u`` are the inclusive
                                cumsums of ``q`` / ``u`` (monotone by
                                construction); the dispatch engine's
                                destination lookup depends on this.
* ``replica-placement``      -- every rerouted token lands on a rank that
                                actually holds an instance; ``hosted``
                                matches ``u`` and the home map; the slot map
                                ``x`` lists exactly the off-home instances in
                                expert-id order within the slot budget.
* ``threshold-bounds``       -- ``post_max == max rank load``, ``pre_max ==
                                max home load``, ``post_max <= tau <=
                                pre_max`` (health-weighted solves use a
                                wider bound: tau is in full-speed-rank
                                units, see ``health-capacity``).
* ``health-capacity``        -- (with ``health_weight=``) every rank's load
                                fits its health-scaled capacity
                                ``floor(tau * w_r)``: a plan that ignores a
                                slow rank's weight is rejected.
* ``health-quarantine``      -- (with ``health_weight=``) quarantined ranks
                                (weight 0) host no quota and receive no
                                rerouted token: the rank fully drains.
* ``tier-accounting``        -- ``tier_tokens`` / ``tier_replicas`` match the
                                reroute matrix and placement under the given
                                topology, and their sums match the totals.
* ``tier-bytes``             -- (opt-in, via ``tier_bytes=``) reported
                                per-tier byte volumes equal ``tier_tokens``
                                times the wire payload width.  The width is
                                recomputed here from first principles (an
                                independent mirror of
                                ``repro_torch.core.quantize.payload_bytes_per_item``)
                                so a bug in the production helper cannot
                                vouch for itself.
* ``gate-tier-accounting``   -- the plan's at-gate ``gate_tier_tokens``
                                (deduplicated payload copies, DESIGN.md S14)
                                are consistent with the load matrix: each
                                tier's copy count is bounded by the
                                home-routing item count of the same tier
                                (dedup can only shrink volume).
* ``rack-local-optimality``  -- (warn) the reroute crosses racks more than
                                the minimum achievable for its quota table;
                                expected for the topology-blind EPLB
                                baselines, a regression for rack-aware modes.

:func:`verify_rack_limit` is the routing-side invariant of rack-limited
gating (DESIGN.md S14): every token's selected experts span at most
``rack_limit`` racks, and at ``rack_limit == num_racks`` the selection is
bitwise identical to free routing.

The module also provides the opt-in debug hook used by
:func:`repro_torch.core.balancer.solve` (enable with
:func:`plan_verification`; off by default, when it reads nothing back) and
an exception type, which the degradation ladder of
:class:`repro_torch.moe.stages.Resilience` catches.
"""

from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch

from repro_torch.analysis.violation import (
    Violation,
    errors,
    format_violations,
)

__all__ = [
    "PlanViolationError",
    "verify_plan",
    "verify_rack_limit",
    "verify_tier_bytes",
    "verify_chunking",
    "check_capacities",
    "assert_plan_valid",
    "hosted_matrix",
    "plan_verification",
    "verification_enabled",
    "verify_solved",
]


class PlanViolationError(AssertionError):
    """A solved plan failed static verification."""

    def __init__(self, violations: list[Violation]):
        self.violations = violations
        super().__init__(
            f"{len(violations)} plan invariant violation(s):\n"
            + format_violations(violations)
        )


def _np(x: Any) -> np.ndarray:
    """A table as host numpy (a torch tensor is read back)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def hosted_matrix(plan: Any) -> np.ndarray:
    """(E, R) bool instance indicator in the comm-planner's orientation.

    ``Plan.hosted`` is stored rank-major (R, E) while
    :func:`repro_torch.core.comm_plan.build_relay_schedule` consumes expert-major
    (E, R); this helper is the one sanctioned bridge so the transpose never
    happens by accident at a call site.
    """
    return _np(plan.hosted).astype(bool).T


def _default_home(E: int, R: int) -> np.ndarray:
    """Contiguous-block home map (the repo's fixed-mains layout)."""
    return np.repeat(np.arange(R, dtype=np.int64), E // R)


def _rack_of(R: int, rack_size: int) -> np.ndarray:
    return np.arange(R, dtype=np.int64) // rack_size


def _token_tiers(q: np.ndarray, rack_size: int) -> np.ndarray:
    """Numpy mirror of :func:`repro_torch.core.planner.token_tier_volumes`."""
    R = q.shape[0]
    per_pair = q.sum(axis=1)
    ranks = np.arange(R)
    same_rank = ranks[:, None] == ranks[None, :]
    same_rack = (ranks[:, None] // rack_size) == (ranks[None, :] // rack_size)
    local = per_pair[same_rank].sum()
    intra = per_pair[same_rack & ~same_rank].sum()
    inter = per_pair[~same_rack].sum()
    return np.array([local, intra, inter], dtype=np.int64)


def _replica_tiers(u: np.ndarray, home: np.ndarray,
                   rack_size: int) -> np.ndarray:
    """Numpy mirror of :func:`repro_torch.core.planner.replica_tier_volumes`."""
    E, R = u.shape
    ranks = np.arange(R)
    is_rep = (u.T > 0) & (home[None, :] != ranks[:, None])
    same_rack = (ranks[:, None] // rack_size) == (home[None, :] // rack_size)
    return np.array([(is_rep & same_rack).sum(),
                     (is_rep & ~same_rack).sum()], dtype=np.int64)


def _min_inter_rack_tokens(lam: np.ndarray, u: np.ndarray,
                           rack_size: int) -> int:
    """Minimum inter-rack token volume achievable for a fixed quota table.

    Per expert, a rack can absorb at most its own quota of its own demand;
    the surplus ``max(0, rack_demand - rack_quota)`` must cross racks.  The
    rack-local reroute tier achieves exactly this bound (see
    ``planner.solve_reroute``); topology-blind reroutes exceed it.
    """
    R, E = lam.shape
    G = R // rack_size
    demand_g = lam.T.reshape(E, G, rack_size).sum(axis=2)   # (E, G)
    quota_g = u.reshape(E, G, rack_size).sum(axis=2)        # (E, G)
    return int(np.maximum(demand_g - quota_g, 0).sum())


def _mirror_payload_width(d_model: int, wire_dtype: str,
                          base_bytes: int) -> int:
    """Wire bytes per routed item, recomputed from the format definition.

    Deliberately NOT imported from :mod:`repro_torch.core.quantize`: this is the
    verifier's independent mirror of ``payload_bytes_per_item``.  The int8
    wire carries the d_model int8 codes plus one fp32 per-row scale bitcast
    into 4 in-band int8 lanes; bf16 halves the feature bytes; "none" ships
    the activation dtype unchanged.
    """
    if wire_dtype == "int8":
        return d_model + 4
    if wire_dtype == "bf16":
        return d_model * 2
    if wire_dtype == "none":
        return d_model * base_bytes
    raise ValueError(f"unknown wire_dtype {wire_dtype!r}")


def verify_tier_bytes(plan: Any, tier_bytes: Any, *, d_model: int,
                      wire_dtype: str = "none",
                      base_bytes: int = 4) -> list[Violation]:
    """Check reported per-tier byte volumes against tokens x payload width.

    ``tier_bytes`` is the (3,) [local, intra, inter] byte accounting the
    runtime reports (``MoEStats.tier_bytes``) or the host cost model prices
    (``comm_plan.tier_wire_bytes``); the plan's ``tier_tokens`` times the
    independently mirrored payload width is the ground truth.
    """
    out: list[Violation] = []
    tt = getattr(plan, "tier_tokens", None)
    if tt is None:
        return [Violation("tier-bytes",
                          "tier_bytes given but the plan carries no "
                          "tier_tokens to price", severity="warn")]
    tb = _np(tier_bytes).astype(np.int64)
    want = (_np(tt).astype(np.int64)
            * _mirror_payload_width(d_model, wire_dtype, base_bytes))
    if tb.shape != want.shape:
        return [Violation("tier-bytes",
                          f"tier_bytes shape {tb.shape} != tier_tokens "
                          f"shape {want.shape}")]
    if not np.array_equal(tb, want):
        out.append(Violation(
            "tier-bytes",
            f"tier_bytes={tb.tolist()} != tier_tokens x "
            f"{_mirror_payload_width(d_model, wire_dtype, base_bytes)}B "
            f"({wire_dtype} wire, d_model={d_model}) = {want.tolist()}: "
            "the byte accounting disagrees with the wire format"))
    return out


def verify_plan(
    plan: Any,
    topo: Any = None,
    *,
    lam: np.ndarray | None = None,
    home: np.ndarray | None = None,
    rack_aware_mode: bool | None = None,
    health_weight: Any = None,
) -> list[Violation]:
    """Statically verify a solved plan; returns all violations found.

    Args:
      plan: a :class:`repro_torch.core.planner.Plan` (or any object with the same
        fields) of *concrete* integer tables.
      topo: optional :class:`repro_torch.core.topology.Topology`; switches on the
        topology checks (tier accounting, rack-local optimality).  ``None``
        verifies the flat invariants only.
      lam: optional (R, E) load matrix.  When omitted it is recovered from
        the reroute marginal ``q.sum(dst)`` (exact for any conserving plan).
      home: optional (E,) home map; defaults to the repo's contiguous-block
        layout.
      rack_aware_mode: whether the producing balancer claims rack-local
        optimality (ultraep / lplb with the rack tier).  ``None`` keeps the
        optimality check at "warn" severity; ``True`` promotes it to an
        error; ``False`` skips it (the EPLB baselines' documented
        discrepancy -- see DESIGN.md S10).
      health_weight: optional (R,) per-rank throughput weights the plan was
        solved with.  Switches the threshold check to full-speed-rank units
        and adds the ``health-capacity`` / ``health-quarantine`` rules: load
        must fit ``floor(tau * w_r)`` per rank and weight-0 ranks must be
        fully drained.  An infeasible health solve that fell back to home
        placement therefore *fails* verification -- by design, so the
        degradation ladder can catch it and fall back.
    """
    out: list[Violation] = []
    q = _np(plan.q).astype(np.int64)
    u = _np(plan.u).astype(np.int64)
    x = _np(plan.x).astype(np.int64)
    hosted = _np(plan.hosted).astype(bool)
    cum_q = _np(plan.cum_q).astype(np.int64)
    cum_u = _np(plan.cum_u).astype(np.int64)
    tau = int(_np(plan.tau))
    pre_max = int(_np(plan.pre_max))
    post_max = int(_np(plan.post_max))

    # --- shape ------------------------------------------------------------
    if u.ndim != 2:
        return [Violation("shape", f"u must be (E, R), got {u.shape}")]
    E, R = u.shape
    if q.shape != (R, E, R):
        return [Violation("shape",
                          f"q must be (R, E, R)=({R},{E},{R}), got {q.shape}")]
    if hosted.shape != (R, E):
        out.append(Violation("shape",
                             f"hosted must be (R, E), got {hosted.shape}"))
    if x.ndim != 2 or x.shape[0] != R:
        out.append(Violation("shape", f"x must be (R, n_slot), got {x.shape}"))
    if topo is not None and topo.ep_size != R:
        out.append(Violation(
            "shape",
            f"topology covers {topo.ep_size} ranks but the plan has R={R}"))
    if out:
        return out
    n_slot = x.shape[1]

    if home is None:
        if E % R != 0:
            return [Violation("shape", f"E={E} not divisible by R={R} and no "
                                       "home map given")]
        home = _default_home(E, R)
    home = _np(home).astype(np.int64)

    lam_from_q = q.sum(axis=2).astype(np.int64)
    if lam is None:
        lam = lam_from_q
    else:
        lam = _np(lam).astype(np.int64)
        if not np.array_equal(lam_from_q, lam):
            bad = int(np.abs(lam_from_q - lam).sum())
            out.append(Violation(
                "token-conservation",
                f"q.sum(dst) != lam: {bad} token(s) created or dropped by "
                "the reroute split"))

    # --- non-negativity ---------------------------------------------------
    if (q < 0).any():
        out.append(Violation("quota-nonnegative",
                             f"{int((q < 0).sum())} negative entries in q"))
    if (u < 0).any():
        out.append(Violation("quota-nonnegative",
                             f"{int((u < 0).sum())} negative entries in u"))

    # --- conservation across reroute tiers --------------------------------
    if not np.array_equal(q.sum(axis=0), u):
        bad = int(np.abs(q.sum(axis=0) - u).sum())
        out.append(Violation(
            "token-conservation",
            f"q.sum(src) != u: instance loads disagree with the reroute "
            f"matrix by {bad} token(s)"))
    lam_e = lam.sum(axis=0)
    if not np.array_equal(u.sum(axis=1), lam_e):
        bad = np.where(u.sum(axis=1) != lam_e)[0]
        out.append(Violation(
            "token-conservation",
            f"u.sum(rank) != lam_e for expert(s) {bad.tolist()[:8]}: load "
            "not fully assigned to instances"))

    # --- cumulative tables (dispatch lookup contract) ---------------------
    if not np.array_equal(cum_q, np.cumsum(q, axis=-1)):
        out.append(Violation(
            "cumsum-consistency",
            "cum_q != inclusive cumsum of q: token_targets would misroute"))
    if not np.array_equal(cum_u, np.cumsum(u, axis=-1)):
        out.append(Violation(
            "cumsum-consistency",
            "cum_u != inclusive cumsum of u: replicated-mode ownership "
            "lookup would misroute"))

    # --- replica placement ------------------------------------------------
    ranks = np.arange(R, dtype=np.int64)
    is_rep = (u.T > 0) & (home[None, :] != ranks[:, None])        # (R, E)
    want_hosted = (u.T > 0) | (home[None, :] == ranks[:, None])
    if not np.array_equal(hosted, want_hosted):
        out.append(Violation(
            "replica-placement",
            "hosted != (u > 0 | main): instance indicator disagrees with "
            "the quota table"))
    landed = q.sum(axis=0).T > 0                                   # (R, E)
    stray = landed & ~want_hosted
    if stray.any():
        t, e = np.argwhere(stray)[0]
        out.append(Violation(
            "replica-placement",
            f"{int(stray.sum())} (expert, rank) reroute target(s) hold no "
            f"instance, e.g. expert {e} -> rank {t}: those tokens would be "
            "dropped at dispatch"))
    if (is_rep.sum(axis=1) > n_slot).any():
        r = int(np.argmax(is_rep.sum(axis=1)))
        out.append(Violation(
            "replica-placement",
            f"rank {r} carries {int(is_rep[r].sum())} replicas but has only "
            f"{n_slot} redundant slots"))
    # Slot map: exactly the off-home instances, expert-id order, -1 padded.
    for r in range(R):
        reps = np.where(is_rep[r])[0]
        want = np.full(n_slot, -1, dtype=np.int64)
        want[: min(len(reps), n_slot)] = reps[:n_slot]
        if not np.array_equal(x[r], want):
            out.append(Violation(
                "replica-placement",
                f"slot map x[{r}]={x[r].tolist()} does not bind the rank's "
                f"replicas {reps.tolist()} in expert-id order: replica "
                "weights would stream to the wrong slot"))
            break

    # --- threshold bookkeeping --------------------------------------------
    ell = np.zeros(R, dtype=np.int64)
    np.add.at(ell, home, lam_e)
    post = int(u.sum(axis=0).max()) if R else 0
    pre = int(ell.max()) if R else 0
    if post_max != post:
        out.append(Violation(
            "threshold-bounds",
            f"post_max={post_max} != max post-balance rank load {post}"))
    if pre_max != pre:
        out.append(Violation(
            "threshold-bounds",
            f"pre_max={pre_max} != max pre-balance rank load {pre}"))
    if health_weight is None:
        if not (post <= tau <= max(pre, post)):
            out.append(Violation(
                "threshold-bounds",
                f"tau={tau} outside [post_max={post}, pre_max={pre}]"))
    else:
        w = _np(health_weight).astype(np.float64).reshape(-1)
        if w.shape[0] != R:
            out.append(Violation(
                "shape",
                f"health_weight has {w.shape[0]} entries, expected R={R}"))
        else:
            # Mirror the solver's normalization: fastest rank == 1.0,
            # degenerate all-zero weights fall back to uniform.
            wmax = float(w.max())
            w = w / wmax if wmax > 0 else np.ones(R)
            total = int(lam_e.sum())
            # tau counts the load of a hypothetical full-speed rank; with a
            # slow rank in the mix it legitimately exceeds post_max (the
            # slow rank caps at floor(tau*w) < tau) up to the whole load.
            if not (post <= tau <= max(pre, post, total)):
                out.append(Violation(
                    "threshold-bounds",
                    f"tau={tau} outside the health-weighted bound "
                    f"[post_max={post}, max(pre, post, total)="
                    f"{max(pre, post, total)}]"))
            cap = np.floor(tau * w).astype(np.int64)
            load = u.sum(axis=0)
            over = load > cap
            if over.any():
                r = int(np.argmax(load - cap))
                out.append(Violation(
                    "health-capacity",
                    f"rank {r} carries {int(load[r])} token(s) > its "
                    f"health capacity floor(tau*w)={int(cap[r])} "
                    f"(w={w[r]:.3f}): the quota table ignores the rank's "
                    "health weight"))
            quarantined = np.where(w <= 0)[0]
            for r in quarantined:
                hosted_load = int(u[:, r].sum())
                routed_in = int(q[:, :, r].sum())
                if hosted_load or routed_in:
                    out.append(Violation(
                        "health-quarantine",
                        f"rank {int(r)} is quarantined (weight 0) but "
                        f"hosts {hosted_load} token(s) of quota and "
                        f"receives {routed_in} rerouted token(s): the "
                        "rank must fully drain"))

    # --- topology tiers ---------------------------------------------------
    rack_size = None
    if topo is not None and topo.racks > 1:
        rack_size = topo.ranks_per_rack
    tier_tokens = getattr(plan, "tier_tokens", None)
    tier_replicas = getattr(plan, "tier_replicas", None)
    if rack_size is not None:
        if tier_tokens is None:
            out.append(Violation(
                "tier-accounting", "rack-aware plan carries no tier_tokens",
                severity="warn"))
        else:
            tt = _np(tier_tokens).astype(np.int64)
            want_tt = _token_tiers(q, rack_size)
            if not np.array_equal(tt, want_tt):
                out.append(Violation(
                    "tier-accounting",
                    f"tier_tokens={tt.tolist()} != reroute-matrix tiers "
                    f"{want_tt.tolist()}"))
            elif int(tt.sum()) != int(q.sum()):
                out.append(Violation(
                    "tier-accounting",
                    f"tier_tokens sums to {int(tt.sum())} but the reroute "
                    f"matrix moves {int(q.sum())} items"))
        if tier_replicas is None:
            out.append(Violation(
                "tier-accounting", "rack-aware plan carries no tier_replicas",
                severity="warn"))
        else:
            tr = _np(tier_replicas).astype(np.int64)
            want_tr = _replica_tiers(u, home, rack_size)
            if not np.array_equal(tr, want_tr):
                out.append(Violation(
                    "tier-accounting",
                    f"tier_replicas={tr.tolist()} != placement tiers "
                    f"{want_tr.tolist()}"))
        gate_tt = getattr(plan, "gate_tier_tokens", None)
        if gate_tt is not None:
            gtt = _np(gate_tt).astype(np.int64)
            if gtt.shape != (3,) or (gtt < 0).any():
                out.append(Violation(
                    "gate-tier-accounting",
                    f"gate_tier_tokens={gtt.tolist()} is not a non-negative "
                    "[local, intra, inter] triple"))
            else:
                # Dedup copies can only shrink volume: each copy in a tier
                # implies >= 1 home-routed item in the same tier, so the
                # at-gate copy counts are bounded by the home-routing item
                # tiers computed from the load matrix.
                onehot = (home[:, None] == np.arange(R)[None, :])
                q_home = (lam @ onehot.astype(np.int64))[:, None, :]  # (R,1,R)
                want_items = _token_tiers(q_home, rack_size)
                if (gtt > want_items).any():
                    out.append(Violation(
                        "gate-tier-accounting",
                        f"gate_tier_tokens={gtt.tolist()} exceeds the "
                        f"home-routing item tiers {want_items.tolist()} "
                        "(dedup copies cannot outnumber items)"))
        if rack_aware_mode is not False and not errors(out):
            actual_inter = int(_token_tiers(q, rack_size)[2])
            min_inter = _min_inter_rack_tokens(lam, u, rack_size)
            if actual_inter > min_inter:
                out.append(Violation(
                    "rack-local-optimality",
                    f"reroute carries {actual_inter} inter-rack token(s) but "
                    f"{min_inter} is achievable for this quota table "
                    "(topology-blind reroute)",
                    severity="error" if rack_aware_mode else "warn"))
    return out


def verify_rack_limit(expert_ids: Any, *, rack_limit: int, num_racks: int,
                      num_experts: int,
                      free_expert_ids: Any = None) -> list[Violation]:
    """Verify the routing-side invariant of rack-limited gating.

    ``expert_ids`` is the gate's (T, k) selection for one shard.  Checks,
    under rule id ``rack-limit``:

    * every token's selected experts span at most ``rack_limit`` distinct
      racks (experts are rack-blocked: expert ``e`` lives in rack
      ``e // (num_experts // num_racks)``, matching the contiguous home
      layout the gate's group mask assumes);
    * when ``free_expert_ids`` (the unmasked top-k selection) is supplied
      and ``rack_limit >= num_racks``, the two selections are bitwise
      identical -- rack-limited routing must reduce *exactly* to free
      routing when the limit does not bind.

    Vacuously passes when the limit is off (``rack_limit == 0`` or a
    single-rack topology).  Returns a list of violations; empty == green.
    """
    out: list[Violation] = []
    if num_racks <= 1 or rack_limit <= 0:
        return out
    if num_experts % num_racks:
        out.append(Violation(
            "rack-limit",
            f"num_experts={num_experts} not divisible by "
            f"num_racks={num_racks}: experts are not rack-blocked"))
        return out
    ids = _np(expert_ids).astype(np.int64)
    if ids.ndim != 2:
        out.append(Violation(
            "rack-limit", f"expert_ids must be (T, k), got shape {ids.shape}"))
        return out
    if ids.size and (ids.min() < 0 or ids.max() >= num_experts):
        out.append(Violation(
            "rack-limit",
            f"expert id out of range [0, {num_experts}): "
            f"[{int(ids.min())}, {int(ids.max())}]"))
        return out
    epg = num_experts // num_racks
    racks = ids // epg                                       # (T, k)
    hit = np.zeros((ids.shape[0], num_racks), dtype=bool)    # (T, G)
    np.put_along_axis(hit, racks, True, axis=1)
    spans = hit.sum(axis=1)
    limit = min(rack_limit, num_racks)
    if ids.size and int(spans.max(initial=0)) > limit:
        worst = int(np.argmax(spans))
        out.append(Violation(
            "rack-limit",
            f"token {worst} routes to {int(spans[worst])} rack(s) "
            f"{sorted(set(racks[worst].tolist()))} but rack_limit={limit} "
            f"({int((spans > limit).sum())} token(s) over the limit)"))
    if free_expert_ids is not None and rack_limit >= num_racks:
        free = _np(free_expert_ids).astype(np.int64)
        if not np.array_equal(ids, free):
            bad = int((ids != free).any(axis=-1).sum()) if (
                ids.shape == free.shape) else ids.shape[0]
            out.append(Violation(
                "rack-limit",
                f"rack_limit={rack_limit} >= num_racks={num_racks} must be "
                f"bitwise identical to free routing but {bad} token(s) "
                "differ"))
    return out


def verify_chunking(plan: Any, chunk_lam: Any, *, cap_pair: int | None = None,
                    cap_slot: int | None = None) -> list[Violation]:
    """Verify the overlap driver's per-chunk buffer invariants statically.

    The staged driver (:mod:`repro_torch.moe.stages`) dispatches a microbatch in
    token chunks sharing ONE plan, continuing each expert's occurrence index
    across chunks -- so chunk ``c``'s share of source ``s``'s expert-``e``
    items is the overlap of the occurrence interval ``[lo, hi)`` accumulated
    by chunks ``<= c`` with each destination's quota interval in ``cum_q``.
    This mirrors that routing in host numpy and checks, per chunk:

    * ``chunk-conservation`` -- the chunk loads sum to the plan's load
      (``chunk_lam.sum(0) == q.sum(dst)``) and the per-chunk routed counts
      sum to the reroute matrix (``qc.sum(0) == q``): chunking moves every
      item exactly once, to the same destination as the unchunked dispatch.
    * ``chunk-capacity`` -- every chunk's per-(src, dst) pair traffic fits
      ``cap_pair`` and every chunk's per-instance load fits ``cap_slot``.
      Because each chunk's traffic is a *subset* of the unchunked traffic,
      capacities that are drop-free unchunked stay drop-free chunked; a
      violation here means the chunk split itself would drop tokens.

    Args:
      plan: a solved :class:`repro_torch.core.planner.Plan`.
      chunk_lam: (C, R, E) per-chunk per-source per-expert load counts.
      cap_pair / cap_slot: optional static capacities to check against.
    """
    out: list[Violation] = []
    cl = _np(chunk_lam).astype(np.int64)
    q = _np(plan.q).astype(np.int64)                         # (R, E, R)
    cum_q = _np(plan.cum_q).astype(np.int64)
    if cl.ndim != 3 or cl.shape[1:] != q.shape[:2]:
        return [Violation(
            "shape", f"chunk_lam must be (C, R, E)=(C,{q.shape[0]},"
                     f"{q.shape[1]}), got {cl.shape}")]
    lam = q.sum(axis=2)                                      # (R, E)
    if not np.array_equal(cl.sum(axis=0), lam):
        bad = int(np.abs(cl.sum(axis=0) - lam).sum())
        out.append(Violation(
            "chunk-conservation",
            f"chunk loads disagree with the plan's load by {bad} token(s): "
            "the chunk split loses or invents items"))
    # Per-chunk routed counts by occurrence-interval / quota-interval overlap
    # (the numpy mirror of fused_dispatch + chunk_occ_offsets).
    hi = np.cumsum(cl, axis=0)                               # (C, R, E) incl
    lo = hi - cl
    prev = np.concatenate(
        [np.zeros_like(cum_q[..., :1]), cum_q[..., :-1]], axis=-1)
    qc = np.clip(
        np.minimum(hi[..., None], cum_q[None])
        - np.maximum(lo[..., None], prev[None]),
        0, None)                                             # (C, S, E, D)
    if not np.array_equal(qc.sum(axis=0), q):
        bad = int(np.abs(qc.sum(axis=0) - q).sum())
        out.append(Violation(
            "chunk-conservation",
            f"per-chunk routing does not sum to the reroute matrix "
            f"({bad} item(s) off): the occurrence offsets would route a "
            "chunked item to a different instance than unchunked"))
    if cap_pair is not None:
        per_pair = qc.sum(axis=2)                            # (C, S, D)
        worst = int(per_pair.max()) if per_pair.size else 0
        if worst > cap_pair:
            c, s, d = np.unravel_index(np.argmax(per_pair), per_pair.shape)
            out.append(Violation(
                "chunk-capacity",
                f"chunk {int(c)} pair ({int(s)}->{int(d)}) carries {worst} "
                f"items > cap_pair={cap_pair}: chunked dispatch would drop"))
    if cap_slot is not None:
        per_inst = qc.sum(axis=1)                            # (C, E, D)
        worst = int(per_inst.max()) if per_inst.size else 0
        if worst > cap_slot:
            c, e, d = np.unravel_index(np.argmax(per_inst), per_inst.shape)
            out.append(Violation(
                "chunk-capacity",
                f"chunk {int(c)} instance (expert {int(e)}, rank {int(d)}) "
                f"carries {worst} items > cap_slot={cap_slot}"))
    return out


def check_capacities(plan: Any, *, cap_pair: int,
                     cap_slot: int | None = None) -> list[Violation]:
    """Check static dispatch capacities against a solved plan's demand.

    ``cap_pair`` bounds the (src, dst) pair buffers of the token all_to_all;
    ``cap_slot`` bounds one physical expert slot (== one instance's quota).
    A violation means the dispatch engine would silently drop tokens at
    production rate -- exactly what rack-aware capacity sizing
    (:func:`repro_torch.moe.layer.default_capacities`) must prevent.
    """
    out: list[Violation] = []
    q = _np(plan.q).astype(np.int64)
    per_pair = q.sum(axis=1)
    worst = int(per_pair.max()) if per_pair.size else 0
    if worst > cap_pair:
        s, d = np.unravel_index(np.argmax(per_pair), per_pair.shape)
        out.append(Violation(
            "pair-capacity-overflow",
            f"pair ({int(s)}->{int(d)}) carries {worst} items > "
            f"cap_pair={cap_pair}: dispatch would drop tokens"))
    if cap_slot is not None:
        u = _np(plan.u).astype(np.int64)
        worst_u = int(u.max()) if u.size else 0
        if worst_u > cap_slot:
            e, t = np.unravel_index(np.argmax(u), u.shape)
            out.append(Violation(
                "slot-capacity-overflow",
                f"instance (expert {int(e)}, rank {int(t)}) carries "
                f"{worst_u} items > cap_slot={cap_slot}"))
    return out


def assert_plan_valid(plan: Any, topo: Any = None, **kw) -> None:
    """Raise :class:`PlanViolationError` on any error-severity violation."""
    bad = errors(verify_plan(plan, topo, **kw))
    if bad:
        raise PlanViolationError(bad)


# --------------------------------------------------------------------------
# Opt-in debug hook for repro_torch.core.balancer.solve.
# --------------------------------------------------------------------------

_STATE = {"enabled": False}


def verification_enabled() -> bool:
    return _STATE["enabled"]


@contextlib.contextmanager
def plan_verification(enabled: bool = True):
    """Context manager enabling the balancer's plan-verification hook.

    Inside the context every plan produced by
    :func:`repro_torch.core.balancer.solve` is read back and verified, and
    error-severity violations raise :class:`PlanViolationError`.  Solves
    inside a CUDA-graph capture are skipped: the hook is a debug aid, and a
    capture cannot read the device back.  The port's planner, baseline,
    rack-tier and MoE-layer tests enable it through autouse fixtures.
    """
    prev = _STATE["enabled"]
    _STATE["enabled"] = enabled
    try:
        yield
    finally:
        _STATE["enabled"] = prev


def _capturing(*arrays: Any) -> bool:
    """Whether a CUDA-graph capture is under way on the stream of a CUDA
    tensor among ``arrays`` (the reference's traced solve)."""
    return (any(isinstance(a, torch.Tensor) and a.is_cuda for a in arrays)
            and torch.cuda.is_current_stream_capturing())


def verify_solved(plan: Any, *, lam: Any, home: Any,
                  rack_size: int | None, mode: str,
                  health_weight: Any = None) -> None:
    """Balancer-side hook body: verify when enabled and concrete."""
    if not verification_enabled():
        return
    if _capturing(plan.u, plan.q, lam):
        return
    from repro_torch.core.topology import Topology

    R = int(_np(lam).shape[0])
    topo = (Topology(racks=R // rack_size, ranks_per_rack=rack_size)
            if rack_size else Topology.flat(R))
    # EPLB's round-robin reroute is documented topology-blind: keep its
    # rack-local-optimality finding at warn severity; every other mode goes
    # through the rack-local reroute tier and must meet the bound exactly
    # (DESIGN.md S10).
    rack_aware = None if mode in ("eplb", "eplb_plus") else True
    bad = errors(verify_plan(plan, topo, lam=lam, home=home,
                             rack_aware_mode=rack_aware,
                             health_weight=health_weight))
    if bad:
        raise PlanViolationError(bad)
