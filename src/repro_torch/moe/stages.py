"""Staged MoE execution: gate -> plan -> distribute -> dispatch -> compute
-> combine.

Mirrors ``repro.moe.stages``: a flat EP group of R ranks (``a2a``, ``replicated``) or a factored one of racks x
lanes (``hier_a2a``, ``replicated``), the fused permutation engine or the
reference one (``dispatch_impl``), and ``overlap_chunks`` token chunks
sharing one plan.  The stage boundaries and the typed states between them
are the JAX ones, and the collectives sit at the same seams, through
:mod:`repro_torch.parallel.collectives`: the gate's gather of the counts
into the load matrix (lanes, then racks, on a factored group), the replica
stream's reduce-scatter (tiered on a factored group), the dispatch and
combine exchanges (flat ``all_to_all`` or the two-hop one), and the
replicated mode's final sum.  A :class:`StageCtx` carries the EP group
(None for one rank).

Overlap (``overlap_chunks`` C > 1, DESIGN.md S11).  Gate, plan and replica
stream run once on the whole microbatch; dispatch, FFN and combine run per
chunk of T / C tokens, and chunk i+1's dispatch, its exchanges included, is
issued before chunk i's FFN and combine.  On a group the exchange is
started with the asynchronous ``all_to_all`` and waited for only when the
chunk's FFN needs it, so on NCCL the wire runs under the previous chunk's
grouped FFN; under a gradient the same order runs the synchronous autograd
exchanges.  Per-expert occurrence offsets (:func:`chunk_occ_offsets`)
continue the global occurrence index across chunks, so every item reaches
the instance it reaches unchunked, and at zero-drop capacities the output
is the unchunked one, bit for bit (each grouped-FFN output row depends on
its row and its slot's weights only).  Drops are summed over the chunks and
``max_slot_load`` is the largest over them.

Training.  Under a gradient (grad mode on and x or a parameter requiring
one) the layer is differentiable in x, the router, the mains and the
shared expert: the gate, the permutations and the combine through their
autograd (the gate kernel's Function, gathers and sums), the exchanges
through the collectives' transposes, the grouped FFN through its backward
kernels, and the replica stream through
:func:`repro_torch.moe.distribute.slot_weights`, whose backward reduces
each replica's gradient onto its home main.  The wire codec and the w8a8
FFN have no backward: both must be "none" under a gradient.

Resilience (DESIGN.md S13).  With a :class:`Resilience` the layer runs the
reference's degraded-fabric ladder: the plan solve is health-weighted (the
live :class:`repro_torch.core.health.RankHealth` weights, honoured by
``ultraep``) and falls back to the last good plan, then to the no-balance
plan, instead of raising; the replica stream retries transient faults and
downgrades to a replica-free plan when the retries run out; dispatched
payloads and combined outputs are screened for NaN/Inf rows, which are
zeroed, dropped and counted (``MoEStats.dropped_payload_tokens``, a device
tensor, apart from the capacity drops).  Every ladder decision is made on
the host, where the step is issued, and reads nothing from the device.
Under ``torch.distributed`` each process holds its own ``Resilience``,
injector and health state: the ranks solve the same plan when they build
the same specs, advance the same steps and hold the same weights.  The
solve deadline times the host wall of the solve call; on the card the
solve is asynchronous, so it times the launch and not the kernel (as the
reference's deadline, under jit, times the trace), and no synchronisation
is added to make it time the kernel.  The reference's ``PlanViolationError``
rung waits for the port of its plan checker.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple

import torch

from repro_torch.analysis.plan_check import PlanViolationError
from repro_torch.core import balancer as balancer_mod
from repro_torch.core.layout import physical_slot_of
from repro_torch.core.planner import token_targets
from repro_torch.core.quantize import (
    decode_wire,
    encode_wire,
    payload_bytes_per_item,
    split_wire_int8,
)
from repro_torch.fault.injector import PlannerFault, SolveTimeout, TransferFault
from repro_torch.moe.dispatch import (
    bucket_by_slot,
    combine_tokens,
    dispatch_tokens,
    unbucket,
)
from repro_torch.moe.distribute import slot_weights
from repro_torch.moe.expert import grouped_ffn, quantize_weight_cols
from repro_torch.moe.gating import GateOut, gate, rack_copy_volumes
from repro_torch.moe.permute import (
    fused_bucket,
    fused_combine,
    fused_dispatch,
    fused_replicated_bucket,
    fused_replicated_combine,
    fused_unbucket,
    two_hop_all_to_all,
    two_hop_all_to_all_async,
)
from repro_torch.moe.reference import swiglu
from repro_torch.parallel import collectives

__all__ = [
    "MoEStats",
    "StageCtx",
    "GateState",
    "PlanState",
    "DistributeState",
    "DispatchState",
    "ResilienceConfig",
    "Resilience",
    "make_stage_ctx",
    "gate_stage",
    "plan_stage",
    "distribute_stage",
    "dispatch_stage",
    "compute_stage",
    "combine_stage",
    "screen_payload",
    "chunk_bounds",
    "chunk_occ_offsets",
    "run_staged_moe",
]

_I64 = torch.int64


class MoEStats(NamedTuple):
    drops_dispatch: torch.Tensor   # () items dropped at pair capacity
    drops_slot: torch.Tensor       # () items dropped at slot capacity
    pre_max: torch.Tensor          # () pre-balance max rank load
    post_max: torch.Tensor         # () post-balance max rank load
    max_slot_load: torch.Tensor    # () busiest physical slot occupancy
    #                                (the largest over overlap chunks)
    counts: torch.Tensor           # (E,) local per-expert load
    # Rack-aware plans (MoEConfig.rack_size set): token items and replica
    # instances by tier, and the one-way dispatch-wire bytes per tier (the
    # items times the wire's payload width, core.quantize).
    tier_tokens: torch.Tensor | None = None     # (3,) [local, intra, inter]
    tier_replicas: torch.Tensor | None = None   # (2,) [intra, inter]
    tier_bytes: torch.Tensor | None = None      # (3,)
    # Their at-gate twins (non-replicated modes): deduplicated payload
    # copies against the home placement, before the plan's reroute.
    gate_tier_tokens: torch.Tensor | None = None  # (3,)
    gate_tier_bytes: torch.Tensor | None = None   # (3,)
    # Resilience counters (run with a Resilience): the ladder's activations
    # in this call, the NaN/Inf payload rows screened out (apart from the
    # capacity drops above), and the quarantined ranks the plan was solved
    # under; () device tensors.
    fallback_plans: torch.Tensor | None = None
    dropped_payload_tokens: torch.Tensor | None = None
    quarantined_ranks: torch.Tensor | None = None


class StageCtx(NamedTuple):
    cfg: Any               # repro_torch.moe.layer.MoEConfig
    group: Any             # collectives.EPGroup of cfg.ep_size ranks, or None
    factored: bool = False  # a factored (rack x lane) group


class GateState(NamedTuple):
    gate_out: GateOut
    lam: torch.Tensor      # (R, E) exact per-rank per-expert load
    my: int                # this rank's EP index (rack-major when factored)
    gate_tier_tokens: torch.Tensor | None = None  # (3,) EP-global at-gate
    #   deduplicated payload copies by tier (rack-aware non-replicated modes)


class PlanState(NamedTuple):
    plan: Any                  # repro_torch.core.planner.Plan
    slot_of_all: torch.Tensor  # (R, E) physical slot of e on r, -1 not hosted


class DistributeState(NamedTuple):
    w1_all: torch.Tensor   # (num_slots, D, F)
    w3_all: torch.Tensor   # (num_slots, D, F)
    w2_all: torch.Tensor   # (num_slots, F, D)
    q8: tuple | None = None  # ffn_dtype "int8": ((codes, scales),) * 3 of
    #                          the slots, MoEParams.q8_slot_buffers()


class DispatchState(NamedTuple):
    xs: torch.Tensor       # (num_slots, cap_slot, D) slot buffers
    valid: torch.Tensor    # (num_slots, cap_slot) bool
    inverse: Any           # (FusedDispatch, BucketMeta) or ReplicatedBucket
    drops_dispatch: torch.Tensor
    drops_slot: torch.Tensor
    rows: torch.Tensor     # (num_slots,) valid rows per slot: valid is the
    #                        prefix arange(cap_slot) < rows
    xs_scale: torch.Tensor | None = None  # (num_slots, cap_slot) fp32 row
    #   scales of int8 xs when wire_dtype == ffn_dtype == "int8"


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs of the degradation ladder (mirrors
    ``repro.moe.stages.ResilienceConfig``).

    ``solve_deadline_s`` bounds the host wall time of one plan solve call;
    exceeding it is treated as a solve failure (on the card the call
    launches the solve and returns, so the deadline times the launch).
    ``max_transfer_retries`` bounds retry of *transient* transfer faults,
    each backed off by ``retry_backoff_s * 2**attempt`` seconds.
    ``screen_payloads`` switches the NaN/Inf stage-boundary screen.
    """

    solve_deadline_s: float | None = None
    max_transfer_retries: int = 2
    retry_backoff_s: float = 0.0
    screen_payloads: bool = True


class Resilience:
    """Host-side resilience state threaded through one MoE layer's stages
    (mirrors ``repro.moe.stages.Resilience``).

    Holds the fault injector (optional), the rank-health state feeding the
    planner (optional), the last-good plan cache, and the fault counters.
    The degradation ladder of :meth:`solve_with_ladder`:

        solve (health-weighted)  -- normal path; every plan is cached
          |  PlannerFault / SolveTimeout / PlanViolationError
          v
        last-good cached plan    -- stale but valid; quotas may clamp
          |  no cached plan of matching shape
          v
        no_balance_plan          -- home routing, never fails, never stalls

    ``PlanViolationError`` comes from the balancer's static plan check
    (:func:`repro_torch.analysis.plan_check.plan_verification`, off by
    default).  Every port plan is concrete, so every solved plan is cached;
    its tensors are fresh outputs of the solve that no later call writes in
    place.
    """

    def __init__(self, cfg: ResilienceConfig = ResilienceConfig(), *,
                 injector=None, health=None, layer: int | None = None):
        self.cfg = cfg
        self.injector = injector
        self.health = health
        self.layer = layer
        self.last_good = None
        self.last_error: Exception | None = None
        self.counters = {
            "fallback_plans": 0,       # ladder activations (any rung)
            "last_good_reuses": 0,     # rung 2 hits
            "no_balance_fallbacks": 0,  # rung 3 hits
            "transfer_retries": 0,     # transient transfer faults retried
            "transfer_fallbacks": 0,   # retry budget exhausted
        }

    # -- planner rung ------------------------------------------------------

    def health_weight(self, device=None) -> torch.Tensor | None:
        """(R,) float32 planner weights on ``device``, or None."""
        if self.health is None:
            return None
        return torch.as_tensor(self.health.planner_weights(),
                               dtype=torch.float32).to(device)

    def num_quarantined(self) -> int:
        return 0 if self.health is None else self.health.num_quarantined

    # -- distribute rung: live-health relay scheduling ---------------------

    def rank_speed(self):
        """(R,) live relative channel speeds for the relay schedule, or
        None: the same :meth:`RankHealth.planner_weights` vector that
        scales the plan's quotas, so replica broadcast trees route around
        degraded ranks with the signal the planner drains them by."""
        if self.health is None:
            return None
        return self.health.planner_weights()

    def relay_schedule(self, plan, expert_bytes: int, home, *,
                       relay_threshold: int = 3, topology=None):
        """The plan's replica broadcast schedule under the live speeds
        (:func:`repro_torch.core.comm_plan.build_relay_schedule`; host-side,
        reads the plan back).  ``home`` is the (E,) home map."""
        import numpy as np

        from repro_torch.core import comm_plan

        hosted = plan.hosted.T.cpu().numpy()      # (E, R) expert-major
        home = (home.cpu().numpy() if isinstance(home, torch.Tensor)
                else np.asarray(home))
        return comm_plan.build_relay_schedule(
            hosted, home, expert_bytes, relay_threshold=relay_threshold,
            topology=topology, rank_speed=self.rank_speed())

    def solve_with_ladder(self, solve_fn, lam: torch.Tensor,
                          home: torch.Tensor, n_slot: int,
                          rack_size: int | None,
                          gate_tier_tokens: torch.Tensor | None = None):
        """Run ``solve_fn`` through the ladder; always returns a plan."""
        try:
            plan = solve_fn()
        except (PlannerFault, PlanViolationError) as e:
            self.last_error = e
            self.counters["fallback_plans"] += 1
            cached = self.last_good
            if cached is not None and tuple(cached.u.shape) == (
                    lam.shape[1], lam.shape[0]):
                self.counters["last_good_reuses"] += 1
                return cached
            self.counters["no_balance_fallbacks"] += 1
            return balancer_mod.no_balance_plan(lam, home, n_slot, rack_size,
                                                gate_tier_tokens)
        self.last_good = plan
        return plan

    # -- transfer rung -----------------------------------------------------

    def guard_transfer(self) -> None:
        """Bounded retry+backoff over transient transfer faults.

        Returns normally when the transfer may proceed; re-raises the
        :class:`TransferFault` when it is permanent or the retry budget is
        exhausted (the caller then downgrades to a replica-free plan).
        """
        if self.injector is None:
            return
        attempts = self.cfg.max_transfer_retries + 1
        for attempt in range(attempts):
            try:
                self.injector.check_transfer(self.layer)
                return
            except TransferFault as e:
                self.last_error = e
                if not e.transient or attempt == attempts - 1:
                    self.counters["transfer_fallbacks"] += 1
                    raise
                self.counters["transfer_retries"] += 1
                if self.cfg.retry_backoff_s > 0:
                    time.sleep(self.cfg.retry_backoff_s * (2 ** attempt))

    def __repr__(self) -> str:
        live = {k: v for k, v in self.counters.items() if v}
        return f"Resilience(layer={self.layer}, counters={live})"


def screen_payload(xs: torch.Tensor, valid: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Drop non-finite payload rows at a stage boundary (mirrors
    ``repro.moe.stages.screen_payload``).

    Returns ``(xs, valid, n_dropped)`` where corrupted rows are zeroed AND
    invalidated.  Zeroing matters independently of the mask: a kernel that
    runs a slot's rows up to its count multiplies an invalid row like any
    other, and ``NaN * 0 == NaN``.  Integer buffers (int8 wire codes) pass
    through -- they cannot encode NaN.  ``n_dropped`` is a () device
    tensor.
    """
    if not torch.is_floating_point(xs):
        return xs, valid, torch.zeros((), dtype=_I64, device=xs.device)
    finite = torch.isfinite(xs).all(dim=-1)
    dropped = (valid & ~finite).sum()
    xs = torch.where(finite[..., None], xs, torch.zeros((), dtype=xs.dtype,
                                                        device=xs.device))
    return xs, valid & finite, dropped


def _screen_rows(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero non-finite output rows; returns ``(y, n_dropped)`` (the
    combine-side twin of :func:`screen_payload`)."""
    if not torch.is_floating_point(y):
        return y, torch.zeros((), dtype=_I64, device=y.device)
    finite = torch.isfinite(y).all(dim=-1)
    return (torch.where(finite[:, None], y,
                        torch.zeros((), dtype=y.dtype, device=y.device)),
            (~finite).sum())


def make_stage_ctx(cfg, axis_name) -> StageCtx:
    """Validate the (dispatch_mode, group) pairing once, up front (mirrors
    ``repro.moe.stages.make_stage_ctx``): ``a2a`` runs on a flat group,
    ``hier_a2a`` on a factored one of ``cfg.racks`` racks (or none at one
    rank), ``replicated`` on either."""
    factored = False
    if axis_name is None:
        if cfg.ep_size != 1:
            raise ValueError("axis_name=None requires ep_size == 1")
    else:
        if axis_name.size != cfg.ep_size:
            raise ValueError(f"ep_size={cfg.ep_size} on an EP group of "
                             f"{axis_name.size} ranks")
        factored = axis_name.factored
        if factored:
            if cfg.dispatch_mode == "a2a":
                raise ValueError(
                    "dispatch_mode='a2a' runs on a flat EP group; use "
                    "'hier_a2a' on a factored (rack, lane) group")
            if axis_name.racks != cfg.racks:
                raise ValueError(f"racks={cfg.racks} on a group factored "
                                 f"into {axis_name.racks} racks")
        elif cfg.dispatch_mode == "hier_a2a":
            raise ValueError(
                "dispatch_mode='hier_a2a' needs a factored (rack, lane) EP "
                "group (collectives.factor), or None when ep_size == 1")
    return StageCtx(cfg=cfg, group=axis_name, factored=factored)


def _exchange(ctx: StageCtx, buf: torch.Tensor, *,
              reverse: bool = False) -> torch.Tensor:
    """(R, ...) destination-major buffer through the EP fabric: the flat
    ``all_to_all`` (its own inverse) or the two-hop one (``reverse`` on the
    return wire)."""
    if ctx.group is None:
        return buf
    if ctx.factored:
        return two_hop_all_to_all(buf, ctx.group, reverse=reverse)
    return collectives.all_to_all(ctx.group, buf)


class _Done:
    """A finished exchange, with the handle's ``wait()``."""

    def __init__(self, out: torch.Tensor):
        self._out = out

    def wait(self) -> torch.Tensor:
        return self._out


def _exchange_start(ctx: StageCtx, buf: torch.Tensor, *, asynchronous: bool):
    """:func:`_exchange`, started: a handle whose ``wait()`` gives the
    result.  ``asynchronous`` (no gradient) starts the (first hop's)
    ``all_to_all`` without waiting; otherwise the exchange runs now."""
    if ctx.group is None or not asynchronous:
        return _Done(_exchange(ctx, buf))
    if ctx.factored:
        return two_hop_all_to_all_async(buf, ctx.group)
    return collectives.all_to_all_async(ctx.group, buf)


def _group_sum(ctx: StageCtx, x: torch.Tensor) -> torch.Tensor:
    """The sum over the group (``psum``): lanes, then racks, when
    factored."""
    if ctx.factored:
        return collectives.all_reduce(
            ctx.group.rack, collectives.all_reduce(ctx.group.lane, x))
    return collectives.all_reduce(ctx.group, x)


def gate_stage(ctx: StageCtx, x: torch.Tensor, router: torch.Tensor,
               router_bias: torch.Tensor | None = None) -> GateState:
    """Gate the microbatch and gather the exact EP load matrix."""
    cfg = ctx.cfg
    R = cfg.ep_size
    gate_out = gate(x, router, cfg.gating, bias=router_bias)
    counts = gate_out.counts
    my = 0 if ctx.group is None else ctx.group.rank
    if cfg.dispatch_mode == "replicated":
        # Tokens are identical on every EP rank, so the counts are already
        # the group's totals: no collective.  The load is attributed to the
        # experts' home ranks (source locality is vacuous here).
        home = cfg.layout.home(x.device)
        lam = (torch.nn.functional.one_hot(home, R).to(counts.dtype)
               * counts[:, None]).T
    elif ctx.factored:
        # Lanes first, then racks: rack-major rows, the global rank order.
        lam = collectives.all_gather(
            ctx.group.rack, collectives.all_gather(ctx.group.lane, counts)
        ).reshape(R, -1)
    elif ctx.group is not None:
        lam = collectives.all_gather(ctx.group, counts)
    else:
        lam = counts[None]
    gate_tiers = None
    if cfg.rack_size is not None and cfg.dispatch_mode != "replicated":
        # At-gate tier accounting (DESIGN.md S14): this rank's deduplicated
        # payload copies against the home placement, summed over the group.
        gate_tiers = rack_copy_volumes(
            gate_out.expert_ids, cfg.layout.home(x.device), num_ranks=R,
            rack_size=cfg.rack_size, src_rank=my)
        if ctx.group is not None:
            gate_tiers = _group_sum(ctx, gate_tiers)
    return GateState(gate_out=gate_out, lam=lam, my=my,
                     gate_tier_tokens=gate_tiers)


def plan_stage(ctx: StageCtx, gs: GateState, *,
               lam_e_est: torch.Tensor | None = None,
               resilience: Resilience | None = None) -> PlanState:
    """Solve the balancer on the full-batch load (once per microbatch):
    rack-aware with ``cfg.rack_size``, with the demand tie-break where the
    gate's rack limit binds, the gate's tier volumes stamped on the plan;
    ``lam_e_est`` feeds the ``eplb`` mode's stale estimate.

    With ``resilience`` the solve is health-weighted and runs through the
    degradation ladder: an injected or real :class:`PlannerFault`, a
    deadline overrun or (with plan verification on) a
    :class:`PlanViolationError` falls back to the last good plan, then to
    the no-balance plan; the stage never raises for them.

    The load's total is at most R x tokens per rank x top-k, which the
    host knows: the solve's int32 bound on the card."""
    cfg = ctx.cfg
    layout = cfg.layout
    T, k = gs.gate_out.expert_ids.shape
    home = layout.home(gs.lam.device)
    res = resilience
    health_weight = None if res is None else res.health_weight(gs.lam.device)

    def solve():
        if res is not None and res.injector is not None:
            res.injector.check_solve(res.layer)
        t0 = time.monotonic()
        plan = balancer_mod.solve(gs.lam, home, cfg.balancer,
                                  lam_e_est=lam_e_est,
                                  rack_size=cfg.rack_size,
                                  health_weight=health_weight,
                                  demand_tiebreak=cfg.gating.rack_binding,
                                  gate_tier_tokens=gs.gate_tier_tokens,
                                  load_bound=cfg.ep_size * T * k)
        deadline = None if res is None else res.cfg.solve_deadline_s
        if deadline is not None and time.monotonic() - t0 > deadline:
            raise SolveTimeout(f"plan solve exceeded {deadline}s deadline")
        return plan

    if res is None:
        plan = solve()
    else:
        plan = res.solve_with_ladder(solve, gs.lam, home, cfg.balancer.n_slot,
                                     cfg.rack_size, gs.gate_tier_tokens)
    return PlanState(plan=plan, slot_of_all=physical_slot_of(layout, plan.x))


def _training(x: torch.Tensor, params) -> bool:
    """True under a gradient: grad mode on and x or a parameter of the
    layer requiring one."""
    return torch.is_grad_enabled() and (x.requires_grad or any(
        p.requires_grad for p in params.parameters()))


def distribute_stage(ctx: StageCtx, params, gs: GateState,
                     ps: PlanState, *, corrupt=None) -> DistributeState:
    """Main + replica weights per physical slot.

    The JAX stage concatenates mains and replicas into fresh arrays, a copy
    of every expert weight per call, and its w8a8 FFN quantizes every slot
    on every call.  Here ``params`` owns one slot buffer per weight whose
    head rows *are* the mains, and int8 slot buffers whose head rows are
    the mains' codes; only the replica tails are written, in place (see
    ``repro_torch.moe.layer.MoEParams``).  Quantization is independent per
    slot, so the codes are those the reference computes.  The buffers come
    back through :func:`slot_weights`, differentiable in the mains.
    ``corrupt``, if given, maps w1's streamed replica rows to what arrived
    (the ``transfer_corrupt`` fault): w1's slots then come back as a new
    tensor, the slot buffer untouched.
    """
    cfg = ctx.cfg
    n_main = cfg.layout.experts_per_rank
    slots = params.slot_buffers()
    ws = slot_weights((params.w1, params.w3, params.w2), slots, ps.plan.x,
                      gs.my, ctx.group, n_chunks=cfg.distribute_chunks,
                      wire_dtype=cfg.wire_dtype)
    if corrupt is not None:
        tail = ws[0][n_main:]
        w1r = corrupt(tail)
        if w1r is not tail:
            ws = (torch.cat([ws[0][:n_main], w1r]),) + tuple(ws[1:])
    q8 = None
    if cfg.ffn_dtype == "int8":
        q8 = params.q8_slot_buffers()
        for (codes, scales), w_all in zip(q8, ws):
            c, s = quantize_weight_cols(w_all[n_main:])
            codes[n_main:].copy_(c)
            scales[n_main:].copy_(s)
    return DistributeState(*ws, q8=q8)


def _distribute_with_ladder(ctx: StageCtx, params, gs: GateState,
                            ps: PlanState, res: Resilience | None
                            ) -> tuple[PlanState, DistributeState]:
    """Replica streaming under the ladder (mirrors
    ``repro.moe.stages._distribute_with_ladder``): retry transients, else
    downgrade to the no-balance plan, which needs no transfer at all,
    rather than dispatch tokens to replicas whose weights never arrived.
    Injected replica corruption (``transfer_corrupt``) is applied to w1's
    streamed slots only; the combine-side screen catches its NaN outputs.
    """
    if res is None:
        return ps, distribute_stage(ctx, params, gs, ps)
    cfg = ctx.cfg
    try:
        res.guard_transfer()
    except TransferFault:
        res.counters["fallback_plans"] += 1
        plan = balancer_mod.no_balance_plan(
            gs.lam, cfg.layout.home(gs.lam.device), cfg.balancer.n_slot,
            cfg.rack_size, gs.gate_tier_tokens)
        ps = PlanState(plan=plan,
                       slot_of_all=physical_slot_of(cfg.layout, plan.x))
    corrupt = None
    if res.injector is not None:
        def corrupt(w):
            return res.injector.corrupt_replicas(w, res.layer)
    return ps, distribute_stage(ctx, params, gs, ps, corrupt=corrupt)


class _Pending(NamedTuple):
    """A chunk's dispatch with its exchanges started (fused ``a2a`` /
    ``hier_a2a``); :func:`_dispatch_finish` waits and buckets."""

    disp: Any              # FusedDispatch
    recv_x: Any            # exchange handles
    recv_c: Any
    dtype: torch.dtype     # the activations' dtype (the wire decodes to it)


def _dispatch_start(ctx: StageCtx, x_chunk: torch.Tensor,
                    expert_ids: torch.Tensor, gs: GateState, ps: PlanState, *,
                    occ_offset: torch.Tensor | None = None,
                    asynchronous: bool = False):
    """The first half of :func:`dispatch_stage`: everything up to the
    exchanges, which it starts.  Returns a :class:`DispatchState` where
    the mode has no exchange to wait for, else a :class:`_Pending`."""
    cfg = ctx.cfg
    num_slots = cfg.layout.slots_per_rank
    zero = torch.zeros((), dtype=_I64, device=x_chunk.device)
    if cfg.dispatch_mode == "replicated":
        slot_of = ps.slot_of_all[gs.my]
        if cfg.dispatch_impl == "fused":
            rb = fused_replicated_bucket(
                x_chunk, expert_ids, ps.plan.cum_u, gs.my, slot_of,
                num_slots=num_slots, cap_slot=cfg.cap_slot,
                occ_offset=occ_offset)
            return DispatchState(xs=rb.xs, valid=rb.valid, inverse=rb,
                                 drops_dispatch=zero, drops_slot=rb.drops,
                                 rows=rb.rows)
        # Reference: the item's owner by the quota lookup on u (one
        # source), this rank's items bucketed by the second sort.
        items_e = expert_ids.reshape(-1).to(_I64)
        mine = token_targets(items_e, ps.plan.u) == gs.my
        recv_e = torch.where(mine, items_e, -1)[None, :]
        recv_x = x_chunk.repeat_interleave(expert_ids.shape[1], dim=0)[None]
        xs, valid, back_idx, slot_drops = bucket_by_slot(
            recv_x, recv_e, slot_of, num_slots=num_slots,
            cap_slot=cfg.cap_slot)
        return DispatchState(xs=xs, valid=valid, inverse=back_idx,
                             drops_dispatch=zero, drops_slot=slot_drops,
                             rows=valid.sum(dim=1))
    if cfg.dispatch_impl == "reference":
        # The multi-sort scatter path (the equivalence oracle; flat EP).
        disp = dispatch_tokens(x_chunk, expert_ids, ps.plan.q[gs.my],
                               cap_pair=cfg.cap_pair)
        recv_x = _exchange(ctx, disp.send_x)
        recv_e = _exchange(ctx, disp.send_e)
        xs, valid, back_idx, slot_drops = bucket_by_slot(
            recv_x, recv_e, ps.slot_of_all[gs.my], num_slots=num_slots,
            cap_slot=cfg.cap_slot)
        return DispatchState(xs=xs, valid=valid, inverse=(disp, back_idx),
                             drops_dispatch=disp.drops, drops_slot=slot_drops,
                             rows=valid.sum(dim=1))
    # The payload is encoded before the exchange and decoded only after
    # bucketing; routing lives in the
    # count metadata, so placement does not depend on the wire dtype.  The
    # reference encodes the send buffer; the codec works row by row and
    # maps the buffer's zero padding to zeros, so encoding the T source
    # rows before the gather gives the same bytes for a fraction of the
    # work (the buffer has cap_pair rows, 4 T k at the serve settings).
    # On a factored group the same buffers and their count metadata ride
    # the two-hop exchange.
    disp = fused_dispatch(encode_wire(x_chunk, cfg.wire_dtype), expert_ids,
                          ps.plan.cum_q[gs.my], ps.slot_of_all,
                          num_slots=num_slots, cap_pair=cfg.cap_pair,
                          occ_offset=occ_offset)
    recv_x = _exchange_start(ctx, disp.send_x, asynchronous=asynchronous)
    recv_c = _exchange_start(ctx, disp.send_counts, asynchronous=asynchronous)
    # The combine needs the items' places only: the send buffers go once
    # the exchanges hold them.
    return _Pending(disp=disp._replace(send_x=None, send_counts=None),
                    recv_x=recv_x, recv_c=recv_c, dtype=x_chunk.dtype)


def _dispatch_finish(ctx: StageCtx, pending) -> DispatchState:
    """The second half of :func:`dispatch_stage`: wait for the exchanges,
    bucket by slot and decode the wire."""
    if isinstance(pending, DispatchState):
        return pending
    cfg = ctx.cfg
    recv_x = pending.recv_x.wait()
    recv_c = pending.recv_c.wait()
    xs, valid, meta, slot_drops, rows = fused_bucket(
        recv_x, recv_c, num_slots=cfg.layout.slots_per_rank,
        cap_slot=cfg.cap_slot)
    xs_scale = None
    if cfg.wire_dtype == "int8" and cfg.ffn_dtype == "int8":
        xs, xs_scale = split_wire_int8(xs)   # codes go to the kernel as-is
    else:
        xs = decode_wire(xs, cfg.wire_dtype, pending.dtype)
    return DispatchState(xs=xs, valid=valid, inverse=(pending.disp, meta),
                         drops_dispatch=pending.disp.drops,
                         drops_slot=slot_drops, xs_scale=xs_scale, rows=rows)


def dispatch_stage(ctx: StageCtx, x_chunk: torch.Tensor,
                   expert_ids: torch.Tensor, gs: GateState, ps: PlanState, *,
                   occ_offset: torch.Tensor | None = None) -> DispatchState:
    """Reroute one token chunk into this rank's slot buffers.

    ``replicated``: every rank holds every token and buckets its own share
    of the items (the outputs are merged by a sum after the combine);
    ``a2a`` / ``hier_a2a``: the send buffers and their counts (the
    reference engine: their expert ids) go through the EP fabric.
    ``occ_offset`` (E,) continues the occurrence index of earlier chunks
    (:func:`chunk_occ_offsets`)."""
    return _dispatch_finish(ctx, _dispatch_start(
        ctx, x_chunk, expert_ids, gs, ps, occ_offset=occ_offset))


def compute_stage(ctx: StageCtx, ds: DispatchState,
                  dist: DistributeState) -> torch.Tensor:
    """Grouped FFN over this rank's physical slots (two kernels, fp or
    w8a8); the kernels skip each slot's padded rows on the device."""
    return grouped_ffn(ds.xs, ds.valid, dist.w1_all, dist.w3_all, dist.w2_all,
                       ffn_dtype=ctx.cfg.ffn_dtype, xs_scale=ds.xs_scale,
                       wq=dist.q8, rows=ds.rows,
                       plain_backward=ctx.cfg.plain_backward)


def combine_stage(ctx: StageCtx, ds: DispatchState, out: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Route FFN outputs back and reduce each token's k contributions.

    The return wire carries the forward wire's codec; the replicated mode
    has no exchange and no codec, as in the reference, and returns this
    rank's share (run_staged_moe sums the ranks' shares).
    """
    cfg = ctx.cfg
    D = out.shape[-1]
    if cfg.dispatch_mode == "replicated":
        if cfg.dispatch_impl == "fused":
            return fused_replicated_combine(out, ds.inverse, weights)
        Tc, k = weights.shape
        ret = unbucket(out, ds.valid, ds.inverse, (1, Tc * k, D))[0]
        vals = (ret * weights.reshape(-1, 1).to(ret.dtype)).reshape(Tc, k, D)
        y = torch.zeros((Tc, D), dtype=ret.dtype, device=ret.device)
        for i in range(k):
            y = y + vals[:, i]
        return y
    if cfg.dispatch_impl == "reference":
        disp, back_idx = ds.inverse
        ret = unbucket(out, ds.valid, back_idx, (cfg.ep_size, cfg.cap_pair, D))
        return combine_tokens(_exchange(ctx, ret), disp, weights,
                              weights.shape[0])
    disp, meta = ds.inverse
    ret = _exchange(ctx, encode_wire(fused_unbucket(out, meta),
                                     cfg.wire_dtype), reverse=True)
    return fused_combine(decode_wire(ret, cfg.wire_dtype, out.dtype), disp,
                         weights)


def chunk_bounds(total: int, *, n_chunks: int | None = None,
                 chunk_size: int | None = None) -> list[tuple[int, int]]:
    """(start, length) spans covering ``[0, total)``, in order.

    Exactly one of ``n_chunks`` (equal split; must divide ``total``) or
    ``chunk_size`` (fixed-size spans, ragged tail) must be given.
    """
    if (n_chunks is None) == (chunk_size is None):
        raise ValueError("pass exactly one of n_chunks / chunk_size")
    if n_chunks is not None:
        if n_chunks < 1 or total % n_chunks != 0:
            raise ValueError(
                f"n_chunks={n_chunks} must be >= 1 and divide total={total}")
        size = total // n_chunks
        return [(i * size, size) for i in range(n_chunks)]
    if chunk_size < 1:
        raise ValueError(f"chunk_size={chunk_size} must be >= 1")
    return [(s, min(chunk_size, total - s)) for s in range(0, total, chunk_size)]


def chunk_occ_offsets(expert_ids: torch.Tensor, n_chunks: int,
                      num_experts: int) -> torch.Tensor:
    """(C, E) per-chunk occurrence offsets continuing the global index
    (mirrors ``repro.moe.stages.chunk_occ_offsets``): chunk c's offset of
    expert e is the number of e-items in chunks < c, the exclusive cumsum
    of the chunks' expert histograms."""
    ec = expert_ids.reshape(n_chunks, -1).to(_I64)              # (C, Tc*k)
    hist = torch.zeros((n_chunks, num_experts), dtype=_I64,
                       device=ec.device).scatter_add_(1, ec,
                                                      torch.ones_like(ec))
    return torch.cumsum(hist, dim=0) - hist


def run_staged_moe(x: torch.Tensor, params, cfg, *, axis_name=None,
                   router_bias: torch.Tensor | None = None,
                   lam_e_est: torch.Tensor | None = None,
                   resilience: Resilience | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, MoEStats]:
    """One balanced MoE layer: gate -> plan -> distribute once on the
    microbatch, then dispatch -> compute -> combine per overlap chunk
    (+ shared expert).  Returns (y, aux_loss, stats).

    ``axis_name``: the EP group (:class:`repro_torch.parallel.collectives.
    EPGroup` of ``cfg.ep_size`` ranks, factored for ``hier_a2a``), or None
    for one rank.  ``lam_e_est``: the ``eplb`` mode's stale per-expert load
    estimate.  ``resilience``: the degradation ladder, payload screening
    and the fault counters (the module's notes)."""
    ctx = make_stage_ctx(cfg, axis_name)
    training = _training(x, params)
    if training and (cfg.wire_dtype != "none" or cfg.ffn_dtype != "none"):
        raise ValueError(f"no backward for wire_dtype={cfg.wire_dtype!r} or "
                         f"ffn_dtype={cfg.ffn_dtype!r}: train with 'none'")
    T, D = x.shape
    C = cfg.overlap_chunks
    if T % C != 0:
        raise ValueError(f"overlap_chunks={C} must divide the local token "
                         f"count T={T}")
    res = resilience
    fallback_before = 0 if res is None else res.counters["fallback_plans"]
    gs = gate_stage(ctx, x, params.router, router_bias)
    ps = plan_stage(ctx, gs, lam_e_est=lam_e_est, resilience=res)
    ps, dist = _distribute_with_ladder(ctx, params, gs, ps, res)
    screening = res is not None and res.cfg.screen_payloads
    corrupting = res is not None and res.injector is not None
    ids, weights = gs.gate_out.expert_ids, gs.gate_out.weights
    bounds = chunk_bounds(T, n_chunks=C)
    offsets = (chunk_occ_offsets(ids, C, cfg.gating.num_experts) if C > 1
               else None)

    def start(i):
        s, n = bounds[i]
        return _dispatch_start(
            ctx, x[s:s + n], ids[s:s + n], gs, ps,
            occ_offset=None if offsets is None else offsets[i],
            asynchronous=C > 1 and not training)

    ys = []
    drops_dispatch = drops_slot = max_slot_load = None
    dropped_payload = torch.zeros((), dtype=_I64, device=x.device)
    pending = start(0)
    for i in range(C):
        # Chunk i's buffers, then chunk i+1's exchange started before
        # chunk i's FFN and combine.
        ds = _dispatch_finish(ctx, pending)
        pending = start(i + 1) if i + 1 < C else None
        if corrupting:
            ds = ds._replace(xs=res.injector.corrupt_payload(ds.xs,
                                                             res.layer))
        if screening:
            # Screened rows are zeroed and leave the valid mask; the
            # kernels still run each slot to its count (a zero row gives a
            # zero output row), so the row counts stay.
            xs, valid, n_bad = screen_payload(ds.xs, ds.valid)
            ds = ds._replace(xs=xs, valid=valid)
            dropped_payload = dropped_payload + n_bad
        out = compute_stage(ctx, ds, dist)
        s, n = bounds[i]
        y_chunk = combine_stage(ctx, ds, out, weights[s:s + n])
        if screening:
            y_chunk, n_bad = _screen_rows(y_chunk)
            dropped_payload = dropped_payload + n_bad
        ys.append(y_chunk)
        load = ds.valid.sum(dim=1).max() if screening else ds.rows.max()
        if i == 0:
            drops_dispatch, drops_slot = ds.drops_dispatch, ds.drops_slot
            max_slot_load = load
        else:
            drops_dispatch = drops_dispatch + ds.drops_dispatch
            drops_slot = drops_slot + ds.drops_slot
            max_slot_load = torch.maximum(max_slot_load, load)
    y = ys[0] if C == 1 else torch.cat(ys, dim=0)
    if cfg.dispatch_mode == "replicated" and ctx.group is not None:
        # One rank-merge over the whole batch, as the reference's psum.
        y = _group_sum(ctx, y)
    if cfg.n_shared_experts > 0:
        y = y + swiglu(x, params.shared_w1, params.shared_w3, params.shared_w2)
    plan = ps.plan
    width = payload_bytes_per_item(D, cfg.wire_dtype,
                                   base_bytes=x.element_size())
    fallbacks = quarantined = None
    if res is not None:
        # Host counts as () device tensors: a fill, no copy and no read.
        fallbacks = torch.full((), res.counters["fallback_plans"]
                               - fallback_before, dtype=_I64, device=x.device)
        quarantined = torch.full((), res.num_quarantined(), dtype=_I64,
                                 device=x.device)
    stats = MoEStats(
        drops_dispatch=drops_dispatch,
        drops_slot=drops_slot,
        pre_max=plan.pre_max,
        post_max=plan.post_max,
        max_slot_load=max_slot_load,
        counts=gs.gate_out.counts,
        tier_tokens=plan.tier_tokens,
        tier_replicas=plan.tier_replicas,
        tier_bytes=(None if plan.tier_tokens is None
                    else plan.tier_tokens * width),
        gate_tier_tokens=plan.gate_tier_tokens,
        gate_tier_bytes=(None if plan.gate_tier_tokens is None
                         else plan.gate_tier_tokens * width),
        fallback_plans=fallbacks,
        dropped_payload_tokens=dropped_payload if res is not None else None,
        quarantined_ranks=quarantined,
    )
    return y.to(x.dtype), gs.gate_out.aux_loss, stats
