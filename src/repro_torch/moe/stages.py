"""Staged MoE execution: gate -> plan -> distribute -> dispatch -> compute
-> combine.

Mirrors ``repro.moe.stages`` without the resilience ladder: a flat EP
group of R ranks (``a2a``, ``replicated``) or a factored one of racks x
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
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import balancer as balancer_mod
from repro_torch.core.layout import physical_slot_of
from repro_torch.core.planner import token_targets
from repro_torch.core.quantize import (
    decode_wire,
    encode_wire,
    payload_bytes_per_item,
    split_wire_int8,
)
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
    "make_stage_ctx",
    "gate_stage",
    "plan_stage",
    "distribute_stage",
    "dispatch_stage",
    "compute_stage",
    "combine_stage",
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


def plan_stage(ctx: StageCtx, gs: GateState) -> PlanState:
    """Solve the balancer on the full-batch load (once per microbatch):
    rack-aware with ``cfg.rack_size``, with the demand tie-break where the
    gate's rack limit binds, the gate's tier volumes stamped on the plan.

    The load's total is at most R x tokens per rank x top-k, which the
    host knows: the solve's int32 bound on the card."""
    cfg = ctx.cfg
    layout = cfg.layout
    T, k = gs.gate_out.expert_ids.shape
    plan = balancer_mod.solve(gs.lam, layout.home(gs.lam.device),
                              cfg.balancer, rack_size=cfg.rack_size,
                              demand_tiebreak=cfg.gating.rack_binding,
                              gate_tier_tokens=gs.gate_tier_tokens,
                              load_bound=cfg.ep_size * T * k)
    return PlanState(plan=plan, slot_of_all=physical_slot_of(layout, plan.x))


def _training(x: torch.Tensor, params) -> bool:
    """True under a gradient: grad mode on and x or a parameter of the
    layer requiring one."""
    return torch.is_grad_enabled() and (x.requires_grad or any(
        p.requires_grad for p in params.parameters()))


def distribute_stage(ctx: StageCtx, params, gs: GateState,
                     ps: PlanState) -> DistributeState:
    """Main + replica weights per physical slot.

    The JAX stage concatenates mains and replicas into fresh arrays, a copy
    of every expert weight per call, and its w8a8 FFN quantizes every slot
    on every call.  Here ``params`` owns one slot buffer per weight whose
    head rows *are* the mains, and int8 slot buffers whose head rows are
    the mains' codes; only the replica tails are written, in place (see
    ``repro_torch.moe.layer.MoEParams``).  Quantization is independent per
    slot, so the codes are those the reference computes.  The buffers come
    back through :func:`slot_weights`, differentiable in the mains.
    """
    cfg = ctx.cfg
    n_main = cfg.layout.experts_per_rank
    slots = params.slot_buffers()
    ws = slot_weights((params.w1, params.w3, params.w2), slots, ps.plan.x,
                      gs.my, ctx.group, n_chunks=cfg.distribute_chunks,
                      wire_dtype=cfg.wire_dtype)
    q8 = None
    if cfg.ffn_dtype == "int8":
        q8 = params.q8_slot_buffers()
        for (codes, scales), w_all in zip(q8, slots):
            c, s = quantize_weight_cols(w_all[n_main:])
            codes[n_main:].copy_(c)
            scales[n_main:].copy_(s)
    return DistributeState(*ws, q8=q8)


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
                   router_bias: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, MoEStats]:
    """One balanced MoE layer: gate -> plan -> distribute once on the
    microbatch, then dispatch -> compute -> combine per overlap chunk
    (+ shared expert).  Returns (y, aux_loss, stats).

    ``axis_name``: the EP group (:class:`repro_torch.parallel.collectives.
    EPGroup` of ``cfg.ep_size`` ranks, factored for ``hier_a2a``), or None
    for one rank."""
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
    gs = gate_stage(ctx, x, params.router, router_bias)
    ps = plan_stage(ctx, gs)
    dist = distribute_stage(ctx, params, gs, ps)
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
    pending = start(0)
    for i in range(C):
        # Chunk i's buffers, then chunk i+1's exchange started before
        # chunk i's FFN and combine.
        ds = _dispatch_finish(ctx, pending)
        pending = start(i + 1) if i + 1 < C else None
        out = compute_stage(ctx, ds, dist)
        s, n = bounds[i]
        ys.append(combine_stage(ctx, ds, out, weights[s:s + n]))
        load = ds.rows.max()
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
    )
    return y.to(x.dtype), gs.gate_out.aux_loss, stats
