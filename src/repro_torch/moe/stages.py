"""Staged MoE execution: gate -> plan -> distribute -> dispatch -> compute
-> combine.

Mirrors ``repro.moe.stages`` on a flat EP group of R ranks with the fused
permutation engine, ``overlap_chunks == 1`` and no resilience ladder.  The
stage boundaries and the typed states between them are the JAX ones, and
the collectives sit at the same seams, through
:mod:`repro_torch.parallel.collectives`: the gate's ``all_gather`` of the
counts into the load matrix, the replica stream's reduce-scatter, the
dispatch and combine ``all_to_all`` (``a2a``), and the replicated mode's
final sum.  A :class:`StageCtx` carries the EP group (None for one rank).

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
from repro_torch.core.quantize import decode_wire, encode_wire, split_wire_int8
from repro_torch.moe.distribute import slot_weights
from repro_torch.moe.expert import grouped_ffn, quantize_weight_cols
from repro_torch.moe.gating import GateOut, gate
from repro_torch.moe.permute import (
    fused_bucket,
    fused_combine,
    fused_dispatch,
    fused_replicated_bucket,
    fused_replicated_combine,
    fused_unbucket,
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
    "run_staged_moe",
]

_I64 = torch.int64


class MoEStats(NamedTuple):
    drops_dispatch: torch.Tensor   # () items dropped at pair capacity
    drops_slot: torch.Tensor       # () items dropped at slot capacity
    pre_max: torch.Tensor          # () pre-balance max rank load
    post_max: torch.Tensor         # () post-balance max rank load
    max_slot_load: torch.Tensor    # () busiest physical slot occupancy
    counts: torch.Tensor           # (E,) local per-expert load


class StageCtx(NamedTuple):
    cfg: Any               # repro_torch.moe.layer.MoEConfig
    group: Any             # collectives.EPGroup of cfg.ep_size ranks, or None


class GateState(NamedTuple):
    gate_out: GateOut
    lam: torch.Tensor      # (R, E) exact per-rank per-expert load
    my: int                # this rank's EP index


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
    """Validate the (ep_size, group) pairing once, up front (mirrors
    ``repro.moe.stages.make_stage_ctx`` on a flat EP axis)."""
    if axis_name is None:
        if cfg.ep_size != 1:
            raise ValueError("axis_name=None requires ep_size == 1")
    elif axis_name.size != cfg.ep_size:
        raise ValueError(f"ep_size={cfg.ep_size} on an EP group of "
                         f"{axis_name.size} ranks")
    return StageCtx(cfg=cfg, group=axis_name)


def _exchange(ctx: StageCtx, buf: torch.Tensor) -> torch.Tensor:
    """(R, ...) destination-major buffer through the EP fabric (its own
    inverse: the return wire is the same call)."""
    return buf if ctx.group is None else collectives.all_to_all(ctx.group,
                                                                buf)


def gate_stage(ctx: StageCtx, x: torch.Tensor, router: torch.Tensor,
               router_bias: torch.Tensor | None = None) -> GateState:
    """Gate the microbatch and gather the exact EP load matrix."""
    cfg = ctx.cfg
    R = cfg.ep_size
    gate_out = gate(x, router, cfg.gating, bias=router_bias)
    counts = gate_out.counts
    if cfg.dispatch_mode == "replicated":
        # Tokens are identical on every EP rank, so the counts are already
        # the group's totals: no collective.  The load is attributed to the
        # experts' home ranks (source locality is vacuous here).
        home = cfg.layout.home(x.device)
        lam = (torch.nn.functional.one_hot(home, R).to(counts.dtype)
               * counts[:, None]).T
    elif ctx.group is not None:
        lam = collectives.all_gather(ctx.group, counts)
    else:
        lam = counts[None]
    return GateState(gate_out=gate_out, lam=lam,
                     my=0 if ctx.group is None else ctx.group.rank)


def plan_stage(ctx: StageCtx, gs: GateState) -> PlanState:
    """Solve the balancer on the full-batch load (once per microbatch).

    The load's total is at most R x tokens per rank x top-k, which the
    host knows: the solve's int32 bound on the card."""
    cfg = ctx.cfg
    layout = cfg.layout
    T, k = gs.gate_out.expert_ids.shape
    plan = balancer_mod.solve(gs.lam, layout.home(gs.lam.device),
                              cfg.balancer, load_bound=cfg.ep_size * T * k)
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


def dispatch_stage(ctx: StageCtx, x_chunk: torch.Tensor,
                   expert_ids: torch.Tensor, gs: GateState,
                   ps: PlanState) -> DispatchState:
    """Reroute one token chunk into this rank's slot buffers.

    ``replicated``: every rank holds every token and buckets its own share
    of the items (the outputs are merged by a sum after the combine);
    ``a2a``: the send buffers and their counts go through the EP fabric."""
    cfg = ctx.cfg
    num_slots = cfg.layout.slots_per_rank
    zero = torch.zeros((), dtype=_I64, device=x_chunk.device)
    if cfg.dispatch_mode == "replicated":
        rb = fused_replicated_bucket(
            x_chunk, expert_ids, ps.plan.cum_u, gs.my,
            ps.slot_of_all[gs.my], num_slots=num_slots, cap_slot=cfg.cap_slot)
        return DispatchState(xs=rb.xs, valid=rb.valid, inverse=rb,
                             drops_dispatch=zero, drops_slot=rb.drops,
                             rows=rb.rows)
    # The payload is encoded before the exchange and decoded only after
    # bucketing; routing lives in the
    # count metadata, so placement does not depend on the wire dtype.  The
    # reference encodes the send buffer; the codec works row by row and
    # maps the buffer's zero padding to zeros, so encoding the T source
    # rows before the gather gives the same bytes for a fraction of the
    # work (the buffer has cap_pair rows, 4 T k at the serve settings).
    disp = fused_dispatch(encode_wire(x_chunk, cfg.wire_dtype), expert_ids,
                          ps.plan.cum_q[gs.my], ps.slot_of_all,
                          num_slots=num_slots, cap_pair=cfg.cap_pair)
    recv_x = _exchange(ctx, disp.send_x)
    recv_c = _exchange(ctx, disp.send_counts)
    xs, valid, meta, slot_drops, rows = fused_bucket(
        recv_x, recv_c, num_slots=num_slots, cap_slot=cfg.cap_slot)
    xs_scale = None
    if cfg.wire_dtype == "int8" and cfg.ffn_dtype == "int8":
        xs, xs_scale = split_wire_int8(xs)   # codes go to the kernel as-is
    else:
        xs = decode_wire(xs, cfg.wire_dtype, x_chunk.dtype)
    return DispatchState(xs=xs, valid=valid, inverse=(disp, meta),
                         drops_dispatch=disp.drops, drops_slot=slot_drops,
                         xs_scale=xs_scale, rows=rows)


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
    if cfg.dispatch_mode == "replicated":
        return fused_replicated_combine(out, ds.inverse, weights)
    disp, meta = ds.inverse
    ret = _exchange(ctx, encode_wire(fused_unbucket(out, meta),
                                     cfg.wire_dtype))
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


def run_staged_moe(x: torch.Tensor, params, cfg, *, axis_name=None,
                   router_bias: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, MoEStats]:
    """One balanced MoE layer: gate -> plan -> distribute -> dispatch ->
    compute -> combine (+ shared expert).  Returns (y, aux_loss, stats).

    ``axis_name``: the EP group (:class:`repro_torch.parallel.collectives.
    EPGroup` of ``cfg.ep_size`` ranks), or None for one rank."""
    ctx = make_stage_ctx(cfg, axis_name)
    if _training(x, params) and (cfg.wire_dtype != "none"
                                or cfg.ffn_dtype != "none"):
        raise ValueError(f"no backward for wire_dtype={cfg.wire_dtype!r} or "
                         f"ffn_dtype={cfg.ffn_dtype!r}: train with 'none'")
    gs = gate_stage(ctx, x, params.router, router_bias)
    ps = plan_stage(ctx, gs)
    dist = distribute_stage(ctx, params, gs, ps)
    ds = dispatch_stage(ctx, x, gs.gate_out.expert_ids, gs, ps)
    out = compute_stage(ctx, ds, dist)
    y = combine_stage(ctx, ds, out, gs.gate_out.weights)
    if cfg.dispatch_mode == "replicated" and ctx.group is not None:
        # One rank-merge over the whole batch, as the reference's psum.
        y = collectives.all_reduce(ctx.group, y)
    if cfg.n_shared_experts > 0:
        y = y + swiglu(x, params.shared_w1, params.shared_w3, params.shared_w2)
    stats = MoEStats(
        drops_dispatch=ds.drops_dispatch,
        drops_slot=ds.drops_slot,
        pre_max=ps.plan.pre_max,
        post_max=ps.plan.post_max,
        max_slot_load=ds.rows.max(),
        counts=gs.gate_out.counts,
    )
    return y.to(x.dtype), gs.gate_out.aux_loss, stats
