"""Fused single-sort permutation engine for MoE dispatch (DESIGN.md S2).

Mirrors ``repro.moe.permute``: the occurrence
index is a histogram cumsum (no sort), one stable sort of the packed
``dst * (S+1) + slot`` key groups items by destination rank and slot, send
buffers and slot buffers are gathers from the saved permutation, and the
receiver rebuilds its slot layout from a tiny per-(src, slot) count matrix.
Integer outputs and gathered buffers are bitwise those of the JAX engine.

On a two-level (rack x lane) group the same destination-major buffers ride
:func:`two_hop_all_to_all`: destination ranks are rack-major, so the packed
key is already the ``(rack, lane, slot)`` key, and the flat exchange
becomes an inter-rack hop of rack-aggregated payloads followed by an
intra-rack scatter (DESIGN.md S9), bit for bit the flat result.

Dtype notes: indices are int64 (PyTorch's indexing type);
``jnp.searchsorted(side=)`` is ``torch.searchsorted(right=)`` and the
stable ``jnp.argsort`` is ``torch.sort(stable=True)``.

Gradients flow to the tokens and the combine weights through the gathers
(:func:`gather_rows`, whose backward sums each row's gradients in the
order of their positions, skipping the invalid ones) and the weighted
sums, as autograd differentiates the reference's gathers.  No sum on the
path depends on the order in which the card runs its threads, so a train
step gives the same bits on every run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.planner import token_targets
from repro_torch.parallel import collectives

__all__ = [
    "FusedDispatch",
    "BucketMeta",
    "ReplicatedBucket",
    "occurrence_by_histogram",
    "fused_dispatch",
    "fused_bucket",
    "fused_unbucket",
    "fused_combine",
    "fused_replicated_bucket",
    "fused_replicated_combine",
    "gather_rows",
    "ordered_row_sum",
    "two_hop_all_to_all",
    "two_hop_all_to_all_async",
]

_I64 = torch.int64


class FusedDispatch(NamedTuple):
    """Source-side dispatch state: send buffers + saved permutation inverse."""

    send_x: torch.Tensor       # (R, cap_pair, D) slot-sorted send buffers
    send_counts: torch.Tensor  # (R, S+1) kept items per (dst, dst-slot)
    item_dst: torch.Tensor     # (N,) destination rank per item (-1 dropped)
    item_pos: torch.Tensor     # (N,) position within the (src, dst) buffer
    item_kept: torch.Tensor    # (N,) bool, False = dropped at pair capacity
    drops: torch.Tensor        # () items dropped at pair capacity


class BucketMeta(NamedTuple):
    """Receiver-side inverse map: receive position -> slot-buffer position."""

    slot: torch.Tensor   # (R, cap_pair) slot of each receive position
    pos: torch.Tensor    # (R, cap_pair) row within that slot buffer
    valid: torch.Tensor  # (R, cap_pair) bool


class ReplicatedBucket(NamedTuple):
    """Replicated-mode bucket state: this rank's share of the shared items."""

    xs: torch.Tensor         # (num_slots, cap_slot, D) slot buffers
    valid: torch.Tensor      # (num_slots, cap_slot) bool
    item_slot: torch.Tensor  # (N,) slot of each item on this rank (sentinel S)
    item_pos: torch.Tensor   # (N,) row within that slot buffer
    item_ok: torch.Tensor    # (N,) bool: mine, hosted and within capacity
    drops: torch.Tensor      # () of *my* items dropped
    rows: torch.Tensor       # (num_slots,): valid = arange(cap) < rows


def gather_rows(x: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor, *,
                copies: int) -> torch.Tensor:
    """``where(valid, x[idx], 0)``: rows of ``x`` (n, ...) at ``idx`` (any
    shape) where ``valid``, zeros elsewhere.  ``copies`` is the caller's
    bound on how many valid positions read one row of ``x``, known without
    reading the device (a token's top-k, or 1 where the valid positions
    are distinct).

    Under a gradient the backward is :func:`ordered_row_sum` of the valid
    positions' gradients: each row of ``x`` gets its contributions added
    from zeros in increasing position order, in ``copies`` gathers, so the
    sum is the same bits on every run.  An ``index_add_`` on a CUDA tensor
    adds with atomics in no fixed order, which changes the bits once a row
    has more than two contributions; autograd's backward of ``x[idx]``
    would sort the indices and sum each row's duplicates one after
    another, and the padded positions of a capacity buffer all point at
    one row (at GLM-4.5-Air's train step, 262,144 send positions, ~196k of
    them padding, that took 0.4 s of an H100 step)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, idx, valid, copies)
    return torch.where(valid[(...,) + (None,) * (x.dim() - 1)], x[idx],
                       _zeros_like_scalar(x))


def ordered_row_sum(vals: torch.Tensor, idx: torch.Tensor,
                    valid: torch.Tensor, n: int, copies: int
                    ) -> torch.Tensor:
    """(n, ...) sums of ``vals`` (P, ...) by row: ``out[r]`` is zeros plus
    ``vals[p]`` for every valid position p with ``idx[p] == r``, added one
    after another in increasing p, in ``vals``' dtype.  At most ``copies``
    valid positions may share a row (the caller's bound: contributions
    past it are not added).

    A stable sort of the positions by row (invalid ones last) puts each
    row's contributions in a run in position order; pass j adds, to every
    row, the j-th entry of its run where the run is longer than j.  Within
    a pass no two contributions share a row, so every pass is a plain
    gather and an add with no atomics, and no host read."""
    rest = tuple(vals.shape[1:])
    out = vals.new_zeros((n,) + rest)
    P = idx.shape[0]
    if P == 0 or n == 0:
        return out
    key = torch.where(valid, idx.to(_I64), n)
    sorted_key, order = torch.sort(key, stable=True)
    probe = torch.arange(n, dtype=_I64, device=idx.device)
    start = torch.searchsorted(sorted_key, probe, right=False)
    count = torch.searchsorted(sorted_key, probe, right=True) - start
    pad = (...,) + (None,) * len(rest)
    for j in range(copies):
        src = order[(start + j).clamp(max=P - 1)]
        out += torch.where((count > j)[pad], vals[src],
                           _zeros_like_scalar(vals))
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, valid, copies):
        ctx.save_for_backward(idx, valid)
        ctx.x_shape = x.shape
        ctx.copies = copies
        return torch.where(valid[(...,) + (None,) * (x.dim() - 1)], x[idx],
                           _zeros_like_scalar(x))

    @staticmethod
    def backward(ctx, g):
        idx, valid = ctx.saved_tensors
        flat_idx = idx.reshape(-1)
        gf = g.reshape((flat_idx.shape[0],) + tuple(ctx.x_shape[1:]))
        return (ordered_row_sum(gf, flat_idx, valid.reshape(-1),
                                ctx.x_shape[0], ctx.copies),
                None, None, None)


def _hops(group, reverse: bool):
    """The two hops in wire order: (subgroup, dim of the (racks, L, ...)
    view it exchanges).  Hop 1 (scale-out) goes over the rack subgroup on
    dim 0, hop 2 (scale-up) over the lane subgroup on dim 1; ``reverse``
    runs them the other way round.  A subgroup of one rank moves nothing
    and is left out."""
    hops = [(group.rack, 0), (group.lane, 1)]
    return [(g, d) for g, d in (hops[::-1] if reverse else hops)
            if g.size > 1]


def _hop_in(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The (racks, L, ...) view as the hop's (peers, ...) buffer."""
    return t if dim == 0 else t.transpose(0, 1)


def two_hop_all_to_all(buf: torch.Tensor, group, *,
                       reverse: bool = False) -> torch.Tensor:
    """Tiered EP exchange of a destination-major buffer (DESIGN.md S9).

    Mirrors ``repro.moe.permute.two_hop_all_to_all`` on a factored
    :class:`repro_torch.parallel.collectives.EPGroup` of ``racks`` x ``L``
    ranks: ``buf`` is (R, ...) with one row per destination rank in
    rack-major order, viewed as (racks, L, ...).  Hop 1 (scale-out) is an
    ``all_to_all`` over the rack subgroup on dim 0: one rack-aggregated
    payload of L rows to the same-lane peer of each rack; hop 2
    (scale-up) is one over the lane subgroup on dim 1, which scatters each
    row to its lane.  Both are pure relabellings and commute, so the
    result is bit for bit the flat ``all_to_all``; ``reverse=True`` runs
    the lane hop first (the return wire).  Differentiable: each hop's
    transpose is itself, so the backward is the reverse exchange."""
    R = buf.shape[0]
    # The list holds the one reference to each hop's result, which the
    # next hop takes (pop) and drops once its input is copied: a hop's
    # output is allocated with at most three buffers of the wire alive
    # (at DeepSeek-V3's width a buffer is 1.9 GB a rank).
    held = [buf.reshape((group.racks, R // group.racks)
                        + tuple(buf.shape[1:]))]
    for sub, dim in _hops(group, reverse):
        held.append(_hop(sub, held.pop(), dim))
    return held.pop().reshape(buf.shape)


def _hop(sub, t: torch.Tensor, dim: int) -> torch.Tensor:
    """One hop of the (racks, L, ...) view ``t`` over ``sub`` on ``dim``;
    ``t`` is dropped once the hop's contiguous input is made."""
    x = _hop_in(t, dim).contiguous()
    del t
    return _hop_in(collectives.all_to_all(sub, x), dim)


class _TwoHop:
    """A started :func:`two_hop_all_to_all`: the first hop runs while the
    caller works on; ``wait()`` finishes it, runs the second hop and
    returns the received buffer."""

    def __init__(self, buf: torch.Tensor, group, reverse: bool):
        R = buf.shape[0]
        self._shape = buf.shape
        self._group = group
        self._hops = _hops(group, reverse)
        t = buf.reshape((group.racks, R // group.racks)
                        + tuple(buf.shape[1:]))
        self._first = None
        if self._hops:
            sub, dim = self._hops[0]
            self._first = collectives.all_to_all_async(sub, _hop_in(t, dim))
        self._t = t
        self._out = None

    def wait(self) -> torch.Tensor:
        if self._out is None:
            held = [self._t]
            self._t = None
            if self._first is not None:
                held = [_hop_in(self._first.wait(), self._hops[0][1])]
                self._first = None
            for sub, dim in self._hops[1:]:
                held.append(_hop(sub, held.pop(), dim))
            self._out = held.pop().reshape(self._shape)
        return self._out


def two_hop_all_to_all_async(buf: torch.Tensor, group, *,
                             reverse: bool = False) -> _TwoHop:
    """:func:`two_hop_all_to_all` with its first hop started and not
    waited for; ``.wait()`` gives the result (no gradient)."""
    return _TwoHop(buf, group, reverse)


def occurrence_by_histogram(ids: torch.Tensor, num_groups: int) -> torch.Tensor:
    """``occ[i] = #{i' < i : ids[i'] == ids[i]}`` by a cumulative histogram.

    The one-hot is laid out (groups, items) so the cumsum runs along the
    contiguous axis: on a GPU the scan over the outer axis of the JAX layout
    (items, groups) took ~6 ms for 32768 items x 128 experts on an H100.
    """
    groups = torch.arange(num_groups, dtype=ids.dtype, device=ids.device)
    onehot = (groups[:, None] == ids[None, :]).to(torch.int32)
    cum = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    return torch.gather(cum, 0, ids.clamp(0, num_groups - 1)[None, :].to(_I64)
                        )[0].to(_I64) - 1


def _group_bounds(sorted_keys: torch.Tensor, num_keys: int):
    """(start, count) of each key group within a sorted key array."""
    probe = torch.arange(num_keys, dtype=sorted_keys.dtype,
                         device=sorted_keys.device)
    start = torch.searchsorted(sorted_keys, probe, right=False)
    end = torch.searchsorted(sorted_keys, probe, right=True)
    return start, end - start


def _zeros_like_scalar(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=t.dtype, device=t.device)


def fused_dispatch(x_local: torch.Tensor, expert_ids: torch.Tensor,
                   cum_q_row: torch.Tensor, dst_slot_of: torch.Tensor, *,
                   num_slots: int, cap_pair: int,
                   occ_offset: torch.Tensor | None = None) -> FusedDispatch:
    """Single-sort dispatch: pack the key, sort once, gather everything.

    Mirrors ``repro.moe.permute.fused_dispatch``.  x_local: (T, D);
    expert_ids: (T, k); cum_q_row: (E, R); dst_slot_of: (R, E).
    """
    T, k = expert_ids.shape
    E, R = cum_q_row.shape
    S1 = num_slots + 1
    dev = x_local.device

    e = expert_ids.reshape(-1).to(_I64)
    n = e.shape[0]
    occ = occurrence_by_histogram(e, E)
    if occ_offset is not None:
        occ = occ + occ_offset[e]
    dst = token_targets(e, cumq=cum_q_row, occ=occ)
    slot = dst_slot_of[dst, e]
    slot = torch.where(slot >= 0, slot, num_slots)

    key = dst * S1 + slot
    perm = torch.sort(key, stable=True).indices
    sorted_key = key[perm]
    sorted_dst = sorted_key // S1

    dst_start, dst_cnt = _group_bounds(sorted_dst, R)
    pos_sorted = torch.arange(n, dtype=_I64, device=dev) - dst_start[sorted_dst]
    item_pos = torch.empty(n, dtype=_I64, device=dev)
    item_pos[perm] = pos_sorted                   # unique-index scatter
    kept = item_pos < cap_pair
    drops = (~kept).sum()

    col = torch.arange(cap_pair, dtype=_I64, device=dev)
    gather_idx = dst_start[:, None] + col[None, :]
    in_row = col[None, :] < dst_cnt[:, None]
    src_item = perm[gather_idx.clamp(0, n - 1)]
    # A token's k items take distinct sorted positions: at most k copies.
    send_x = gather_rows(x_local, src_item // k, in_row, copies=k)

    pair_start, pair_cnt = _group_bounds(sorted_key, R * S1)
    pair_start = pair_start.reshape(R, S1)
    pair_end = pair_start + pair_cnt.reshape(R, S1)
    kept_lim = (dst_start + dst_cnt.clamp(max=cap_pair))[:, None]
    send_counts = (torch.minimum(pair_end, kept_lim)
                   - torch.minimum(pair_start, kept_lim))

    return FusedDispatch(send_x=send_x, send_counts=send_counts,
                         item_dst=torch.where(kept, dst, -1),
                         item_pos=item_pos, item_kept=kept, drops=drops)


def fused_bucket(recv_x: torch.Tensor, recv_counts: torch.Tensor, *,
                 num_slots: int, cap_slot: int):
    """Sort-free receive-side bucketing from the count metadata.

    Mirrors ``repro.moe.permute.fused_bucket``.  Returns (xs, valid, meta,
    drops, rows): slot buffers (num_slots, cap_slot, D), their validity
    mask, the :class:`BucketMeta` inverse map, the dropped-item count and
    each slot's valid-row count (num_slots,): the valid rows of a slot are
    the prefix ``arange(cap_slot) < rows``.  Each valid slot row reads a
    receive position of its own (a received item lands in one slot row),
    so the gather's gradient has one copy a receive row.  The slot buffers' rows start
    a multiple of 16 bytes apart, so that the kernels read them with TMA:
    where a row is not (the int8 wire's, D + 4 bytes), xs is a view of a
    buffer with padded rows, written in the same one pass.
    """
    R, cap_pair, D = recv_x.shape
    dev = recv_x.device
    recv_counts = recv_counts.to(_I64)
    counts = recv_counts[:, :num_slots]                          # (R, G)

    row_cum = torch.cumsum(recv_counts, dim=1)                   # (R, S+1)
    row_start = row_cum - recv_counts
    col_cum = torch.cumsum(counts, dim=0)                        # (R, G)
    col_base = col_cum - counts
    tot = col_cum[-1]                                            # (G,)

    p = torch.arange(cap_slot, dtype=_I64, device=dev)
    src = (col_cum.T[:, None, :] <= p[None, :, None]).sum(dim=-1)
    src = src.clamp(max=R - 1)                                   # (G, cap)
    g_idx = torch.arange(num_slots, dtype=_I64, device=dev)[:, None]
    row_pos = row_start[src, g_idx] + (p[None, :] - col_base[src, g_idx])
    rows = tot.clamp(max=cap_slot)
    valid = p[None, :] < rows[:, None]
    flat = recv_x.reshape(-1, D)
    flat_idx = (src * cap_pair + row_pos).clamp(0, R * cap_pair - 1)
    pitch = -(-D * recv_x.element_size() // 16) * 16
    if pitch == D * recv_x.element_size():
        xs = gather_rows(flat, flat_idx, valid, copies=1)
    else:
        buf = recv_x.new_empty((num_slots, cap_slot,
                                pitch // recv_x.element_size()))
        xs = buf[..., :D]
        torch.where(valid[:, :, None], flat[flat_idx],
                    _zeros_like_scalar(recv_x), out=xs)

    c = torch.arange(cap_pair, dtype=_I64, device=dev)
    g_rc = (row_cum[:, None, :] <= c[None, :, None]).sum(dim=-1)
    g_safe = g_rc.clamp(max=num_slots - 1)
    r_idx = torch.arange(R, dtype=_I64, device=dev)[:, None]
    p_rc = col_base[r_idx, g_safe] + (c[None, :] - row_start[r_idx, g_safe])
    ok = (g_rc < num_slots) & (p_rc < cap_slot)
    meta = BucketMeta(slot=g_safe, pos=p_rc.clamp(0, cap_slot - 1), valid=ok)

    drops = (recv_counts[:, num_slots].sum()
             + (tot - cap_slot).clamp(min=0).sum())
    return xs, valid, meta, drops, rows


def fused_unbucket(out: torch.Tensor, meta: BucketMeta) -> torch.Tensor:
    """Inverse of :func:`fused_bucket`: a pure gather back to (R, cap_pair);
    each valid receive position reads a slot row of its own (one copy)."""
    G, cap, D = out.shape
    return gather_rows(out.reshape(G * cap, D), meta.slot * cap + meta.pos,
                       meta.valid, copies=1)


def _tokenwise_sum(vals: torch.Tensor) -> torch.Tensor:
    """(T, k, D) -> (T, D) as a strict left fold over k.

    Mirrors ``repro.moe.permute._tokenwise_sum``: a tree-shaped sum would
    reassociate the float additions; the fold keeps the reference order.
    """
    y = vals[:, 0]
    for i in range(1, vals.shape[1]):
        y = y + vals[:, i]
    return y


def fused_combine(ret_x: torch.Tensor, disp: FusedDispatch,
                  weights: torch.Tensor) -> torch.Tensor:
    """Weighted combine, scatter-free (mirrors ``fused_combine``); each kept
    item reads its own (dst, pos) return row (one copy)."""
    T, k = weights.shape
    R, cap, D = ret_x.shape
    safe_dst = torch.where(disp.item_kept, disp.item_dst, 0)
    safe_pos = torch.where(disp.item_kept, disp.item_pos, 0)
    flat_w = weights.reshape(-1) * disp.item_kept.to(weights.dtype)
    vals = gather_rows(ret_x.reshape(R * cap, D), safe_dst * cap + safe_pos,
                       disp.item_kept, copies=1) * flat_w[:, None].to(ret_x.dtype)
    return _tokenwise_sum(vals.reshape(T, k, D))


def fused_replicated_bucket(x: torch.Tensor, expert_ids: torch.Tensor,
                            cum_u: torch.Tensor, my_rank, slot_of: torch.Tensor,
                            *, num_slots: int, cap_slot: int,
                            occ_offset: torch.Tensor | None = None
                            ) -> ReplicatedBucket:
    """Replicated-mode bucketing: one sort over this rank's owned share.

    Mirrors ``repro.moe.permute.fused_replicated_bucket`` (the decode path).
    """
    T, k = expert_ids.shape
    E = cum_u.shape[0]
    dev = x.device
    e = expert_ids.reshape(-1).to(_I64)
    n = e.shape[0]
    occ = occurrence_by_histogram(e, E)
    if occ_offset is not None:
        occ = occ + occ_offset[e]
    owner = token_targets(e, cumq=cum_u, occ=occ)
    mine = owner == my_rank
    slot = slot_of[e]
    hosted = slot >= 0
    key = torch.where(mine & hosted, slot, num_slots)

    perm = torch.sort(key, stable=True).indices
    sorted_key = key[perm]
    start, cnt = _group_bounds(sorted_key, num_slots + 1)
    pos_sorted = torch.arange(n, dtype=_I64, device=dev) - start[sorted_key]
    item_pos = torch.empty(n, dtype=_I64, device=dev)
    item_pos[perm] = pos_sorted
    item_ok = (key < num_slots) & (item_pos < cap_slot)
    drops = (mine & ~item_ok).sum()

    p = torch.arange(cap_slot, dtype=_I64, device=dev)
    gather_idx = start[:num_slots, None] + p[None, :]
    rows = cnt[:num_slots].clamp(max=cap_slot)
    valid = p[None, :] < rows[:, None]
    src_item = perm[gather_idx.clamp(0, n - 1)]
    # A token's k items take distinct sorted positions: at most k copies.
    xs = gather_rows(x, src_item // k, valid, copies=k)
    return ReplicatedBucket(xs=xs, valid=valid, item_slot=key,
                            item_pos=item_pos, item_ok=item_ok, drops=drops,
                            rows=rows)


def fused_replicated_combine(out: torch.Tensor, bucket: ReplicatedBucket,
                             weights: torch.Tensor) -> torch.Tensor:
    """Per-item gather from the slot buffers + token-major weighted sum;
    each kept item reads its own (slot, pos) row (one copy)."""
    T, k = weights.shape
    G, cap, D = out.shape
    safe_slot = torch.where(bucket.item_ok, bucket.item_slot, 0)
    safe_pos = torch.where(bucket.item_ok, bucket.item_pos, 0)
    flat_w = weights.reshape(-1) * bucket.item_ok.to(weights.dtype)
    vals = gather_rows(out.reshape(G * cap, D), safe_slot * cap + safe_pos,
                       bucket.item_ok, copies=1) * flat_w[:, None].to(out.dtype)
    return _tokenwise_sum(vals.reshape(T, k, D))
