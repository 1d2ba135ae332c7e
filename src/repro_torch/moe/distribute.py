"""Replica weight distribution (paper S6.1).

Mirrors ``repro.moe.distribute``: each redundant slot's
weights come from its expert's home rank,

  replica_w = reduce_scatter_{EP}( select(slot_wants_my_expert, w_local) ),

where each rank's partial holds, for every (rank, slot) of the plan's slot
table, the rows of its own main that the slot wants and zeros everywhere
else, and the reduce-scatter lands each rank's slots on it.  Every slot has
exactly one nonzero contribution (its expert's home), so the sum moves the
home's rows unchanged, but for a ``-0.0`` that may arrive as ``+0.0``
(``-0.0 + 0.0``), which no product or sum downstream can tell apart from
``+0.0`` beyond the sign of a zero.  With one EP rank (``axis_name``
None) every replica's home is local and a replica slot is a masked row
gather of the local mains.

On a factored (rack x lane) group the reduce-scatter is the paper's tiered
replica stream (S6.1) in two stages: over the lane subgroup first, which
aggregates a whole rack's contributions per destination rack onto the
same-lane member, then over the rack subgroup, which lands each rack
aggregate on its rank.  Every slot still has one nonzero contribution, so
both shapes give the same replicas.  The backward gathers in the reverse
order: racks, then lanes.

Backward (the paper's training equivalence, S4.2).  The JAX package gets
it by construction: the transpose of the reduce-scatter is an all-gather,
and the transpose of the masked gather a segment-sum, so

  dL/dw_local = onehot^T @ all_gather_{EP}(dL/dreplica_w):

every replica's gradient goes back onto its home main.  :func:`slot_weights`
is that as one autograd Function around the in-place stream: its forward
writes the replicas into the slot buffers' tails as
:func:`materialize_replica_stack` does and returns the whole buffers, and
its backward adds, onto each main's gradient (the gradient of its own slot
rows), the replica rows' gradients all-gathered over the group and
segment-summed onto their home mains (:func:`replica_grads_to_mains`; at
R = 1 a local segment-sum).  Under a gradient the wire codec must be
"none".

Weight copies.  The JAX version packs w1/w3/w2 into one matrix before its
transfer, which at GLM-4.5-Air width copies ~4.4 GB per layer per call.
Here only the ``R * n_slot`` selected rows are gathered and packed, and
:func:`materialize_replica_stack` writes the received rows straight into
the tail of a caller-owned slot buffer (see
``repro_torch.moe.layer.MoEParams``), so no call copies the mains.  With a
``wire_dtype`` the rows are encoded before the transfer and decoded after
it, so a replica is the wire's image of its main while the mains stay
exact; the encoded bytes ride the reduce-scatter exactly, as in the
reference (zero rows encode to zero, int8 sums stay in int8).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.quantize import decode_wire, encode_wire
from repro_torch.parallel import collectives

__all__ = ["select_local_replicas", "materialize_replica_stack",
           "replica_grads_to_mains", "slot_weights"]


def select_local_replicas(w_local: torch.Tensor, x_slots_flat: torch.Tensor,
                          local_expert_base) -> torch.Tensor:
    """(len(x_slots_flat), ...) replica rows by masked gather.

    Mirrors ``repro.moe.distribute.select_local_replicas``: slots bound to
    one of this rank's mains copy that expert's rows, every other slot is
    zero.
    """
    epr = w_local.shape[0]
    local_idx = x_slots_flat.to(torch.int64) - local_expert_base
    in_range = (local_idx >= 0) & (local_idx < epr)
    rows = torch.index_select(w_local, 0, local_idx.clamp(0, epr - 1))
    mask = in_range.reshape((-1,) + (1,) * (w_local.dim() - 1))
    return torch.where(mask, rows, torch.zeros((), dtype=w_local.dtype,
                                               device=w_local.device))


def _reduce_scatter_slots(axis_name, packed: torch.Tensor) -> torch.Tensor:
    """(R, N_slot, X) partial -> (N_slot, X) this rank's slots: one
    reduce-scatter on a flat group; on a factored one, lanes first, then
    racks (``repro.moe.distribute._scatter_replicas``)."""
    if not axis_name.factored:
        return collectives.reduce_scatter(axis_name, packed)
    R = packed.shape[0]
    G = axis_name.racks
    t = packed.reshape((G, R // G) + tuple(packed.shape[1:]))
    t = collectives.reduce_scatter(axis_name.lane, t.transpose(0, 1))
    return collectives.reduce_scatter(axis_name.rack, t)     # (N_slot, X)


def _all_gather_slots(axis_name, d_rep: torch.Tensor) -> torch.Tensor:
    """The transpose of :func:`_reduce_scatter_slots`: (N_slot, ...) on
    every rank -> (R, N_slot, ...), rank-major (factored: racks first, then
    lanes)."""
    if not axis_name.factored:
        return collectives.all_gather(axis_name, d_rep)
    t = collectives.all_gather(axis_name.rack, d_rep)         # (G, N_slot, ...)
    t = collectives.all_gather(axis_name.lane, t)             # (L, G, ...)
    return t.transpose(0, 1).reshape((axis_name.size,) + tuple(d_rep.shape))


def materialize_replica_stack(ws: tuple[torch.Tensor, ...],
                              x_slots: torch.Tensor, my_rank: int, axis_name,
                              *, out: tuple[torch.Tensor, ...],
                              n_chunks: int = 1, wire_dtype: str = "none"
                              ) -> tuple[torch.Tensor, ...]:
    """Replica weights for this rank's redundant slots, one per tensor.

    Mirrors ``repro.moe.distribute.materialize_replica_stack`` (flat axis).
    ``ws``: this rank's mains, each (E_local, ...); ``x_slots``: the plan's
    (R, N_slot) slot table; ``axis_name``: the EP group
    (:class:`repro_torch.parallel.collectives.EPGroup`) or None for one
    rank.  ``out`` holds one (N_slot, ...) tensor per weight that receives
    the rows in place and is returned.  Each replica is
    ``decode_wire(encode_wire(main))``: the reference encodes every main and
    selects after; the codec works row by row and maps a zero row to a zero
    row, so selecting first gives the same bytes for a fraction of the work.
    The partials of all tensors ride one packed reduce-scatter, or
    ``n_chunks`` of them over the packed axis (the reference's tile
    streaming).
    """
    R, n_slot = x_slots.shape
    flat = x_slots.reshape(-1)
    if axis_name is None:
        if R != 1:
            raise ValueError("axis_name=None requires ep_size == 1")
        return tuple(o.copy_(decode_wire(
            encode_wire(select_local_replicas(w, flat, 0), wire_dtype),
            wire_dtype, w.dtype)) for w, o in zip(ws, out))
    if axis_name.size != R:
        raise ValueError(f"slot table for {R} ranks on a group of "
                         f"{axis_name.size}")
    base = my_rank * ws[0].shape[0]
    enc = [encode_wire(select_local_replicas(w, flat, base), wire_dtype)
           for w in ws]
    packed = torch.cat([e.reshape(R, n_slot, -1) for e in enc], dim=-1)
    total = packed.shape[-1]
    chunk = -(-total // n_chunks)
    parts = [_reduce_scatter_slots(axis_name, packed[..., lo:lo + chunk])
             for lo in range(0, total, chunk)]
    rep = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    off = 0
    for w, e, o in zip(ws, enc, out):
        size = math.prod(e.shape[1:])
        o.copy_(decode_wire(rep[:, off:off + size].reshape(
            (n_slot,) + tuple(e.shape[1:])), wire_dtype, w.dtype))
        off += size
    return out


def replica_grads_to_mains(d_rep: torch.Tensor, x_slots: torch.Tensor,
                           my_rank: int, axis_name, out: torch.Tensor
                           ) -> torch.Tensor:
    """The transpose of the replica stream, added onto ``out`` (n_main,
    ...), the gradient of this rank's mains, in place: ``d_rep`` (N_slot,
    ...) are this rank's replica slots' gradients.  Every rank's are
    all-gathered (R, N_slot, ...) and each row whose slot holds one of this
    rank's experts is added onto that expert's row (the transpose of
    :func:`select_local_replicas`); rows of other homes and unbound slots
    (-1) add zeros.  An expert may have replicas on several ranks, so the
    rows are added one at a time in (rank, slot) order: a single
    ``index_add_`` would add them with atomics in no fixed order."""
    R, n_slot = x_slots.shape
    n_main = out.shape[0]
    full = d_rep[None] if axis_name is None else _all_gather_slots(
        axis_name, d_rep)
    flat = full.reshape(R * n_slot, -1)
    local = x_slots.reshape(-1).to(torch.int64) - my_rank * n_main
    ok = (local >= 0) & (local < n_main)
    dst = out.view(n_main, -1)
    at = local.clamp(0, n_main - 1)
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    for i in range(R * n_slot):
        dst.index_add_(0, at[i:i + 1], torch.where(ok[i], flat[i:i + 1], zero))
    return out


def slot_weights(mains: tuple[torch.Tensor, ...],
                 buffers: tuple[torch.Tensor, ...], x_slots: torch.Tensor,
                 my_rank: int, axis_name, *, n_chunks: int = 1,
                 wire_dtype: str = "none") -> tuple[torch.Tensor, ...]:
    """Differentiable slot buffers: each of ``buffers`` (num_slots, ...)
    holds its main (``mains``, the buffer's first E_local rows, as views)
    in its head; the replicas of the plan's slot table ``x_slots`` are
    written into the tails in place (:func:`materialize_replica_stack`),
    and views of the whole buffers are returned, whose gradient flows back
    onto the mains (see the module's notes; under a gradient the wire
    codec must be "none")."""
    return _SlotWeights.apply(x_slots, my_rank, axis_name, n_chunks,
                              wire_dtype, tuple(buffers), *mains)


class _SlotWeights(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_slots, my_rank, axis_name, n_chunks, wire_dtype,
                buffers, *mains):
        n_main = mains[0].shape[0]
        materialize_replica_stack(mains, x_slots, my_rank, axis_name,
                                  out=tuple(b[n_main:] for b in buffers),
                                  n_chunks=n_chunks, wire_dtype=wire_dtype)
        ctx.save_for_backward(x_slots)
        ctx.args = (my_rank, axis_name, n_main)
        return tuple(b.view_as(b) for b in buffers)

    @staticmethod
    def backward(ctx, *d_bufs):
        (x_slots,) = ctx.saved_tensors
        my_rank, axis_name, n_main = ctx.args
        # Each main's gradient: its own slot rows' plus its replicas',
        # added in place onto the head rows of the slot gradient (no copy
        # of the mains' gradients: at DeepSeek-V3's width one is 5.6 GB a
        # rank), which autograd owns and reads no more.
        d_mains = [None if d is None else replica_grads_to_mains(
            d[n_main:], x_slots, my_rank, axis_name, d[:n_main])
            for d in (None if d is None else d.contiguous() for d in d_bufs)]
        return (None, None, None, None, None, None, *d_mains)
