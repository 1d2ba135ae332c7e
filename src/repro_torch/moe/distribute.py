"""Replica weight distribution (paper S6.1).

Mirrors ``repro.moe.distribute`` on a flat EP group: each redundant slot's
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
gather of the local mains.  Backward through the multi-rank stream is not
ported (training is a later slice).

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

__all__ = ["select_local_replicas", "materialize_replica_stack"]


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
    parts = [collectives.reduce_scatter(axis_name, packed[..., lo:lo + chunk])
             for lo in range(0, total, chunk)]
    rep = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    off = 0
    for w, e, o in zip(ws, enc, out):
        size = math.prod(e.shape[1:])
        o.copy_(decode_wire(rep[:, off:off + size].reshape(
            (n_slot,) + tuple(e.shape[1:])), wire_dtype, w.dtype))
        off += size
    return out
