"""Replica weight distribution (paper S6.1), single-rank EP group.

Mirrors ``repro.moe.distribute`` at ``axis_name=None``: with one EP rank
every replica's home is local, so a replica slot is a masked row gather of
the local mains.  The multi-rank reduce-scatter is a later slice.

Weight copies.  The JAX version packs w1/w3/w2 into one matrix before its
transfer, which at GLM-4.5-Air width copies ~4.4 GB per layer per call.
Here only the ``n_slot`` selected rows move, and :func:`materialize_replica_stack`
can write them straight into the tail of a caller-owned slot buffer (see
``repro_torch.moe.layer.MoEParams``), so no call copies the mains.  With a
``wire_dtype`` the rows are encoded and decoded on the way, so a replica is
the wire's image of its main while the mains stay exact.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantize import decode_wire, encode_wire

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
                              x_slots: torch.Tensor, my_rank, axis_name, *,
                              out: tuple[torch.Tensor, ...],
                              wire_dtype: str = "none"
                              ) -> tuple[torch.Tensor, ...]:
    """Replica weights for this rank's redundant slots, one per tensor.

    Mirrors ``repro.moe.distribute.materialize_replica_stack`` for a
    single-rank group (``axis_name=None``, R == 1).  ``out`` holds one
    (N_slot, ...) tensor per weight that receives the rows in place and is
    returned.  Each replica is ``decode_wire(encode_wire(main))``: the JAX
    version encodes every main and selects after; the codec works row by
    row and maps a zero row to a zero row, so selecting first gives the
    same bytes for a fraction of the work.
    """
    if axis_name is not None:
        raise ValueError("multi-rank replica streaming is not ported yet; "
                         "axis_name must be None")
    R, n_slot = x_slots.shape
    if R != 1:
        raise ValueError("axis_name=None requires ep_size == 1")
    flat = x_slots.reshape(-1)
    return tuple(o.copy_(decode_wire(
        encode_wire(select_local_replicas(w, flat, 0), wire_dtype),
        wire_dtype, w.dtype)) for w, o in zip(ws, out))
