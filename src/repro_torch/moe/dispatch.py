"""Reference multi-sort dispatch and combine: the fused engine's oracle.

Mirrors ``repro.moe.dispatch`` (plain PyTorch, a flat EP axis only):

  1. per-item destination rank by the cumulative-quota lookup;
  2. ``dispatch_tokens`` places items into fixed-capacity per-destination
     buffers with their expert ids (``send_e``), which ride the exchange;
  3. ``bucket_by_slot`` groups the received items into per-physical-slot
     buffers by a second occurrence sort;
  4. ``unbucket`` and ``combine_tokens`` invert both steps: results return
     in the positions the items were sent from, and each token sums its k
     weighted contributions.

Capacities and drops follow the reference: ``cap_pair`` bounds items per
(src, dst) pair and ``cap_slot`` per physical slot; overflow is dropped and
counted, and items whose expert the receiver does not host park past the
last slot and count as drops.

The reference builds its buffers with scatter-adds into zeros, where every
kept item owns its position and dropped items add zeros to a scratch
position.  Here kept items are written to their positions and dropped items
to one scratch row past the end, which is cut off: the same buffers, with
no accumulation order to depend on (an ``index_add_`` on a CUDA tensor sums
in no fixed order).  The combine sums each token's k contributions as a
left fold from zeros, the order of the reference's scatter-add, so the
layer's output is bit for bit the fused engine's at zero-drop capacities.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.planner import occurrence_index, token_targets

__all__ = ["DispatchOut", "dispatch_tokens", "combine_tokens",
           "bucket_by_slot", "unbucket"]

_I64 = torch.int64


class DispatchOut(NamedTuple):
    send_x: torch.Tensor     # (R, cap_pair, D) padded send buffers
    send_e: torch.Tensor     # (R, cap_pair) logical expert ids, -1 pad
    item_dst: torch.Tensor   # (T*k,) destination rank per item (-1 dropped)
    item_pos: torch.Tensor   # (T*k,) position within the (dst) buffer
    item_kept: torch.Tensor  # (T*k,) bool
    drops: torch.Tensor      # () dropped items on this rank


def _place(n_rows: int, idx: torch.Tensor, kept: torch.Tensor,
           vals: torch.Tensor, fill) -> torch.Tensor:
    """(n_rows, ...) buffer of ``fill`` with ``vals[i]`` at row ``idx[i]``
    where ``kept[i]``; the rest go to a scratch row past the end, cut off.
    Kept rows are distinct, so the writes do not collide."""
    buf = torch.full((n_rows + 1,) + tuple(vals.shape[1:]), fill,
                     dtype=vals.dtype, device=vals.device)
    buf[torch.where(kept, idx, n_rows)] = vals
    return buf[:n_rows]


def dispatch_tokens(x_local: torch.Tensor, expert_ids: torch.Tensor,
                    q_row: torch.Tensor, *, cap_pair: int) -> DispatchOut:
    """Per-destination send buffers from the plan's reroute split.

    x_local: (T, D); expert_ids: (T, k); q_row: (E, R) this source rank's
    split (``plan.q[my_rank]``)."""
    T, k = expert_ids.shape
    D = x_local.shape[-1]
    R = q_row.shape[-1]
    items_e = expert_ids.reshape(-1).to(_I64)
    items_t = torch.arange(T, dtype=_I64,
                           device=x_local.device).repeat_interleave(k)
    dst = token_targets(items_e, q_row)
    pos = occurrence_index(dst)
    kept = pos < cap_pair
    drops = (~kept).sum()
    flat = torch.where(kept, dst, 0) * cap_pair + torch.where(kept, pos, 0)
    send_x = _place(R * cap_pair, flat, kept, x_local[items_t], 0)
    send_e = _place(R * cap_pair, flat, kept, items_e, -1)
    return DispatchOut(send_x.reshape(R, cap_pair, D),
                       send_e.reshape(R, cap_pair),
                       torch.where(kept, dst, -1), pos, kept, drops)


def bucket_by_slot(recv_x: torch.Tensor, recv_e: torch.Tensor,
                   slot_of: torch.Tensor, *, num_slots: int, cap_slot: int):
    """Group received items (R, cap_pair, D) with their experts (R,
    cap_pair) (-1 pad) into per-physical-slot buffers; ``slot_of`` (E,)
    is the local slot of each expert, -1 where not hosted (such items are
    dropped and counted).  Returns (xs, valid, back_idx, drops): slot
    buffers (num_slots, cap_slot, D), their mask, each entry's flat index
    into the (R * cap_pair) receive stream (-1 empty), and the drops."""
    R, cap_pair, D = recv_x.shape
    flat_x = recv_x.reshape(-1, D)
    flat_e = recv_e.reshape(-1).to(_I64)
    is_real = flat_e >= 0
    slot = torch.where(is_real, slot_of.to(_I64)[flat_e.clamp(min=0)],
                       num_slots)
    slot = torch.where(slot >= 0, slot, num_slots)
    pos = occurrence_index(slot)
    kept = (slot < num_slots) & (pos < cap_slot)
    drops = (is_real & ~kept).sum()
    idx = (torch.where(kept, slot, 0) * cap_slot + torch.where(kept, pos, 0))
    n = num_slots * cap_slot
    xs = _place(n, idx, kept, flat_x, 0)
    valid = _place(n, idx, kept, kept, False)
    back = _place(n, idx, kept, torch.arange(flat_e.shape[0], dtype=_I64,
                                             device=flat_e.device), -1)
    return (xs.reshape(num_slots, cap_slot, D),
            valid.reshape(num_slots, cap_slot),
            back.reshape(num_slots, cap_slot), drops)


def unbucket(out: torch.Tensor, valid: torch.Tensor, back_idx: torch.Tensor,
             recv_shape: tuple[int, int, int]) -> torch.Tensor:
    """Slot-buffer outputs back into the (R, cap_pair, D) receive layout."""
    R, cap_pair, D = recv_shape
    ok = valid.reshape(-1)
    flat = _place(R * cap_pair, back_idx.reshape(-1).clamp(min=0), ok,
                  out.reshape(-1, D), 0)
    return flat.reshape(R, cap_pair, D)


def combine_tokens(ret_x: torch.Tensor, disp: DispatchOut,
                   weights: torch.Tensor, num_tokens: int) -> torch.Tensor:
    """Weighted combine of the returned expert outputs (R, cap_pair, D),
    in the positions the items were sent from, onto the T source tokens
    (a left fold over each token's k items, from zeros)."""
    T, k = weights.shape
    D = ret_x.shape[-1]
    kept = disp.item_kept
    safe_dst = torch.where(kept, disp.item_dst, 0)
    safe_pos = torch.where(kept, disp.item_pos, 0)
    w = weights.reshape(-1) * kept.to(weights.dtype)
    vals = (ret_x[safe_dst, safe_pos]
            * w[:, None].to(ret_x.dtype)).reshape(T, k, D)
    y = torch.zeros((num_tokens, D), dtype=ret_x.dtype, device=ret_x.device)
    for i in range(k):
        y = y + vals[:, i]
    return y
