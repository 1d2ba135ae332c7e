"""Error-feedback int8 gradient compression for the cross-pod all-reduce.

Mirrors ``repro.optim.grad_compress``: int8 codes with error feedback (the
quantization residual carried into the next step) cut the all-reduce's
bytes 4x against fp32 and 2x against bf16.  Opt-in and wired into
nothing, as in the reference: a train step that sums its gradients over a
group calls :func:`psum_compressed` in place of the plain sum.  The int8
codec is ``repro_torch.core.quantize``'s (per-tensor scale, round to
nearest); this module adds only the carry.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.quantize import decode_int8, encode_int8, tensor_scale
from repro_torch.parallel import collectives

__all__ = ["CompressState", "init_state", "compress", "decompress",
           "psum_compressed"]


class CompressState(NamedTuple):
    residual: torch.Tensor      # error-feedback carry, fp32, grad's shape


def init_state(grads: list) -> list:
    """One zero :class:`CompressState` per gradient."""
    return [CompressState(torch.zeros_like(g, dtype=torch.float32))
            for g in grads]


def compress(g: torch.Tensor, state: CompressState):
    """fp -> (int8 codes, scale, new state); the quantization error lands
    in the residual."""
    gf = g.to(torch.float32) + state.residual
    scale = tensor_scale(gf)
    q = encode_int8(gf, scale)
    return q, scale, CompressState(gf - decode_int8(q, scale))


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return decode_int8(q, scale)


def psum_compressed(g: torch.Tensor, state: CompressState, group):
    """Mean of ``g`` over ``group`` (a ``collectives.EPGroup``) with an int8
    payload and error feedback; returns (mean in g's dtype, new state).

    The scale is agreed first (an all-reduce MAX of the local scales, one
    scalar), then every rank quantizes against the shared scale, so
    summing the codes is exact up to each rank's rounding.  The codes are
    summed as int32 (the reference's XLA reduction upcasts them too)."""
    gf = g.to(torch.float32) + state.residual
    scale = collectives.all_max(group, tensor_scale(gf))
    q = encode_int8(gf, scale)
    new_state = CompressState(gf - decode_int8(q, scale))
    total = collectives.all_reduce(group, q.to(torch.int32))
    return (total.to(torch.float32) * scale / group.size).to(g.dtype), \
        new_state
