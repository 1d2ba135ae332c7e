# uep-lint: skip-file  (host-side oracle: deliberately re-implements the
# wire codec outside core/quantize so tests can cross-check the production
# helpers against an independent mirror)
"""Dense host-side oracle for the (quantized) two-hop token wire.

Mirrors ``repro.moe.wire_oracle``.  The fused engine ships
destination-major buffers through
:func:`repro_torch.moe.permute.two_hop_all_to_all` -- two ``all_to_all``
hops over a factored (rack, lane) group whose composite is a pure
relabelling of the flat exchange.  This module models that wire densely on
the host: a global ``(R_src, R_dst, ...)`` array holding every rank's send
buffer, the two hops as explicit numpy block permutations, and the wire
codec as an independent numpy mirror of :mod:`repro_torch.core.quantize`
(bf16 through torch's rounding, carried as its 16-bit patterns).

It exists for tests (DESIGN.md S12): the oracle is slow and all-gathered,
but every step is inspectable, so the device path can be validated in two
independent directions --

* **transport**: :func:`two_hop_wire` must equal :func:`flat_wire` bit for
  bit, for any payload dtype (the hops never look inside a row, so encoded
  int8 rows with in-band scales ride unchanged);
* **codec**: :func:`np_encode_wire` / :func:`np_decode_wire` must agree
  bitwise with ``core.quantize.encode_wire`` / ``decode_wire`` -- neither
  implementation can vouch for itself.

Nothing here is fast; never import it from engine code.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "flat_wire",
    "two_hop_wire",
    "np_encode_wire",
    "np_decode_wire",
    "wire_roundtrip",
]


def flat_wire(send: np.ndarray) -> np.ndarray:
    """Flat all_to_all on a global dense buffer: ``recv[d, s] = send[s, d]``.

    ``send`` is ``(R_src, R_dst, ...)``: row ``send[s, d]`` is the block
    rank ``s`` addresses to rank ``d`` (any trailing shape).
    """
    send = np.asarray(send)
    return np.swapaxes(send, 0, 1)


def two_hop_wire(send: np.ndarray, racks: int,
                 reverse: bool = False) -> np.ndarray:
    """The tiered wire as explicit block permutations, hop by hop.

    With rank id ``r = g * L + l`` the global tensor factors as
    ``(src_rack, src_lane, dst_rack, dst_lane, ...)``.  Hop 1 (scale-out)
    exchanges rack-aggregated blocks between same-lane peers -- a swap of
    the two rack axes; hop 2 (scale-up) scatters rows to their final lane
    inside the rack -- a swap of the two lane axes.  The composite is the
    (src, dst) transpose of :func:`flat_wire`, which is what the bitwise
    equivalence contract asserts.  ``reverse=True`` runs the hops in the
    return-wire order (lane first); the permutations commute, so the
    composite is identical -- mirroring the device path, where ``reverse``
    exists to keep per-hop buffer layouts consistent, not to change the
    destination map.
    """
    send = np.asarray(send)
    R = send.shape[0]
    if send.shape[1] != R or R % racks != 0:
        raise ValueError(f"send must be (R, R, ...) with R % racks == 0, "
                         f"got {send.shape} racks={racks}")
    L = R // racks
    t = send.reshape((racks, L, racks, L) + send.shape[2:])
    hops = [(0, 2), (1, 3)]
    for a, b in hops[::-1] if reverse else hops:
        t = np.swapaxes(t, a, b)
    return np.ascontiguousarray(t).reshape((R, R) + send.shape[2:])


def np_encode_wire(x: np.ndarray, wire_dtype: str) -> np.ndarray:
    """Numpy mirror of ``core.quantize.encode_wire`` (see module docstring).

    int8: per-row symmetric scale ``amax/127`` (exactly 0 on zero rows,
    matching the production codec's exact-zero contract), round-half-even
    codes clipped to [-127, 127], and the fp32 scale carried in-band as 4
    little-endian int8 lanes appended to the row.
    """
    x = np.asarray(x)
    if wire_dtype == "none":
        return x.copy()
    if wire_dtype == "bf16":
        # bf16 as its bit patterns (numpy has no bf16 type).
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            torch.bfloat16).view(torch.int16).numpy()
    if wire_dtype != "int8":
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
    xf = x.astype(np.float32)
    scales = (np.abs(xf).max(axis=-1) / np.float32(127.0)).astype(np.float32)
    safe = np.where(scales > 0, scales, np.float32(1.0))[..., None]
    v = np.where(scales[..., None] > 0, xf / safe, np.float32(0.0))
    q = np.clip(np.round(v), -127, 127).astype(np.int8)
    sbytes = np.ascontiguousarray(scales[..., None]).view(np.int8)
    return np.concatenate([q, sbytes], axis=-1)


def np_decode_wire(buf: np.ndarray, wire_dtype: str,
                   out_dtype=np.float32) -> np.ndarray:
    """Numpy mirror of ``core.quantize.decode_wire``."""
    buf = np.asarray(buf)
    if wire_dtype == "none":
        return buf.copy()
    if wire_dtype == "bf16":
        return torch.from_numpy(np.ascontiguousarray(buf)).view(
            torch.bfloat16).to(torch.float32).numpy().astype(out_dtype)
    if wire_dtype != "int8":
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
    q = buf[..., :-4].astype(np.float32)
    scales = np.ascontiguousarray(buf[..., -4:]).view(np.float32)
    return (q * scales).astype(out_dtype)


def wire_roundtrip(send: np.ndarray, wire_dtype: str, racks: int,
                   out_dtype=np.float32):
    """Full oracle pipeline: encode at source, two hops, decode at dest.

    Returns ``(decoded, encoded_recv)``: the receiver-side float rows and
    the raw wire bytes they were decoded from.  Because the hops are pure
    permutations, ``decoded`` equals the flat transpose of the source-side
    dequantization -- the property the engine's quantized dispatch path
    inherits its correctness from.
    """
    enc = np_encode_wire(send, wire_dtype)
    recv = two_hop_wire(enc, racks)
    return np_decode_wire(recv, wire_dtype, out_dtype), recv
