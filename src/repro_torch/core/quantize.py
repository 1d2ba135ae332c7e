"""Per-row symmetric int8 quantization for the EP wire and the expert FFN.

Mirrors ``repro.core.quantize`` (DESIGN.md S12): ``scale = amax(|row|) /
127`` (exactly 0 on an all-zero row, so a zero row encodes and decodes to
zeros), ``q = clip(round(x / scale), -127, 127)`` with a safe divide and
round to nearest, ties to even (``torch.round``, as ``jnp.round``).  The
int8 wire packs each row's fp32 scale, bitcast, into 4 trailing int8 lanes,
so one ``(..., D + 4)`` buffer carries codes and scales together.

Stochastic rounding, ``floor(v + u)`` with ``u ~ U[0, 1)`` (the
reference's ``key=`` branch, for gradients), takes an explicit
``torch.Generator`` or the uniform ``noise`` itself in place of a
``jax.random`` key: the two frameworks draw different numbers from one
seed, so a test hands both the same draws.
"""

from __future__ import annotations

import torch

__all__ = [
    "WIRE_DTYPES",
    "FFN_DTYPES",
    "tensor_scale",
    "encode_int8",
    "decode_int8",
    "abs_max",
    "quantize_rows",
    "dequantize_rows",
    "encode_wire",
    "decode_wire",
    "split_wire_int8",
    "payload_bytes_per_item",
    "expert_wire_bytes",
    "wire_dtype_bytes",
]

WIRE_DTYPES = ("none", "bf16", "int8")
FFN_DTYPES = ("none", "int8")

_SCALE_BYTES = 4  # one fp32 scale per quantization row


def tensor_scale(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Per-tensor symmetric scale ``max(amax(|x|), eps) / 127``."""
    return torch.clamp(x.abs().max(), min=eps) / 127.0


def encode_int8(x: torch.Tensor, scale: torch.Tensor, *,
                generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8, 0 where ``scale == 0``.

    ``scale`` broadcasts against ``x`` (``(..., 1)`` per row).  With
    ``generator`` or ``noise`` (fp32 uniform draws on [0, 1) of ``x``'s
    shape) the rounding is stochastic, ``floor(v + u)``: unbiased in
    expectation, for gradients quantized without error feedback.  The
    arithmetic runs in place on one fp32 temporary, since at the wire's
    width each extra temporary is gigabytes.
    """
    live = scale > 0
    v = x.to(torch.float32) / torch.where(live, scale,
                                          torch.ones_like(scale))
    v.masked_fill_(~live, 0.0)
    if noise is None and generator is not None:
        noise = torch.rand(v.shape, generator=generator, dtype=torch.float32,
                           device=v.device)
    if noise is None:
        v.round_()
    else:
        v.add_(noise).floor_()
    return v.clamp_(-127, 127).to(torch.int8)


def decode_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode_int8` (fp32)."""
    return q.to(torch.float32) * scale


def abs_max(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``amax(|x|, dim)`` in fp32, in one pass without fp32 temporaries
    (the inf-norm: exact, so bitwise ``x.float().abs().amax(dim)``)."""
    return torch.linalg.vector_norm(x, ord=float("inf"), dim=dim,
                                    dtype=torch.float32)


def quantize_rows(x: torch.Tensor, *,
                  generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 over the last axis: ``(q, scales)``, q int8 of
    ``x.shape`` and scales fp32 of ``x.shape[:-1]``; ``generator`` or
    ``noise``: stochastic rounding (:func:`encode_int8`)."""
    scales = abs_max(x, -1) / 127.0
    return encode_int8(x, scales[..., None], generator=generator,
                       noise=noise), scales


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (fp32)."""
    return decode_int8(q, scales[..., None])


def encode_wire(x: torch.Tensor, wire_dtype: str) -> torch.Tensor:
    """Encode a ``(..., D)`` payload for the EP wire.

    ``"none"`` is the identity, ``"bf16"`` a cast, ``"int8"`` per-row codes
    with the fp32 scale bitcast into 4 trailing lanes: ``(..., D + 4)`` int8.
    """
    if wire_dtype == "none":
        return x
    if wire_dtype == "bf16":
        return x.to(torch.bfloat16)
    if wire_dtype != "int8":
        raise ValueError(f"unknown wire_dtype: {wire_dtype!r}")
    q, scales = quantize_rows(x)
    packed = scales.unsqueeze(-1).contiguous().view(torch.int8)  # (..., 4)
    return torch.cat([q, packed], dim=-1)


def _unpack_scales(buf: torch.Tensor) -> torch.Tensor:
    # A (..., 4) slice of rows D + 4 bytes apart is not 4-byte aligned in
    # general: copy it out before viewing the bytes as fp32.
    return buf[..., -_SCALE_BYTES:].contiguous().view(torch.float32)[..., 0]


def decode_wire(buf: torch.Tensor, wire_dtype: str, out_dtype) -> torch.Tensor:
    """Inverse of :func:`encode_wire`; returns ``(..., D)`` in ``out_dtype``."""
    if wire_dtype == "none":
        return buf
    if wire_dtype == "bf16":
        return buf.to(out_dtype)
    if wire_dtype != "int8":
        raise ValueError(f"unknown wire_dtype: {wire_dtype!r}")
    return dequantize_rows(buf[..., :-_SCALE_BYTES],
                           _unpack_scales(buf)).to(out_dtype)


def split_wire_int8(buf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split an int8 wire buffer into ``(q, scales)`` without dequantizing.

    ``q`` is a view of ``buf`` (rows ``D + 4`` bytes apart, so a row starts
    on a 4-byte boundary, not a 16-byte one); ``scales`` is a new fp32
    tensor.  The end-to-end quantized path feeds both to the w8a8 kernels.
    """
    return buf[..., :-_SCALE_BYTES], _unpack_scales(buf)


def wire_dtype_bytes(wire_dtype: str, base_bytes: int = 4) -> int:
    """Per-element payload width in bytes (excluding scale overhead)."""
    if wire_dtype == "none":
        return base_bytes
    if wire_dtype == "bf16":
        return 2
    if wire_dtype == "int8":
        return 1
    raise ValueError(f"unknown wire_dtype: {wire_dtype!r}")


def payload_bytes_per_item(d_model: int, wire_dtype: str,
                           base_bytes: int = 4) -> int:
    """Wire bytes of one routed token item, scale overhead included."""
    n = d_model * wire_dtype_bytes(wire_dtype, base_bytes)
    return n + (_SCALE_BYTES if wire_dtype == "int8" else 0)


def expert_wire_bytes(d_model: int, d_ff: int, wire_dtype: str,
                      base_bytes: int = 4) -> int:
    """Wire bytes of one expert's (w1, w3, w2) replica-stream payload:
    ``3*D*F`` elements plus ``2*D + F`` fp32 scales for int8."""
    n = 3 * d_model * d_ff * wire_dtype_bytes(wire_dtype, base_bytes)
    if wire_dtype == "int8":
        n += (2 * d_model + d_ff) * _SCALE_BYTES
    return n
