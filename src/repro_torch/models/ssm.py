"""Mamba-2 SSD (state-space duality) mixer: chunked scan and one-step decode.

Mirrors ``repro.models.ssm``.  Within a chunk the recurrence is a masked
quadratic form, across chunks a small (H, N, P) state is carried; both the
full-sequence path (:func:`ssd_forward`) and chunked prefill
(:func:`ssd_prefill`) go through ``kernels.ssd_scan.ssd_chunk_scan``, which
launches the intra-chunk kernel for a CUDA tensor and runs its plain
version for a CPU tensor.  Decode keeps the constant-size state.

Types follow JAX's promotion in the model dtype (bf16 on the card): the
projections and the causal conv run in the model dtype, the scan in fp32,
and ``y`` stays fp32 through the skip term, the gate, the norm and the
output projection (fp32 @ bf16 promotes to an fp32 product in JAX), which
is cast back to the model dtype at the end.  The causal conv is written as
the same shifted sums as the reference, not ``conv1d`` (which would go
through cuDNN, TF32 by default).

On a mesh (the reference's layout, ``repro_torch.parallel.sharding``)
``in_proj``, ``conv_w``, ``conv_b`` and ``out_proj`` take the reference's
placements, but ``in_proj``'s split output mixes z, x, B, C and dt, which
is not a split by heads: the block gathers them over the model axis at
use, as FSDP gathers over the data axis, and the mixer runs whole on
every rank (``transformer.block_apply``).  So does its decode state: the
reference places ``s`` over the heads and the conv tail over its channels
(``sharding.cache_specs``), while the port keeps both whole on every model
rank (its rows over the data axis) until the mixer is split by heads.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan.ops import ssd_chunk_scan
from repro_torch.models.layers import rms_norm

__all__ = ["SSMConfig", "SSMParams", "SSMState", "init_ssm", "conv_channels",
           "ssd_forward", "ssd_prefill", "ssd_decode"]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_inner: int
    headdim: int = 64
    d_state: int = 128
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 128

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim


class SSMParams(nn.Module):
    """in_proj (D, 2*d_inner + 2*G*N + H), conv_w (d_conv, C), conv_b (C,),
    a_log/d_skip/dt_bias (H,) fp32, norm (d_inner,), out_proj (d_inner, D),
    with C = d_inner + 2*G*N (mirrors ``repro.models.ssm.SSMParams``)."""

    def __init__(self, in_proj, conv_w, conv_b, a_log, d_skip, dt_bias, norm,
                 out_proj):
        super().__init__()
        for name, t in (("in_proj", in_proj), ("conv_w", conv_w),
                        ("conv_b", conv_b), ("a_log", a_log),
                        ("d_skip", d_skip), ("dt_bias", dt_bias),
                        ("norm", norm), ("out_proj", out_proj)):
            setattr(self, name, nn.Parameter(t, requires_grad=False))


class SSMState(NamedTuple):
    """Decode state: s (B, H, N, P) fp32, conv (B, d_conv-1, C) trailing
    conv inputs, length (B,) positions run (padding included)."""

    s: torch.Tensor
    conv: torch.Tensor
    length: torch.Tensor


def conv_channels(cfg: SSMConfig) -> int:
    return cfg.d_inner + 2 * cfg.n_groups * cfg.d_state


def init_ssm(cfg: SSMConfig, generator: torch.Generator, *,
             dtype=torch.float32, device="cuda") -> SSMParams:
    """Random weights from ``generator`` (which must live on ``device``)."""
    H = cfg.n_heads
    cc = conv_channels(cfg)
    d_in_all = 2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state + H

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * scale

    f32 = dict(dtype=_F32, device=device)
    return SSMParams(
        in_proj=normal((cfg.d_model, d_in_all), cfg.d_model ** -0.5),
        conv_w=normal((cfg.d_conv, cc), 0.1),
        conv_b=torch.zeros(cc, dtype=dtype, device=device),
        a_log=torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        d_skip=torch.ones(H, **f32),
        dt_bias=torch.zeros(H, **f32),
        norm=torch.ones(cfg.d_inner, dtype=dtype, device=device),
        out_proj=normal((cfg.d_inner, cfg.d_model), cfg.d_inner ** -0.5))


def _split_proj(zxbcdt: torch.Tensor, cfg: SSMConfig):
    di, G, N = cfg.d_inner, cfg.n_groups, cfg.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * G * N]
    dt = zxbcdt[..., 2 * di + 2 * G * N:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None = None):
    """Depthwise causal conv1d as shifted sums.  xbc (B, L, C); w (K, C).

    Returns (silu(conv + b), the last K-1 inputs as the next tail)."""
    K, L = w.shape[0], xbc.shape[1]
    if tail is None:
        tail = xbc.new_zeros((xbc.shape[0], K - 1, xbc.shape[2]))
    xp = torch.cat([tail, xbc], dim=1)
    out = sum(xp[:, i:i + L, :] * w[i][None, None, :] for i in range(K))
    # The tail is copied so a cache does not keep the whole of xp alive.
    return (F.silu(out + b[None, None, :]),
            xp[:, xp.shape[1] - (K - 1):, :].clone())


def _mix(x, params: SSMParams, cfg: SSMConfig, tail, initial_state,
         plain_backward: bool = False):
    """Projection, conv and chunk scan of a (B, L, D) block, L % chunk == 0.

    Returns (out (B, L, D) in x's dtype, final state, new conv tail)."""
    B, L, _ = x.shape
    H, P, N, G, Q = (cfg.n_heads, cfg.headdim, cfg.d_state, cfg.n_groups,
                     cfg.chunk)
    if L % Q:
        raise ValueError(f"SSD length {L} is not a multiple of the chunk {Q}")
    z, xbc, dt = _split_proj(x @ params.in_proj, cfg)
    xbc, new_tail = _causal_conv(xbc, params.conv_w, params.conv_b, tail)
    di = cfg.d_inner
    xs = xbc[..., :di].reshape(B, L, H, P)
    rep = H // G
    Bh = xbc[..., di:di + G * N].reshape(B, L, G, N).repeat_interleave(
        rep, dim=2)                                         # (B, L, H, N)
    Ch = xbc[..., di + G * N:].reshape(B, L, G, N).repeat_interleave(
        rep, dim=2)
    dtv = F.softplus(dt.to(_F32) + params.dt_bias)         # (B, L, H)
    da = dtv * (-torch.exp(params.a_log))[None, None, :]
    nc = L // Q
    y, final = ssd_chunk_scan(
        xs.reshape(B, nc, Q, H, P), Bh.reshape(B, nc, Q, H, N),
        Ch.reshape(B, nc, Q, H, N), dtv.reshape(B, nc, Q, H),
        da.reshape(B, nc, Q, H), initial_state=initial_state,
        plain_backward=plain_backward)
    y = y.reshape(B, L, H, P) + xs.to(_F32) * params.d_skip[None, None, :,
                                                            None]
    return _out(y.reshape(B, L, di), z, params, x.dtype), final, new_tail


def _out(y, z, params: SSMParams, dtype):
    """Gate, norm and output projection of the fp32 ``y``, cast to
    ``dtype``."""
    y = y * F.silu(z).to(_F32)
    y = rms_norm(y, params.norm)
    return (y @ params.out_proj.to(_F32)).to(dtype)


def ssd_forward(x: torch.Tensor, params: SSMParams, cfg: SSMConfig, *,
                initial_state: torch.Tensor | None = None,
                plain_backward: bool = False):
    """Full-sequence SSD.  x (B, L, D) with L % chunk == 0.

    Returns (y (B, L, D), final state (B, H, N, P) fp32).  Differentiable:
    the intra-chunk term through its backward kernel on the card (its
    plain version with ``plain_backward``), the rest plain autograd."""
    y, final, _tail = _mix(x, params, cfg, None, initial_state,
                           plain_backward)
    return y, final


def ssd_prefill(x: torch.Tensor, state: SSMState, params: SSMParams,
                cfg: SSMConfig):
    """Chunked prefill of a (B, C, D) block from the carried state.

    C must be a multiple of ``cfg.chunk``.  Continues the SSM state and the
    conv tail; like the reference, every position of the block (padding
    included) runs into the state and ``length`` advances by C."""
    y, final, tail = _mix(x, params, cfg, state.conv, state.s)
    return y, SSMState(final, tail, state.length + x.shape[1])


def ssd_decode(x: torch.Tensor, state: SSMState, params: SSMParams,
               cfg: SSMConfig):
    """One-token decode.  x (B, 1, D)."""
    B = x.shape[0]
    H, P, N, G = cfg.n_heads, cfg.headdim, cfg.d_state, cfg.n_groups
    z, xbc, dt = _split_proj(x @ params.in_proj, cfg)
    xbc, new_tail = _causal_conv(xbc, params.conv_w, params.conv_b,
                                 state.conv)
    di = cfg.d_inner
    xs = xbc[..., :di].reshape(B, H, P)
    rep = H // G
    Bh = xbc[..., di:di + G * N].reshape(B, G, N).repeat_interleave(rep, dim=1)
    Ch = xbc[..., di + G * N:].reshape(B, G, N).repeat_interleave(rep, dim=1)
    dtv = F.softplus(dt.to(_F32)[:, 0, :] + params.dt_bias)   # (B, H)
    decay = torch.exp(dtv * (-torch.exp(params.a_log))[None, :])
    s_new = (state.s * decay[:, :, None, None]
             + torch.einsum("bh,bhn,bhp->bhnp", dtv, Bh.to(_F32),
                            xs.to(_F32)))
    y = torch.einsum("bhn,bhnp->bhp", Ch.to(_F32), s_new)
    y = y + xs.to(_F32) * params.d_skip[None, :, None]
    return (_out(y.reshape(B, 1, di), z, params, x.dtype),
            SSMState(s_new, new_tail, state.length + 1))
