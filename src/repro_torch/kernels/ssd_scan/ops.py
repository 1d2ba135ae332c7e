"""SSD chunk scan: a hand-written Hopper kernel for the intra-chunk term and
its plain version.

``ssd_intra_chunk`` replaces ``repro.kernels.ssd_scan.kernel.
ssd_intra_chunk_pallas``: per (batch, chunk, head) it computes the masked
quadratic term ``y`` of the Mamba-2 SSD scan, the chunk state ``S`` and the
chunk decay.  The CUDA source is ``csrc/ssd_scan.cu``; its header says what
bounds the kernel on an H100 and what the design does about it.

``ssd_chunk_scan`` is the whole scan, as ``repro.kernels.ssd_scan.ops.
ssd_chunk_scan``: the intra-chunk kernel, then the sequential recurrence of
the chunk states and the inter-chunk term in plain PyTorch (the JAX package
leaves those two to XLA as well).  It computes the same function as
``repro.models.ssm._ssd_chunk_scan_ref``.

Dispatch is by the tensors' device only: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises.  The wrapper counts
its launches in ``ssd_intra_chunk.launches``.

Gradients.  With a gradient required of any input, ``ssd_intra_chunk``
runs as an autograd Function: on the card its backward is
``ssd_intra_chunk_bwd`` (``csrc/ssd_scan_bwd.cu``, counted in
``ssd_intra_chunk_bwd.launches``), which takes the forward's input types,
bf16 or fp32 ``xs``/``Bm``/``Cm`` with fp32 ``dt``/``da``, and raises a
``TypeError`` on anything else; on the CPU it is
``ssd_intra_chunk_bwd_ref``, the same closed form in plain PyTorch.  With
``plain_backward=True`` the backward is autograd through
``ssd_intra_chunk_ref`` (recomputed), the card's in-place check of the
kernel.  The JAX package has no backward kernel: XLA differentiates its
plain SSD path.

Shapes: xs (B, nc, Q, H, P); Bm/Cm (B, nc, Q, H, N) in fp32 or bf16;
dt/da (B, nc, Q, H) fp32.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary

__all__ = ["ssd_intra_chunk", "ssd_intra_chunk_ref", "ssd_intra_chunk_bwd",
           "ssd_intra_chunk_bwd_ref", "ssd_chunk_scan", "ssd_chunk_scan_ref",
           "BWD_DIMS", "LIBRARY", "LIBRARY_BWD"]

LIBRARY = KernelLibrary("ssd_scan",
                        Path(__file__).parent / "csrc" / "ssd_scan.cu")
LIBRARY_BWD = KernelLibrary(
    "ssd_scan_bwd", Path(__file__).parent / "csrc" / "ssd_scan_bwd.cu")
# (head dim P, state N) pairs the backward kernel takes (Jamba's,
# Mamba2-130M's and the reduced configurations'), at chunks of at most
# BWD_MAX_Q positions.
BWD_DIMS = ((64, 16), (64, 128), (16, 16))
BWD_MAX_Q = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535


def ssd_intra_chunk_ref(xs, Bm, Cm, dt, da):
    """Plain version of the kernel: (y (B,nc,Q,H,P), S (B,nc,H,N,P),
    decay (B,nc,H)), all fp32."""
    f32 = torch.float32
    x, b, c = xs.to(f32), Bm.to(f32), Cm.to(f32)
    dt, da = dt.to(f32), da.to(f32)
    Q = xs.shape[2]
    cum = torch.cumsum(da, dim=2)                           # (B,nc,Q,H)
    # L[i,j] = exp(cum_i - cum_j) for j <= i; the exponent is masked before
    # exp so masked entries cannot overflow.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Qi,Qj,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xs.device).tril()
    decay = torch.exp(diff.masked_fill(~mask[None, None, :, :, None], -1e9))
    cb = torch.einsum("bcqhn,bckhn->bcqkh", c, b)
    w = cb * decay * dt[:, :, None, :, :]
    y = torch.einsum("bcqkh,bckhp->bcqhp", w, x)
    last = cum[:, :, -1:, :]
    wj = torch.exp(last - cum) * dt                         # (B,nc,Q,H)
    S = torch.einsum("bcqhn,bcqhp->bchnp", b * wj[..., None], x)
    return y, S, torch.exp(last[:, :, 0, :])


def _is_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for CPU (plain version)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no SSD chunk scan for device {x.device}")


@functools.lru_cache(maxsize=None)
def _fwd_launcher():
    """The forward's C entry point with its argument types (set once)."""
    fn = LIBRARY.load().ssd_intra_chunk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 20
                   + [ctypes.c_void_p])
    return fn


def _launch(xs, Bm, Cm, dt, da):
    """Validate, allocate the outputs and launch on the current stream."""
    if xs.dim() != 5 or Bm.dim() != 5 or dt.dim() != 4:
        raise ValueError("expected xs (B,nc,Q,H,P), Bm/Cm (B,nc,Q,H,N), "
                         "dt/da (B,nc,Q,H)")
    B, nc, Q, H, P = xs.shape
    N = Bm.shape[-1]
    if (tuple(Bm.shape) != (B, nc, Q, H, N) or Cm.shape != Bm.shape
            or tuple(dt.shape) != (B, nc, Q, H) or da.shape != dt.shape):
        raise ValueError(f"shape mismatch: xs {tuple(xs.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, dt "
                         f"{tuple(dt.shape)}, da {tuple(da.shape)}")
    if xs.dtype not in _DTYPE_CODE or Bm.dtype != xs.dtype or \
            Cm.dtype != xs.dtype:
        raise TypeError("xs, Bm and Cm must share one dtype, fp32 or bf16")
    if dt.dtype != torch.float32 or da.dtype != torch.float32:
        raise TypeError("dt and da must be fp32")
    if any(t.device != xs.device for t in (Bm, Cm, dt, da)):
        raise ValueError("SSD chunk scan operands must share one device")
    if any(t.stride(-1) != 1 for t in (xs, Bm, Cm)):
        raise ValueError("xs, Bm and Cm need a unit-stride last dim")
    if nc > _MAX_GRID_YZ or B > _MAX_GRID_YZ:
        raise ValueError(f"grid too large for B={B}, nc={nc}")
    f32 = dict(dtype=torch.float32, device=xs.device)
    y = torch.empty((B, nc, Q, H, P), **f32)
    S = torch.empty((B, nc, H, N, P), **f32)
    dec = torch.empty((B, nc, H), **f32)
    if y.numel() == 0 or S.numel() == 0:
        return y, S, dec, False
    strides = [s for t in (xs, Bm, Cm, dt, da) for s in t.stride()[:4]]
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = _fwd_launcher()(
        _DTYPE_CODE[xs.dtype], xs.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        dt.data_ptr(), da.data_ptr(), y.data_ptr(), S.data_ptr(),
        dec.data_ptr(), B, nc, Q, H, P, N, *strides, stream)
    if err != 0:
        smem = LIBRARY.load().ssd_intra_chunk_smem_bytes
        smem.restype = ctypes.c_longlong
        smem.argtypes = [ctypes.c_int] * 4
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed: CUDA "
                           f"error {err} (Q={Q}, P={P}, N={N} need "
                           f"{smem(_DTYPE_CODE[xs.dtype], Q, P, N)} B of "
                           f"shared memory per block)")
    return y, S, dec, True


def ssd_intra_chunk(xs, Bm, Cm, dt, da, *, plain_backward: bool = False):
    """Intra-chunk SSD term, chunk states and chunk decays (all fp32);
    differentiable (see the module's notes)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xs, Bm, Cm, dt, da)):
        return _SSDIntraChunk.apply(xs, Bm, Cm, dt, da, plain_backward)
    if not _is_cuda(xs):
        return ssd_intra_chunk_ref(xs, Bm, Cm, dt, da)
    y, S, dec, launched = _launch(xs, Bm, Cm, dt, da)
    if launched:
        ssd_intra_chunk.launches += 1
    return y, S, dec


ssd_intra_chunk.launches = 0


# ---------------------------------------------------------------- backward

def ssd_intra_chunk_bwd_ref(xs, Bm, Cm, dt, da, dy, dS, ddec):
    """(dxs, dBm, dCm, ddt, dda) of :func:`ssd_intra_chunk_ref` given the
    cotangents of y (B,nc,Q,H,P), S (B,nc,H,N,P) and decay (B,nc,H), in
    closed form (the kernel's arithmetic, step by step): dW = dY x^T on
    the causal triangle, G = dW L dt_j, dx = W^T dY + w_j B_j dS, dC = G B,
    dB = G^T C + w_j dS x_j, ddt and dcum from the masked products, da the
    reverse cumsum of dcum.  Masked entries are exact zeros (no exp of a
    positive exponent is taken).  dxs, dBm, dCm in the inputs' dtypes."""
    f32 = torch.float32
    x, b, c = xs.to(f32), Bm.to(f32), Cm.to(f32)
    dt, da = dt.to(f32), da.to(f32)
    dy, dS, ddec = dy.to(f32), dS.to(f32), ddec.to(f32)
    Q = xs.shape[2]
    cum = torch.cumsum(da, dim=2)                           # (B,nc,Q,H)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Qi,Qj,H)
    mask = torch.ones((Q, Q), dtype=torch.bool,
                      device=xs.device).tril()[None, None, :, :, None]
    L = torch.where(mask, torch.exp(diff.masked_fill(~mask, 0.0)), 0.0)
    cb = torch.einsum("bcqhn,bckhn->bcqkh", c, b)
    Ld = L * dt[:, :, None, :, :]
    W = cb * Ld
    dW = torch.einsum("bcqhp,bckhp->bcqkh", dy, x) * mask
    G = dW * Ld
    M = dW * W
    last = cum[:, :, -1:, :]
    ej = torch.exp(last - cum)
    wj = ej * dt                                            # (B,nc,Q,H)
    u = torch.einsum("bchnp,bcqhp->bcqhn", dS, x)           # dS x_j
    dwj = (b * u).sum(-1)
    dx = (torch.einsum("bcqkh,bcqhp->bckhp", W, dy)
          + wj[..., None] * torch.einsum("bcqhn,bchnp->bcqhp", b, dS))
    dC = torch.einsum("bcqkh,bckhn->bcqhn", G, b)
    dB = torch.einsum("bcqkh,bcqhn->bckhn", G, c) + wj[..., None] * u
    ddt = (dW * cb * L).sum(dim=2) + dwj * ej
    dcum = M.sum(dim=3) - M.sum(dim=2) - dwj * wj
    dcum[:, :, -1] += (dwj * wj).sum(dim=2) + ddec * torch.exp(last[:, :, 0])
    dda = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    return dx.to(xs.dtype), dB.to(Bm.dtype), dC.to(Cm.dtype), ddt, dda


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    """The backward's C entry point with its argument types (set once)."""
    fn = LIBRARY_BWD.load().ssd_intra_chunk_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 13
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return fn


def _bwd_contract(xs, Bm, Cm, dt, da, dy, dS, ddec) -> None:
    """What the backward kernel takes, checked before any launch: xs, Bm,
    Cm all bf16 or all fp32 with fp32 dt and da (else ``TypeError``), (P,
    N) in ``BWD_DIMS``, Q at most ``BWD_MAX_Q`` and the shapes of one call
    (else ``ValueError``)."""
    if xs.dtype not in _DTYPE_CODE or Bm.dtype != xs.dtype or \
            Cm.dtype != xs.dtype or dt.dtype != torch.float32 or \
            da.dtype != torch.float32:
        raise TypeError(f"the SSD backward kernel takes xs, Bm, Cm all bf16 "
                        f"or all fp32 and fp32 dt, da, not {xs.dtype}, "
                        f"{Bm.dtype}, {Cm.dtype}, {dt.dtype}, {da.dtype}")
    B, nc, Q, H, P = xs.shape
    N = Bm.shape[-1]
    if (P, N) not in BWD_DIMS or Q > BWD_MAX_Q or \
            tuple(Bm.shape) != (B, nc, Q, H, N) or Cm.shape != Bm.shape or \
            tuple(dt.shape) != (B, nc, Q, H) or da.shape != dt.shape or \
            tuple(dy.shape) != (B, nc, Q, H, P) or \
            tuple(dS.shape) != (B, nc, H, N, P) or \
            tuple(ddec.shape) != (B, nc, H):
        raise ValueError(f"the SSD backward kernel takes (P, N) in "
                         f"{BWD_DIMS} and Q <= {BWD_MAX_Q}, not xs "
                         f"{tuple(xs.shape)}, Bm {tuple(Bm.shape)}")


def ssd_intra_chunk_bwd(xs, Bm, Cm, dt, da, dy, dS, ddec):
    """(dxs, dBm, dCm, ddt, dda) of the intra-chunk term: on the card one
    launch of ``csrc/ssd_scan_bwd.cu``, on the CPU the closed form
    :func:`ssd_intra_chunk_bwd_ref`.  The kernel takes xs, Bm, Cm all bf16
    or all fp32 with fp32 dt and da, (P, N) in ``BWD_DIMS`` and chunks of
    at most ``BWD_MAX_Q``, and raises on anything else."""
    if not _is_cuda(xs):
        return ssd_intra_chunk_bwd_ref(xs, Bm, Cm, dt, da, dy, dS, ddec)
    _bwd_contract(xs, Bm, Cm, dt, da, dy, dS, ddec)
    B, nc, Q, H, P = xs.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    xs, Bm, Cm, dt, da = (t.contiguous() for t in (xs, Bm, Cm, dt, da))
    dy, dS, ddec = (t.to(f32).contiguous() for t in (dy, dS, ddec))
    dx, dB, dC = (torch.empty_like(t) for t in (xs, Bm, Cm))
    ddt, dda = torch.empty_like(dt), torch.empty_like(da)
    if xs.numel() == 0:
        return dx, dB, dC, ddt.zero_(), dda.zero_()
    err = _bwd_launcher()(
        _DTYPE_CODE[xs.dtype], *(t.data_ptr() for t in (
            xs, Bm, Cm, dt, da, dy, dS, ddec, dx, dB, dC, ddt, dda)),
        B, nc, Q, H, P, N, torch.cuda.current_stream(xs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk_bwd launch failed: CUDA error "
                           f"{err}")
    ssd_intra_chunk_bwd.launches += 1
    return dx, dB, dC, ddt, dda


ssd_intra_chunk_bwd.launches = 0


def _plain_bwd(xs, Bm, Cm, dt, da, dy, dS, ddec):
    """Autograd through :func:`ssd_intra_chunk_ref` (recomputed)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (xs, Bm, Cm, dt, da)]
        outs = ssd_intra_chunk_ref(*leaves)
        return torch.autograd.grad(outs, leaves, (dy, dS, ddec))


class _SSDIntraChunk(torch.autograd.Function):
    """The intra-chunk term with its backward kernel; saves the inputs."""

    @staticmethod
    def forward(ctx, xs, Bm, Cm, dt, da, plain_backward):
        if _is_cuda(xs):
            y, S, dec, launched = _launch(xs, Bm, Cm, dt, da)
            if launched:
                ssd_intra_chunk.launches += 1
        else:
            y, S, dec = ssd_intra_chunk_ref(xs, Bm, Cm, dt, da)
        ctx.save_for_backward(xs, Bm, Cm, dt, da)
        ctx.plain_backward = plain_backward
        return y, S, dec

    @staticmethod
    def backward(ctx, dy, dS, ddec):
        xs, Bm, Cm, dt, da = ctx.saved_tensors
        B, nc, Q, H, P = xs.shape
        N = Bm.shape[-1]
        z = dict(dtype=torch.float32, device=xs.device)
        dy = torch.zeros((B, nc, Q, H, P), **z) if dy is None else dy
        dS = torch.zeros((B, nc, H, N, P), **z) if dS is None else dS
        ddec = torch.zeros((B, nc, H), **z) if ddec is None else ddec
        bwd = _plain_bwd if ctx.plain_backward else ssd_intra_chunk_bwd
        return (*bwd(xs, Bm, Cm, dt, da, dy, dS, ddec), None)


def _chunk_scan(intra, xs, Bm, Cm, dt, da, initial_state):
    B, nc, Q, H, P = xs.shape
    N = Bm.shape[-1]
    y_intra, S_c, chunk_decay = intra(xs, Bm, Cm, dt, da)
    s = (torch.zeros((B, H, N, P), dtype=torch.float32, device=xs.device)
         if initial_state is None else initial_state.to(torch.float32))
    prev = []
    for c in range(nc):                    # the sequential recurrence
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + S_c[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (B,nc,H,N,P)
    cum = torch.cumsum(da.to(torch.float32), dim=2)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           Cm.to(torch.float32) * torch.exp(cum)[..., None],
                           prev_states)
    return y_intra + y_inter, s


def ssd_chunk_scan(xs, Bm, Cm, dt, da, initial_state=None, *,
                   plain_backward: bool = False):
    """Full SSD scan from ``initial_state`` (B, H, N, P) or zeros.

    Returns (y (B,nc,Q,H,P) fp32, final state (B,H,N,P) fp32).  Under a
    gradient the intra-chunk term runs through its backward kernel (the
    module's notes); the recurrence and the inter-chunk term are plain
    autograd."""
    intra = functools.partial(ssd_intra_chunk, plain_backward=plain_backward)
    return _chunk_scan(intra, xs, Bm, Cm, dt, da, initial_state)


def ssd_chunk_scan_ref(xs, Bm, Cm, dt, da, initial_state=None):
    """Plain version of :func:`ssd_chunk_scan` (never launches a kernel)."""
    return _chunk_scan(ssd_intra_chunk_ref, xs, Bm, Cm, dt, da,
                       initial_state)
