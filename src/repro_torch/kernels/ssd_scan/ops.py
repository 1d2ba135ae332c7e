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

Shapes: xs (B, nc, Q, H, P); Bm/Cm (B, nc, Q, H, N) in fp32 or bf16;
dt/da (B, nc, Q, H) fp32.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary

__all__ = ["ssd_intra_chunk", "ssd_intra_chunk_ref", "ssd_chunk_scan",
           "ssd_chunk_scan_ref", "LIBRARY"]

LIBRARY = KernelLibrary("ssd_scan",
                        Path(__file__).parent / "csrc" / "ssd_scan.cu")

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
    lib = LIBRARY.load()
    fn = lib.ssd_intra_chunk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 20
                   + [ctypes.c_void_p])
    strides = [s for t in (xs, Bm, Cm, dt, da) for s in t.stride()[:4]]
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = fn(_DTYPE_CODE[xs.dtype], xs.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), dt.data_ptr(), da.data_ptr(), y.data_ptr(),
             S.data_ptr(), dec.data_ptr(), B, nc, Q, H, P, N, *strides,
             stream)
    if err != 0:
        smem = lib.ssd_intra_chunk_smem_bytes
        smem.restype = ctypes.c_longlong
        smem.argtypes = [ctypes.c_int] * 4
        raise RuntimeError(f"ssd_intra_chunk kernel launch failed: CUDA "
                           f"error {err} (Q={Q}, P={P}, N={N} need "
                           f"{smem(_DTYPE_CODE[xs.dtype], Q, P, N)} B of "
                           f"shared memory per block)")
    return y, S, dec, True


def ssd_intra_chunk(xs, Bm, Cm, dt, da):
    """Intra-chunk SSD term, chunk states and chunk decays (all fp32).
    No backward kernel yet: on the card a gradient through it raises (on
    the CPU the plain version is differentiable)."""
    if not _is_cuda(xs):
        return ssd_intra_chunk_ref(xs, Bm, Cm, dt, da)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xs, Bm, Cm, dt, da)):
        raise ValueError("ssd_intra_chunk has no backward kernel: the SSD "
                         "backward is not ported to the card")
    y, S, dec, launched = _launch(xs, Bm, Cm, dt, da)
    if launched:
        ssd_intra_chunk.launches += 1
    return y, S, dec


ssd_intra_chunk.launches = 0


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


def ssd_chunk_scan(xs, Bm, Cm, dt, da, initial_state=None):
    """Full SSD scan from ``initial_state`` (B, H, N, P) or zeros.

    Returns (y (B,nc,Q,H,P) fp32, final state (B,H,N,P) fp32)."""
    return _chunk_scan(ssd_intra_chunk, xs, Bm, Cm, dt, da, initial_state)


def ssd_chunk_scan_ref(xs, Bm, Cm, dt, da, initial_state=None):
    """Plain version of :func:`ssd_chunk_scan` (never launches a kernel)."""
    return _chunk_scan(ssd_intra_chunk_ref, xs, Bm, Cm, dt, da,
                       initial_state)
