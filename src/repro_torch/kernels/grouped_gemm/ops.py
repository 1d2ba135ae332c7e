"""Grouped GEMM ops: hand-written Hopper kernels and their plain versions.

``grouped_swiglu`` replaces ``repro.kernels.grouped_gemm.kernel.
grouped_swiglu_pallas`` and ``grouped_matmul`` replaces
``grouped_matmul_pallas`` (the two Pallas kernels on the MoE expert path,
``repro.moe.expert.grouped_ffn`` with ``use_kernel=True``).  The CUDA source
is ``csrc/grouped_gemm.cu``; its header says what bounds each kernel on an
H100 and what the design does about it.

Dispatch is by the tensors' device only: a CPU tensor runs the plain
PyTorch version (an fp32 einsum, then a cast), a CUDA tensor launches the
kernel or raises -- there is no size-based fallback and no ``try`` around
the launch.  Unlike the JAX wrappers, nothing is padded: the kernel masks
ragged M, N and K edges itself.  Each wrapper counts its launches in a
plain int attribute, ``grouped_swiglu.launches`` / ``grouped_matmul.launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import KernelLibrary

__all__ = ["grouped_swiglu", "grouped_matmul", "grouped_swiglu_ref",
           "grouped_matmul_ref", "LIBRARY"]

LIBRARY = KernelLibrary("grouped_gemm",
                        Path(__file__).parent / "csrc" / "grouped_gemm.cu")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_M = {torch.float32: 64, torch.bfloat16: 128}   # rows per block
_MAX_GRID_YZ = 65535


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (G, M, K) @ w: (G, K, N) -> (G, M, N); fp32 accumulation, cast."""
    out = torch.einsum("gmk,gkn->gmn", x.to(torch.float32), w.to(torch.float32))
    return out.to(x.dtype)


def grouped_swiglu_ref(x: torch.Tensor, w1: torch.Tensor,
                       w3: torch.Tensor) -> torch.Tensor:
    """silu(x@w1) * (x@w3) per group, fp32 accumulation and gating, cast."""
    xf = x.to(torch.float32)
    h = torch.einsum("gmk,gkn->gmn", xf, w1.to(torch.float32))
    g = torch.einsum("gmk,gkn->gmn", xf, w3.to(torch.float32))
    return (F.silu(h) * g).to(x.dtype)


def _launch(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor | None,
            *, swiglu: bool) -> torch.Tensor:
    """Validate, allocate the output and launch on the current stream."""
    for t in (w1,) if w3 is None else (w1, w3):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError("grouped GEMM operands must share device and dtype")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"grouped GEMM kernels take fp32 or bf16, not {x.dtype}")
    if x.dim() != 3 or w1.dim() != 3:
        raise ValueError("expected x (G, M, K) and w (G, K, N)")
    G, M, K = x.shape
    if w1.shape[0] != G or w1.shape[1] != K or (
            w3 is not None and w3.shape != w1.shape):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w1.shape)}")
    N = w1.shape[2]
    if x.stride(2) != 1 or w1.stride(2) != 1 or (
            w3 is not None and w3.stride() != w1.stride()):
        raise ValueError("grouped GEMM operands need a unit-stride last dim "
                         "(and w1, w3 with equal strides)")
    if G > _MAX_GRID_YZ or -(-M // _BLOCK_M[x.dtype]) > _MAX_GRID_YZ:
        raise ValueError(f"grid too large for G={G}, M={M}")
    out = torch.empty((G, M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = LIBRARY.load().grouped_gemm_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6
                   + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    w3_ptr = (w1 if w3 is None else w3).data_ptr()
    err = fn(_DTYPE_CODE[x.dtype], int(swiglu), x.data_ptr(), w1.data_ptr(),
             w3_ptr, out.data_ptr(), G, M, K, N, x.stride(0), x.stride(1),
             w1.stride(0), w1.stride(1), out.stride(0), out.stride(1), stream)
    if err != 0:
        raise RuntimeError(f"grouped_gemm kernel launch failed: CUDA error {err}")
    return out


def _check_device(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for CPU (plain version)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no grouped GEMM for device {x.device}")


def grouped_swiglu(x: torch.Tensor, w1: torch.Tensor,
                   w3: torch.Tensor) -> torch.Tensor:
    """Fused ``silu(x@w1) * (x@w3)``: x (G, M, K), w1/w3 (G, K, N) -> (G, M, N)."""
    if not _check_device(x):
        return grouped_swiglu_ref(x, w1, w3)
    out = _launch(x, w1, w3, swiglu=True)
    if out.numel():
        grouped_swiglu.launches += 1
    return out


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped matmul: x (G, M, K) @ w (G, K, N) -> (G, M, N)."""
    if not _check_device(x):
        return grouped_matmul_ref(x, w)
    out = _launch(x, w, None, swiglu=False)
    if out.numel():
        grouped_matmul.launches += 1
    return out


grouped_swiglu.launches = 0
grouped_matmul.launches = 0
