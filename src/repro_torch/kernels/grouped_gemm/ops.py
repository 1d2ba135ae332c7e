"""Grouped GEMM ops: hand-written Hopper kernels and their plain versions.

``grouped_swiglu`` replaces ``repro.kernels.grouped_gemm.kernel.
grouped_swiglu_pallas`` and ``grouped_matmul`` replaces
``grouped_matmul_pallas`` (the two Pallas kernels on the MoE expert path,
``repro.moe.expert.grouped_ffn`` with ``use_kernel=True``); their CUDA source
is ``csrc/grouped_gemm.cu``.  ``grouped_swiglu_q8`` and ``grouped_matmul_q8``
replace ``grouped_swiglu_q8_pallas`` and ``grouped_matmul_q8_pallas`` (the
w8a8 path, ``ffn_dtype="int8"``); their source is ``csrc/grouped_gemm_q8.cu``.
Each source's header says what bounds its kernels on an H100 and what the
design does about it.

Dispatch is by the tensors' device only: a CPU tensor runs the plain
PyTorch version (an fp32 einsum, then a cast), a CUDA tensor launches the
kernel or raises -- there is no size-based fallback and no ``try`` around
the launch.  Each wrapper counts its launches in a plain int attribute,
``grouped_swiglu.launches`` / ``grouped_matmul.launches`` (and the same on
the q8 pair).

Row counts.  ``grouped_swiglu(x, w1, w3, rows=None)``,
``grouped_matmul(x, w, rows=None)``, ``grouped_swiglu_q8(q, row_scale,
w1q, w1s, w3q, w3s, rows=None)`` and ``grouped_matmul_q8(q, row_scale, wq,
col_scale, rows=None, out_dtype=torch.float32)`` take ``rows``, an int32 or
int64 (G,) tensor on the activations' device: slot g's rows ``[0,
min(rows[g], M))`` are computed and every row at or past that comes out as
exact zeros, whatever the activations (and, for q8, the row scales) hold
there; ``None`` means M for every slot.  The kernels, bf16, fp32 and
int8 alike, read the counts on the device (no host sync) and skip the
padded rows' work: a tile past a slot's count loads nothing, so a slot
with no rows costs no weight bytes.  The plain versions take the same
``rows`` and mask the same way.  ``grouped_matmul_q8`` writes fp32 or, with
``out_dtype=torch.bfloat16``, the same values rounded to bf16 (equal to
the fp32 result cast, bitwise).

Alignment.  Every kernel reads its operands with TMA, which needs a
16-byte aligned base and outer strides that are multiples of 16 bytes (4
fp32, 8 bf16, 16 int8 codes).  An operand that is not (a width that is
not a multiple of 16 bytes, a view of unpadded int8 wire rows, D + 4
bytes apart, or a view that starts mid-row) is first copied into a
zero-padded buffer with its last dim rounded up to 16 bytes -- the same
kernel on padded operands, counted in ``padded_copies`` on each wrapper.
No serve path makes such a copy: every model width is a multiple of 16
and the bucket pads the int8 wire's rows to 16 bytes
(:func:`repro_torch.moe.permute.fused_bucket`).  The fp32 and bf16
outputs have their width rounded up to 16 bytes and are returned as a
view of the first N columns; TMA zero-fills the ragged M, N and K edges.

fp32 runs its products on the tensor cores in 3xTF32 (each operand split
into a TF32 part and the rest; see the source's header): each product
keeps about 2^-20 where fp32 keeps 2^-24, within 1e-4 of max|ref|.

Gradients (bf16 and fp32 on the card; any float dtype on the CPU).  With
a gradient required, ``grouped_swiglu`` and ``grouped_matmul`` run as
autograd Functions: the forward kernel as above, and a backward of three
more kernels (the JAX package has none: XLA differentiates its einsums),
each with a plain version and a launch count (by dtype in
``launches_by_kernel``): in bf16 those of ``csrc/grouped_gemm.cu`` below,
in fp32 those of ``csrc/grouped_gemm_bwd_f32.cu`` (3xTF32 on TF32
``wgmma``, one operand split once into TF32 planes, the other split in
registers; warp specialised, a persistent grid over the 128-row tiles
that hold rows; the wgrad in row chunks where its output tiles are fewer
than the SMs,
:func:`wgrad_f32_chunk`; the trainer's default dtype; G at most 512):

* ``grouped_swiglu_bwd(x, w1, w3, dact, rows, zero_padded=True)`` ->
  (dh, dg): the SwiGLU's h = x w1 and g = x w3 recomputed from one read of
  each x tile, and dh = dact g s (1 + h (1 - s)), dg = dact h s with
  s = sigmoid(h); a persistent kernel over the row tiles that hold rows
  (:func:`swiglu_bwd_tiles` gives their order);
* ``grouped_matmul_nt(x, w, rows, x2=None, w2=None, zero_padded=True)``
  -> x w^T (+ x2 w2^T) with w stored (G, N, K), K-contiguous (the weights
  as they are kept: dact = dy w2^T and dx = dh w1^T + dg w3^T); a
  persistent kernel over the row tiles that hold rows
  (:func:`matmul_nt_tiles` gives their order);
* ``grouped_wgrad(x, d, rows)`` -> (G, K, N): x[g, :rows[g]]^T d[g, :rows[g]]
  over each slot's valid rows only, fp32 accumulation, x's dtype; a
  persistent kernel over every (slot, K tile, N tile) (:func:`wgrad_tiles`).

Rows past a slot's count come out as exact zeros in every output, and its
gradients are zero there; with ``zero_padded=False`` the SwiGLU backward
and the dgrad leave the rows from the count rounded up to 64 (bf16) or
128 (fp32) on unwritten on the card (what the autograd backward does).  Every reader of those
rows selects the valid ones and never multiplies a padded one into a
valid result, NaN included: dh and dg are read by ``grouped_matmul_nt``
and ``grouped_wgrad``; dact (the matmul's dgrad) by the SwiGLU backward,
which selects zero past the count; dx (the SwiGLU's dgrad, the slot
buffers' gradient) by the dispatch's backward, which gathers the valid
rows only (``moe.permute.gather_rows`` / ``ordered_row_sum``, the
reference engine's ``moe.dispatch.bucket_by_slot``, the ``torch.where``
of a masked call).  The SwiGLU saves x and recomputes h and g; the
matmul saves its input (the activations, ``act``).  ``plain_backward=True``
runs the backward as autograd through the plain forward instead, on any
device (a check of the kernels in place: the forward is the same).  On the
card the backward kernels take bf16 or fp32 with K and N multiples of 8
and raise a ``ValueError`` on anything else before any launch.

The q8 plain versions contract in fp64, which is exact here (every partial
sum is an integer below 2^53), and convert to int32: CUDA has no int32
``bmm``, and this keeps them exact on the card as on the CPU.  The q8
kernels take the weight codes K-contiguous, ``(G, N, K)`` storage passed as
a ``(G, K, N)`` view, the layout ``repro_torch.moe.layer.MoEParams`` keeps.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import KernelLibrary

__all__ = ["grouped_swiglu", "grouped_matmul", "grouped_swiglu_ref",
           "grouped_matmul_ref", "grouped_swiglu_q8", "grouped_matmul_q8",
           "grouped_swiglu_q8_ref", "grouped_matmul_q8_ref",
           "grouped_swiglu_bwd", "grouped_swiglu_bwd_ref",
           "grouped_matmul_nt", "grouped_matmul_nt_ref", "grouped_wgrad",
           "grouped_wgrad_ref", "swiglu_bwd_tiles", "matmul_nt_tiles",
           "wgrad_tiles", "wgrad_f32_chunk", "LIBRARY",
           "LIBRARY_Q8", "LIBRARY_BWD_F32"]

LIBRARY = KernelLibrary("grouped_gemm",
                        Path(__file__).parent / "csrc" / "grouped_gemm.cu")
LIBRARY_Q8 = KernelLibrary(
    "grouped_gemm_q8", Path(__file__).parent / "csrc" / "grouped_gemm_q8.cu")
LIBRARY_BWD_F32 = KernelLibrary(
    "grouped_gemm_bwd_f32",
    Path(__file__).parent / "csrc" / "grouped_gemm_bwd_f32.cu")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _out_width(N: int, elt: int) -> int:
    """The kernels' output row width: N elements of ``elt`` bytes rounded
    up to 16 bytes."""
    m = 16 // elt
    return -(-N // m) * m


def _row_mask(rows: torch.Tensor, M: int) -> torch.Tensor:
    """(G, M, 1) bool: row p of slot g is valid iff p < rows[g]."""
    p = torch.arange(M, device=rows.device)
    return (p[None, :] < rows[:, None])[:, :, None]


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' arithmetic: fp32, or fp64 for fp64 operands."""
    return torch.promote_types(dtype, torch.float32)


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       rows: torch.Tensor | None = None) -> torch.Tensor:
    """x: (G, M, K) @ w: (G, K, N) -> (G, M, N); fp32 accumulation, cast.
    Rows at or past ``rows[g]`` are zero."""
    acc = _acc(x.dtype)
    out = torch.einsum("gmk,gkn->gmn", x.to(acc), w.to(acc))
    if rows is not None:
        out = torch.where(_row_mask(rows, x.shape[1]), out, 0.0)
    return out.to(x.dtype)


def grouped_swiglu_ref(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                       rows: torch.Tensor | None = None) -> torch.Tensor:
    """silu(x@w1) * (x@w3) per group, fp32 accumulation and gating, cast.
    Rows at or past ``rows[g]`` are zero."""
    acc = _acc(x.dtype)
    xf = x.to(acc)
    h = torch.einsum("gmk,gkn->gmn", xf, w1.to(acc))
    g = torch.einsum("gmk,gkn->gmn", xf, w3.to(acc))
    out = F.silu(h) * g
    if rows is not None:
        out = torch.where(_row_mask(rows, x.shape[1]), out, 0.0)
    return out.to(x.dtype)


def _tma_ready(t: torch.Tensor) -> bool:
    """True when TMA can read ``t`` as it is: a 16-byte aligned base and
    positive outer strides that are multiples of 16 bytes (4 fp32, 8 bf16,
    16 int8 codes)."""
    e = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s > 0 and s * e % 16 == 0 for s in t.stride()[:-1])


def _padded_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a zero buffer whose last dim is rounded up to 16
    bytes, returned as a view of ``t``'s shape."""
    n, m = t.shape[-1], 16 // t.element_size()
    buf = t.new_zeros(*t.shape[:-1], -(-n // m) * m)
    buf[..., :n].copy_(t)
    return buf[..., :n]


def _launch(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor | None,
            rows: torch.Tensor | None, *, swiglu: bool
            ) -> tuple[torch.Tensor, int]:
    """Validate, allocate the output and launch on the current stream.
    Returns the output and the number of operands copied for TMA."""
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
    rows = _check_rows(rows, G, x.device)
    copies = 0
    # w1 and w3 share one pair of strides, so both are copied.
    ws = [w1] if w3 is None else [w1, w3]
    if not all(map(_tma_ready, ws)):
        ws = [_padded_copy(w) for w in ws]
        copies += len(ws)
        w1, w3 = ws[0], (None if w3 is None else ws[1])
    if not _tma_ready(x):
        x = _padded_copy(x)
        copies += 1
    n_out = _out_width(N, x.element_size())
    out = torch.empty((G, M, n_out), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out[..., :N], copies
    fn = LIBRARY.load().grouped_gemm_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4
                   + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    w3_ptr = (w1 if w3 is None else w3).data_ptr()
    err = fn(_DTYPE_CODE[x.dtype], int(swiglu), x.data_ptr(), w1.data_ptr(),
             w3_ptr, out.data_ptr(), None if rows is None else rows.data_ptr(),
             G, M, K, N, n_out, x.stride(0), x.stride(1), w1.stride(0),
             w1.stride(1), stream)
    if err != 0:
        raise RuntimeError(f"grouped_gemm kernel launch failed: error {err} "
                           f"(below 1000 a CUDA error; 1000 no "
                           f"cuTensorMapEncodeTiled; 1001 + CUresult a "
                           f"refused tensor map)")
    return (out if n_out == N else out[..., :N]), copies


def _check_device(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for CPU (plain version)."""
    if x.is_cuda:
        return True
    if x.is_cpu:
        return False
    raise ValueError(f"no grouped GEMM for device {x.device}")


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def grouped_swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                   rows: torch.Tensor | None = None, *,
                   plain_backward: bool = False) -> torch.Tensor:
    """Fused ``silu(x@w1) * (x@w3)``: x (G, M, K), w1/w3 (G, K, N) ->
    (G, M, N); slot g's rows at or past ``rows[g]`` (a (G,) int tensor on
    x's device; None: M) come out zero.  Differentiable in x, w1 and w3;
    on the card x's gradient is left unwritten in the rows from the count
    rounded up to 64 on (its readers select the valid rows)."""
    if _needs_grad(x, w1, w3):
        return _GroupedSwiGLU.apply(x, w1, w3, rows, plain_backward)
    return _swiglu_fwd(x, w1, w3, rows)


def _swiglu_fwd(x, w1, w3, rows):
    if not _check_device(x):
        return grouped_swiglu_ref(x, w1, w3, rows)
    out, copies = _launch(x, w1, w3, rows, swiglu=True)
    grouped_swiglu.padded_copies += copies
    if out.numel():
        grouped_swiglu.launches += 1
    return out


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   rows: torch.Tensor | None = None, *,
                   plain_backward: bool = False) -> torch.Tensor:
    """Grouped matmul: x (G, M, K) @ w (G, K, N) -> (G, M, N); slot g's rows
    at or past ``rows[g]`` come out zero.  Differentiable in x and w; on
    the card x's gradient is left unwritten in the rows from the count
    rounded up to 64 on (its reader, the SwiGLU backward, selects)."""
    if _needs_grad(x, w):
        return _GroupedMatmul.apply(x, w, rows, plain_backward)
    return _matmul_fwd(x, w, rows)


def _matmul_fwd(x, w, rows):
    if not _check_device(x):
        return grouped_matmul_ref(x, w, rows)
    out, copies = _launch(x, w, None, rows, swiglu=False)
    grouped_matmul.padded_copies += copies
    if out.numel():
        grouped_matmul.launches += 1
    return out


def grouped_matmul_q8_ref(q: torch.Tensor, row_scale: torch.Tensor,
                          wq: torch.Tensor, col_scale: torch.Tensor,
                          rows: torch.Tensor | None = None,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """w8a8 grouped matmul: q int8 (G, M, K), row_scale fp32 (G, M), wq int8
    (G, K, N), col_scale fp32 (G, N) -> (G, M, N) = acc * rs * cs in fp32,
    with acc the exact int32 product, cast to ``out_dtype``.  Rows at or
    past ``rows[g]`` are zero."""
    acc = torch.einsum("gmk,gkn->gmn", q.to(torch.float64),
                       wq.to(torch.float64)).to(torch.int32)
    out = (acc.to(torch.float32) * row_scale[:, :, None]
           * col_scale[:, None, :])
    if rows is not None:
        out = torch.where(_row_mask(rows, q.shape[1]), out, 0.0)
    return out.to(out_dtype)


def grouped_swiglu_q8_ref(q: torch.Tensor, row_scale: torch.Tensor,
                          w1q: torch.Tensor, w1s: torch.Tensor,
                          w3q: torch.Tensor, w3s: torch.Tensor,
                          rows: torch.Tensor | None = None) -> torch.Tensor:
    """w8a8 grouped SwiGLU: both contractions int8, gate in fp32.  Rows at
    or past ``rows[g]`` are zero."""
    h = grouped_matmul_q8_ref(q, row_scale, w1q, w1s)
    g = grouped_matmul_q8_ref(q, row_scale, w3q, w3s)
    out = F.silu(h) * g
    if rows is not None:
        out = torch.where(_row_mask(rows, q.shape[1]), out, 0.0)
    return out


def _check_rows(rows: torch.Tensor | None, G: int,
                device: torch.device) -> torch.Tensor | None:
    """``rows`` as the kernels take it: None, or a (G,) int64 tensor on
    ``device`` (an int32 one is converted); raises on anything else."""
    if rows is None:
        return None
    if rows.shape != (G,) or rows.get_device() != device.index or \
            rows.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"rows must be an int32/int64 ({G},) tensor on "
                         f"{device}")
    return rows if rows.dtype is torch.int64 else rows.to(torch.int64)


def _launch_q8(q, row_scale, w1q, w1s, w3q, w3s, rows=None,
               out_dtype=torch.float32, *, swiglu: bool
               ) -> tuple[torch.Tensor, int]:
    """Validate, allocate the output and launch on the current stream.
    Returns the output and the number of operands copied into padded
    buffers (an operand TMA cannot read)."""
    pairs = [(w1q, w1s)] + ([(w3q, w3s)] if swiglu else [])
    if q.dtype != torch.int8 or any(w.dtype != torch.int8 for w, _ in pairs):
        raise TypeError("q8 kernels take int8 codes")
    scales = [row_scale] + [s for _, s in pairs]
    if any(s.dtype != torch.float32 for s in scales):
        raise TypeError("q8 kernels take fp32 scales")
    if out_dtype not in (torch.float32, torch.bfloat16) or (
            swiglu and out_dtype != torch.float32):
        raise TypeError(f"q8 output dtype {out_dtype}: the matmul writes fp32 "
                        f"or bf16, the SwiGLU fp32")
    if any(t.device != q.device for t in scales + [w for w, _ in pairs]):
        raise ValueError("q8 operands must share one device")
    if q.dim() != 3 or w1q.dim() != 3:
        raise ValueError("expected q (G, M, K) and wq (G, K, N)")
    G, M, K = q.shape
    N = w1q.shape[2]
    if w1q.shape != (G, K, N) or row_scale.shape != (G, M) or any(
            w.shape != w1q.shape or w.stride() != w1q.stride()
            or s.shape != (G, N) or s.stride() != w1s.stride()
            for w, s in pairs):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, wq "
                         f"{tuple(w1q.shape)}, row_scale "
                         f"{tuple(row_scale.shape)}, col_scale "
                         f"{tuple(w1s.shape)} (w1/w3 and their scales must "
                         f"also share strides)")
    if q.stride(2) != 1 or w1q.stride(1) != 1 or w1s.stride(1) != 1:
        raise ValueError("q8 kernels need q with a unit-stride K, weight "
                         "codes K-contiguous ((G, N, K) storage viewed as "
                         "(G, K, N)) and column scales with a unit-stride N")
    rows = _check_rows(rows, G, q.device)
    copies = 0
    # Weight codes as (G, N, K) with unit-stride K: TMA reads them when K
    # and the base are 16-byte aligned (every model width is).
    ws = [w.transpose(1, 2) for w, _ in pairs]
    if not all(map(_tma_ready, ws)):
        ws = [_padded_copy(w) for w in ws]
        copies += len(ws)
    if not _tma_ready(q):
        q = _padded_copy(q)
        copies += 1
    out = torch.empty((G, M, N), dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out, copies
    fn = LIBRARY_Q8.load().grouped_gemm_q8_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    s1, s3 = w1s, pairs[-1][1]
    err = fn(int(swiglu), int(out_dtype == torch.bfloat16), q.data_ptr(),
             q.stride(0), q.stride(1), row_scale.data_ptr(),
             row_scale.stride(0), row_scale.stride(1), ws[0].data_ptr(),
             ws[-1].data_ptr(), ws[0].stride(0), ws[0].stride(1),
             s1.data_ptr(), s3.data_ptr(), s1.stride(0), out.data_ptr(),
             None if rows is None else rows.data_ptr(), G, M, K, N, stream)
    if err != 0:
        raise RuntimeError(f"grouped_gemm_q8 kernel launch failed: error {err} "
                           f"(below 1000 a CUDA error; 1000 no "
                           f"cuTensorMapEncodeTiled; 1001 + CUresult a "
                           f"refused tensor map)")
    return out, copies


def grouped_swiglu_q8(q: torch.Tensor, row_scale: torch.Tensor,
                      w1q: torch.Tensor, w1s: torch.Tensor,
                      w3q: torch.Tensor, w3s: torch.Tensor,
                      rows: torch.Tensor | None = None) -> torch.Tensor:
    """w8a8 fused SwiGLU: q (G, M, K) int8 with row scales (G, M), codes
    (G, K, N) with column scales (G, N) -> fp32 (G, M, N); slot g's rows at
    or past ``rows[g]`` (a (G,) int tensor on q's device; None: M) come out
    zero."""
    if not _check_device(q):
        return grouped_swiglu_q8_ref(q, row_scale, w1q, w1s, w3q, w3s, rows)
    out, copies = _launch_q8(q, row_scale, w1q, w1s, w3q, w3s, rows,
                             torch.float32, swiglu=True)
    grouped_swiglu_q8.padded_copies += copies
    if out.numel():
        grouped_swiglu_q8.launches += 1
    return out


def grouped_matmul_q8(q: torch.Tensor, row_scale: torch.Tensor,
                      wq: torch.Tensor, col_scale: torch.Tensor,
                      rows: torch.Tensor | None = None,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """w8a8 grouped matmul: q (G, M, K) int8 with row scales (G, M), codes
    (G, K, N) with column scales (G, N) -> (G, M, N) in ``out_dtype`` (fp32,
    or bf16: the fp32 result rounded to nearest even); slot g's rows at or
    past ``rows[g]`` come out zero."""
    if not _check_device(q):
        return grouped_matmul_q8_ref(q, row_scale, wq, col_scale, rows,
                                     out_dtype)
    out, copies = _launch_q8(q, row_scale, wq, col_scale, None, None, rows,
                             out_dtype, swiglu=False)
    grouped_matmul_q8.padded_copies += copies
    if out.numel():
        grouped_matmul_q8.launches += 1
    return out


# ---------------------------------------------------------------- backward


def grouped_swiglu_bwd_ref(x: torch.Tensor, w1: torch.Tensor,
                           w3: torch.Tensor, dact: torch.Tensor,
                           rows: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dh, dg) of ``act = silu(x@w1) * (x@w3)`` for the gradient ``dact``
    (G, M, N): h and g recomputed in fp32, dh = dact g s (1 + h (1 - s)),
    dg = dact h s with s = sigmoid(h), each cast to x's dtype; zero at or
    past ``rows[g]``."""
    acc = _acc(x.dtype)
    xf = x.to(acc)
    h = torch.einsum("gmk,gkn->gmn", xf, w1.to(acc))
    g = torch.einsum("gmk,gkn->gmn", xf, w3.to(acc))
    da = dact.to(acc)
    sg = torch.sigmoid(h)
    dg = da * h * sg
    dh = da * g * sg * (1 + h * (1 - sg))
    if rows is not None:
        keep = _row_mask(rows, x.shape[1])
        dh, dg = torch.where(keep, dh, 0.0), torch.where(keep, dg, 0.0)
    return dh.to(x.dtype), dg.to(x.dtype)


def grouped_matmul_nt_ref(x: torch.Tensor, w: torch.Tensor,
                          rows: torch.Tensor | None = None,
                          x2: torch.Tensor | None = None,
                          w2: torch.Tensor | None = None) -> torch.Tensor:
    """x (G, M, K) @ w^T with w (G, N, K), plus x2 @ w2^T when given;
    fp32 accumulation, cast to x's dtype; zero at or past ``rows[g]``."""
    acc = _acc(x.dtype)
    out = torch.einsum("gmk,gnk->gmn", x.to(acc), w.to(acc))
    if x2 is not None:
        out = out + torch.einsum("gmk,gnk->gmn", x2.to(acc), w2.to(acc))
    if rows is not None:
        out = torch.where(_row_mask(rows, x.shape[1]), out, 0.0)
    return out.to(x.dtype)


def grouped_wgrad_ref(x: torch.Tensor, d: torch.Tensor,
                      rows: torch.Tensor | None = None) -> torch.Tensor:
    """(G, K, N) = x[g, :rows[g]]^T d[g, :rows[g]] per slot (x (G, M, K),
    d (G, M, N)), fp32 accumulation, cast to x's dtype.  Rows past the
    count are selected away, never multiplied."""
    acc = _acc(x.dtype)
    xf, df = x.to(acc), d.to(acc)
    if rows is not None:
        keep = _row_mask(rows, x.shape[1])
        xf, df = torch.where(keep, xf, 0.0), torch.where(keep, df, 0.0)
    return torch.einsum("gmk,gmn->gkn", xf, df).to(x.dtype)


def _bwd_operands(name: str, *ts: torch.Tensor) -> None:
    """The backward kernels' contract: bf16 or fp32, one dtype, on one
    card, 3-D, a unit-stride last dim, TMA-readable, widths that are
    multiples of 8."""
    dtype, dev = ts[0].dtype, ts[0].get_device()
    for t in ts:
        if t.dtype not in (torch.bfloat16, torch.float32) or \
                t.dtype != dtype:
            raise ValueError(f"{name}: the backward kernels take bf16 or "
                             f"fp32 operands of one dtype, not {t.dtype}")
        if t.get_device() != dev or t.dim() != 3:
            raise ValueError(f"{name}: expected 3-D operands on one device")
        if t.shape[2] % 8 or t.stride(2) != 1 or not _tma_ready(t):
            raise ValueError(f"{name}: operands need a unit-stride last dim "
                             f"that is a multiple of 8 and 16-byte aligned "
                             f"rows, not {tuple(t.shape)} / {t.stride()}")


def _bwd_check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err} (below "
                           f"1000 a CUDA error; 1000 no cuTensorMapEncodeTiled;"
                           f" 1001 + CUresult a refused tensor map)")


def grouped_swiglu_bwd(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                       dact: torch.Tensor, rows: torch.Tensor | None = None,
                       *, zero_padded: bool = True
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dh, dg), each (G, M, N), of the grouped SwiGLU for ``dact``; see
    :func:`grouped_swiglu_bwd_ref`.  On the card, ``zero_padded=False``
    leaves slot g's rows from ``ceil(rows[g] / 64) * 64`` (fp32: 128) on
    unwritten (the rows of its last row tile past the count are still
    zeros)."""
    if not _check_device(x):
        return grouped_swiglu_bwd_ref(x, w1, w3, dact, rows)
    G, M, K = x.shape
    N = w1.shape[2]
    _bwd_operands("grouped_swiglu_bwd", x, w1, w3, dact)
    if w1.shape != (G, K, N) or w3.shape != w1.shape or \
            w3.stride() != w1.stride() or dact.shape != (G, M, N) or \
            not dact.is_contiguous():
        raise ValueError("grouped_swiglu_bwd: x (G, M, K), w1 / w3 (G, K, N) "
                         "with equal strides, dact (G, M, N) contiguous")
    rows = _check_rows(rows, G, x.device)
    dh, dg = torch.empty((2, *dact.shape), dtype=dact.dtype,
                         device=dact.device).unbind(0)
    if dh.numel() and x.dtype == torch.float32:
        _bwd_check(_f32_launch(1, x, None, w1, w3, dact, dh, dg, rows,
                               zero_padded=zero_padded),
                   "grouped_swiglu_bwd fp32")
        _count_bwd(grouped_swiglu_bwd, x.dtype)
    elif dh.numel():
        # The counter from which the kernel's blocks take their work items.
        nxt = torch.zeros(1, dtype=torch.int32, device=x.device)
        _bwd_check(_swiglu_bwd_launcher()(
            int(zero_padded), x.data_ptr(), w1.data_ptr(), w3.data_ptr(),
            dh.data_ptr(), dg.data_ptr(), dact.data_ptr(),
            None if rows is None else rows.data_ptr(), nxt.data_ptr(), G, M,
            K, N, x.stride(0), x.stride(1), w1.stride(0), w1.stride(1),
            torch.cuda.current_stream(x.device).cuda_stream),
            "grouped_swiglu_bwd")
        _count_bwd(grouped_swiglu_bwd, x.dtype)
    return dh, dg


def grouped_matmul_nt(x: torch.Tensor, w: torch.Tensor,
                      rows: torch.Tensor | None = None,
                      x2: torch.Tensor | None = None,
                      w2: torch.Tensor | None = None, *,
                      zero_padded: bool = True) -> torch.Tensor:
    """x (G, M, K) @ w^T (+ x2 @ w2^T) with w, w2 stored (G, N, K):
    (G, M, N), zero at or past ``rows[g]``; one launch for both products.
    On the card, ``zero_padded=False`` leaves slot g's rows from
    ``ceil(rows[g] / 64) * 64`` (fp32: 128) on unwritten (the rows of its
    last row tile past the count are still zeros)."""
    if not _check_device(x):
        return grouped_matmul_nt_ref(x, w, rows, x2, w2)
    G, M, K = x.shape
    N = w.shape[1]
    ops = (x, w) if x2 is None else (x, w, x2, w2)
    _bwd_operands("grouped_matmul_nt", *ops)
    if w.shape != (G, N, K) or (x2 is not None and (
            x2.shape != x.shape or x2.stride() != x.stride()
            or w2.shape != w.shape or w2.stride() != w.stride())):
        raise ValueError("grouped_matmul_nt: x (G, M, K), w (G, N, K); x2 and "
                         "w2 with the shapes and strides of x and w")
    rows = _check_rows(rows, G, x.device)
    out = torch.empty((G, M, N), dtype=x.dtype, device=x.device)
    if out.numel() and x.dtype == torch.float32:
        _bwd_check(_f32_launch(0, x, x2, w, w2, None, out, None, rows,
                               zero_padded=zero_padded),
                   "grouped_matmul_nt fp32")
        _count_bwd(grouped_matmul_nt, x.dtype)
    elif out.numel():
        second = x2 is not None
        # The counter from which the kernel's blocks take their work items.
        nxt = torch.zeros(1, dtype=torch.int32, device=x.device)
        _bwd_check(_matmul_nt_launcher()(
            int(zero_padded), int(second), x.data_ptr(),
            (x2 if second else x).data_ptr(), w.data_ptr(),
            (w2 if second else w).data_ptr(), out.data_ptr(),
            None if rows is None else rows.data_ptr(), nxt.data_ptr(), G, M,
            K, N, x.stride(0), x.stride(1), w.stride(0), w.stride(1),
            torch.cuda.current_stream(x.device).cuda_stream),
            "grouped_matmul_nt")
        _count_bwd(grouped_matmul_nt, x.dtype)
    return out


def grouped_wgrad(x: torch.Tensor, d: torch.Tensor,
                  rows: torch.Tensor | None = None) -> torch.Tensor:
    """(G, K, N) = x[g, :rows[g]]^T d[g, :rows[g]] for x (G, M, K) and
    d (G, M, N): each slot's valid rows only (a slot with none gives zeros
    and reads nothing)."""
    if not _check_device(x):
        return grouped_wgrad_ref(x, d, rows)
    G, M, K = x.shape
    N = d.shape[2]
    _bwd_operands("grouped_wgrad", x, d)
    if d.shape[:2] != (G, M):
        raise ValueError(f"grouped_wgrad: x {tuple(x.shape)}, d "
                         f"{tuple(d.shape)}")
    rows = _check_rows(rows, G, x.device)
    chunk = (wgrad_f32_chunk(G, M, K, N, _sm_count(x.get_device()))
             if x.dtype == torch.float32 else 0)
    # The fp32 chunks' partial sums follow the output in its allocation.
    buf = torch.empty((G * (1 + (-(-M // chunk) if chunk else 0)), K, N),
                      dtype=x.dtype, device=x.device)
    out = buf[:G]
    if out.numel() and x.dtype == torch.float32:
        _bwd_check(_f32_launch(2, x, None, d, None, None, out, None, rows,
                               chunk=chunk, ws=buf if chunk else None),
                   "grouped_wgrad fp32")
        _count_bwd(grouped_wgrad, x.dtype)
    elif out.numel():
        _bwd_check(_wgrad_launcher()(
            x.data_ptr(), d.data_ptr(), out.data_ptr(),
            None if rows is None else rows.data_ptr(), G, M, K, N,
            x.stride(0), x.stride(1), d.stride(0), d.stride(1),
            torch.cuda.current_stream(x.device).cuda_stream), "grouped_wgrad")
        _count_bwd(grouped_wgrad, x.dtype)
    return out


def _count_bwd(fn, dtype: torch.dtype) -> None:
    """One launch of a backward wrapper, counted whole and by dtype."""
    fn.launches += 1
    fn.launches_by_kernel[_BWD_KERNEL[dtype]] += 1


@functools.lru_cache(maxsize=None)
def _f32_launcher():
    """The fp32 backward's entry point with its argument types (set once)."""
    fn = LIBRARY_BWD_F32.load().grouped_bwd_f32_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return fn


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _f32_launch(mode, a, a2, b, b2, dact, out, out2, rows, *,
                zero_padded: bool = True, chunk: int = 0,
                ws: torch.Tensor | None = None) -> int:
    """One launch of ``csrc/grouped_gemm_bwd_f32.cu`` (mode 0 dgrad, 1
    SwiGLU backward, 2 wgrad, with its chunk sum where ``chunk``: the
    partial sums go to ``ws`` after the output's G slots) on the current
    stream; its error code."""
    G, M, K = a.shape
    N = out.shape[2]
    sa, sb = a.stride(), b.stride()
    return _f32_launcher()(
        mode, a.data_ptr(), _ptr(a2), b.data_ptr(), _ptr(b2), _ptr(dact),
        out.data_ptr(), _ptr(out2),
        None if ws is None else ws.data_ptr() + G * K * N * 4, _ptr(rows),
        G, M, K, N, sa[0], sa[1], sb[0], sb[1], int(zero_padded), chunk,
        torch.cuda.current_stream(a.device).cuda_stream)


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    """SMs of CUDA device ``device`` (an index)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def wgrad_f32_chunk(G: int, M: int, K: int, N: int, sms: int) -> int:
    """Rows of one partial sum of the fp32 wgrad (B3f), or 0: each slot's
    rows in one item, where its (slot, 128 x 128) output tiles are at
    least ``sms``.  Otherwise (the reduced widths: one tile a slot) the
    rows are cut into chunks of a multiple of 32 rows, about 2 ``sms``
    items where every slot is full, whose partials a second kernel adds in
    chunk order; the wrapper's workspace holds G ceil(M / chunk) K N
    floats."""
    tiles = G * -(-K // 128) * -(-N // 128)
    if tiles >= sms or M == 0:
        return 0
    per = -(-2 * sms // tiles)
    return max(32, -(-M // (32 * per)) * 32)


def _row_tile_items(rows: torch.Tensor, M: int, N: int,
                    cols: int) -> torch.Tensor:
    """(W, 3) int64 rows (slot, first row, first column): only the
    128-row tiles that hold rows, ``ceil(min(rows[g], M) / 128)`` a slot,
    times the ``cols``-wide column tiles; slot-major, then the column tile,
    then the row tile fastest."""
    mt = (rows.to(torch.int64).clamp(0, M) + 127) // 128
    nt = -(-N // cols)
    per = mt * nt
    end = torch.cumsum(per, 0)
    w = torch.arange(int(end[-1]) if len(end) else 0, device=rows.device)
    g = torch.searchsorted(end, w, right=True)
    r = w - (end - per)[g]
    return torch.stack([g, (r % mt[g]) * 128, (r // mt[g]) * cols], dim=1)


def swiglu_bwd_tiles(rows: torch.Tensor, M: int, N: int) -> torch.Tensor:
    """The SwiGLU backward kernel's work items in its order, as (W, 3)
    int64 rows (slot, first row, first column): only the row tiles that
    hold rows, ``ceil(min(rows[g], M) / 128)`` a slot; slot-major, then
    the 128-column tile, then the 128-row tile fastest (the blocks running
    together share a weight panel).  The kernel's blocks take the items in
    this order from a counter on the device, and find an item's slot by a
    binary search over the prefix sums they build from ``rows`` in shared
    memory.  Reads ``rows`` on the host: a mirror for tests and timing
    reports."""
    return _row_tile_items(rows, M, N, 128)


def matmul_nt_tiles(rows: torch.Tensor, M: int, N: int) -> torch.Tensor:
    """The dgrad kernel's (``grouped_matmul_nt``) work items in its order,
    as :func:`swiglu_bwd_tiles` gives B1's but with 256-column tiles (the
    last one narrower where N is not a multiple of 256).  A mirror for
    tests and timing reports."""
    return _row_tile_items(rows, M, N, 256)


def wgrad_tiles(G: int, K: int, N: int) -> torch.Tensor:
    """The wgrad kernel's output tiles in its order, as (W, 3) int64 rows
    (slot, first row of K, first column of N): every (slot, 128-row tile,
    256-column tile), slot-major, the column tiles fastest (the tiles
    running together write whole output rows); a tile of a slot with no
    rows is stored as zeros.  Block b takes tiles b, b + SMs, ..."""
    kt, nt = -(-K // 128), -(-N // 256)
    w = torch.arange(G * kt * nt)
    r = w % (kt * nt)
    return torch.stack([w // (kt * nt), (r // nt) * 128, (r % nt) * 256],
                       dim=1)


@functools.lru_cache(maxsize=None)
def _matmul_nt_launcher():
    """B2's entry point with its argument types (set once)."""
    fn = LIBRARY.load().grouped_matmul_nt_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4
                   + [ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _swiglu_bwd_launcher():
    fn = LIBRARY.load().grouped_swiglu_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4
                   + [ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _wgrad_launcher():
    fn = LIBRARY.load().grouped_wgrad_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    return fn


# The plain backward runs over groups of slots whose fp32 operands take at
# most this many bytes (autograd keeps their fp32 copies): DeepSeek-V3's
# 258 expert slots hold 15 GB of fp32 weights a projection.
_PLAIN_BWD_BYTES = 1 << 30


def _plain_grads(ref, inputs, needs, grad_out, rows):
    """Gradients of ``ref(*inputs, rows)`` by autograd through the plain
    forward (recomputed), for the inputs that need one; a group of slots
    at a time, slots being independent."""
    G = inputs[0].shape[0]
    per_slot = 4 * (sum(t[0].numel() for t in inputs) + grad_out[0].numel())
    step = max(1, min(G, _PLAIN_BWD_BYTES // max(per_slot, 1)))
    parts = []
    with torch.enable_grad():
        for g0 in range(0, G, step):
            sl = slice(g0, g0 + step)
            leaves = [t.detach()[sl].requires_grad_(n)
                      for t, n in zip(inputs, needs)]
            out = ref(*leaves, None if rows is None else rows[sl])
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, grad_out[sl]))
            parts.append([next(got) if t.requires_grad else None
                          for t in leaves])
    if len(parts) == 1:
        return parts[0]
    return [None if g[0] is None else torch.cat(g) for g in zip(*parts)]


class _GroupedSwiGLU(torch.autograd.Function):
    """act = silu(x w1) (x w3): saves x, w1, w3 (h and g are recomputed)."""

    @staticmethod
    def forward(ctx, x, w1, w3, rows, plain_backward):
        ctx.save_for_backward(x, w1, w3, rows)
        ctx.plain_backward = plain_backward
        return _swiglu_fwd(x, w1, w3, rows)

    @staticmethod
    def backward(ctx, dact):
        x, w1, w3, rows = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        if ctx.plain_backward:
            return (*_plain_grads(grouped_swiglu_ref, (x, w1, w3), needs,
                                  dact, rows), None, None)
        dh, dg = grouped_swiglu_bwd(x, w1, w3, dact.contiguous(), rows,
                                    zero_padded=False)
        dx = (grouped_matmul_nt(dh, w1, rows, dg, w3, zero_padded=False)
              if needs[0] else None)
        dw1 = grouped_wgrad(x, dh, rows) if needs[1] else None
        dw3 = grouped_wgrad(x, dg, rows) if needs[2] else None
        return dx, dw1, dw3, None, None


class _GroupedMatmul(torch.autograd.Function):
    """y = x w: saves x (the FFN's activations) and w."""

    @staticmethod
    def forward(ctx, x, w, rows, plain_backward):
        ctx.save_for_backward(x, w, rows)
        ctx.plain_backward = plain_backward
        return _matmul_fwd(x, w, rows)

    @staticmethod
    def backward(ctx, dy):
        x, w, rows = ctx.saved_tensors
        needs = ctx.needs_input_grad[:2]
        if ctx.plain_backward:
            return (*_plain_grads(grouped_matmul_ref, (x, w), needs, dy, rows),
                    None, None)
        dy = dy.contiguous()
        dx = (grouped_matmul_nt(dy, w, rows, zero_padded=False)
              if needs[0] else None)
        dw = grouped_wgrad(x, dy, rows) if needs[1] else None
        return dx, dw, None, None


# The backward wrappers' kernels by operand dtype.
_BWD_KERNEL = {torch.bfloat16: "bf16", torch.float32: "fp32"}
for _fn in (grouped_swiglu_bwd, grouped_matmul_nt, grouped_wgrad):
    _fn.launches = 0
    _fn.launches_by_kernel = dict.fromkeys(_BWD_KERNEL.values(), 0)
grouped_swiglu.launches = 0
grouped_matmul.launches = 0
grouped_swiglu.padded_copies = 0
grouped_matmul.padded_copies = 0
grouped_swiglu_q8.launches = 0
grouped_matmul_q8.launches = 0
grouped_swiglu_q8.padded_copies = 0
grouped_matmul_q8.padded_copies = 0
