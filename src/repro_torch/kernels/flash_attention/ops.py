"""Flash attention with cache offsets: a hand-written Hopper kernel and its
plain version.

``flash_attention`` replaces ``repro.kernels.flash_attention.kernel.
flash_fwd_pallas`` and computes what ``repro.models.attention.flash_ref``
computes, offsets included: query i of row b attends key j iff
``j < kv_valid_len[b]`` and, when causal, ``j <= i + q_offset[b]``.  The
Pallas kernel covers only ``q_offset = 0`` over the full KV length (full
sequence and training); the serve path's chunked prefill against the cache
and its decode need both offsets, so the port's kernel takes them.  The
CUDA source is ``csrc/flash_attention.cu``; its header says what bounds the
kernel on an H100 and what the design does about it.

``flash_attention_ref`` is the plain version, an online softmax over KV
blocks of ``block_kv`` keys in fp32 (the JAX ``lax.scan`` over blocks
becomes a Python loop); ``repro_torch.models.attention`` re-exports it as
``flash_ref``.

Dispatch is by the tensors' device only: a CPU tensor runs the plain
version, a CUDA tensor launches a kernel or raises.  Which kernel is an
explicit rule on the shapes alone (``plan_launch``; the device-held
lengths are never read on the host):

* ``decode_split``: the split-KV kernel (bf16 or fp32) for every launch
  whose prefill grid (q tiles x Hkv x B) would fill less than
  ``PREFILL_FILL`` (three quarters) of the card's SMs -- every decode
  step -- at the head dims it takes (``SPLIT_HEAD_DIMS``: not 80, and
  (192, 128) in bf16 only; those launches take the prefill kernel whatever
  the grid).  The keys are cut into splits, from the cache capacity Sk, so the
  grid holds at least two blocks per SM; a second small kernel combines
  the splits' partials from an fp32 workspace.
* ``prefill_wgmma``: the TMA + ``wgmma`` kernel for every other bf16 launch
  at head dims 64, 80, 128 or (192, 128) (128-row q tiles): every serve
  prefill chunk, DeepSeek-V3's MLA chunks of at most 128 tokens among
  them (128 blocks of 132 SMs), and HuBERT's bidirectional attention at
  head dim 80, whose rows are two 64-column boxes zero-filled past column
  80 (the products run at 128: 37.5% of them multiply zeros).
* ``prefill_mma_hd16``: the ``mma.sync`` kernel for the other bf16
  launches at head dim 16, the reduced configurations' width.
* ``prefill_f32``: the fp32 kernel for the other fp32 launches (every fp32
  serve prefill chunk): both products on the tensor cores in 3xTF32, each
  fp32 operand split into two TF32 values, so each product keeps about
  2^-20 (fp32: 2^-24).

q, k, v are all bf16 (tensor cores, P rounded to bf16) or all fp32 (fp32
results: the split-KV kernel computes in fp32 on the CUDA cores, the
prefill kernel in 3xTF32), at a (q/k, v) pair of head dims in
``HEAD_DIMS``: 16, 64, 80 or 128 for both (128 is the width of the GQA
models, 80 HuBERT-XLarge's, 16 that of the reduced configurations), or
q/k 192 and v 128 (DeepSeek-V3's MLA prefill: nope 128 + rope 64, v 128).
Any other pair raises a ``ValueError`` that names it.
``q_offset`` and ``kv_valid_len`` are a Python int or a (B,) tensor on the
tensors' device, which the kernels read there (no host sync).  The wrapper
counts its calls that launched in ``flash_attention.launches`` and, by
kernel, in ``flash_attention.launches_by_kernel``.

Layouts: q (B, Sq, H, hd); k (B, Sk, Hkv, hd) and v (B, Sk, Hkv, hd_v)
with H % Hkv == 0; the output is (B, Sq, H, hd_v) in q's dtype.

Gradients.  With a gradient required of q, k or v, ``flash_attention``
runs as an autograd Function over a full sequence (no ``q_offset`` or
``kv_valid_len``): on the card the forward is the prefill kernel of its
dtype and head dim (``prefill_wgmma``, ``prefill_mma_hd16`` or
``prefill_f32``) writing each row's logsumexp beside the output, and the
backward is ``flash_attention_bwd``: dq, dk, dv from q, k, v, the output,
its gradient and the logsumexp; dk and dv summed over each KV head's
query heads in a fixed order, dq from a second pass; no atomics: the same
bits on every run; k and v may be strided views, as MLA makes them, read
in place.  Its kernels (``BWD_KERNELS``): ``wgmma``, bf16 at (64, 64),
(80, 80), (128, 128) and (192, 128) (``csrc/flash_attention_bwd.cu``,
TMA + ``wgmma``; (80, 80) on the (128, 128) tiles, rows zero-filled past
column 80; at (192, 128) the dQ pass reads back the bf16 dS tiles the
first pass stored in a workspace the wrapper allocates, 2.2 GB at
DeepSeek-V3's train cell); ``mma_f32``, fp32 at every pair, and
``mma_bf16``, bf16 at (16, 16) (``csrc/flash_attention_bwd_mma.cu``,
``mma.sync``, fp32 in 3xTF32 as ``prefill_f32``, each fragment split
as it is read; its dK/dV pass takes one query
head a block, and a group-sum kernel adds the heads' fp32 partials, a
workspace the wrapper allocates, :func:`bwd_partials_floats`).  So the
backward takes every (dtype, pair) of ``BWD_HEAD_DIMS``, which equals
``HEAD_DIMS``, and raises a ``ValueError`` naming anything else before
any launch.  Counted
in ``flash_attention_bwd.launches``, by kernel in
``flash_attention_bwd.launches_by_kernel`` and by head-dim pair in
``flash_attention_bwd.launches_by_dims``.  The JAX package has no
backward kernel: XLA differentiates ``flash_ref``.  The plain version of
the backward, ``flash_attention_bwd_ref``, is autograd through
``flash_attention_ref`` (recomputed): the CPU's backward, and the card's
under ``plain_backward=True``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import KernelLibrary

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_bwd",
           "flash_attention_bwd_ref", "plan_launch", "Plan", "HEAD_DIMS",
           "SPLIT_HEAD_DIMS", "BWD_HEAD_DIMS", "KERNELS", "BWD_KERNELS",
           "bwd_kernel", "bwd_partials_floats", "LIBRARY", "LIBRARY_BWD",
           "LIBRARY_BWD_MMA"]

LIBRARY = KernelLibrary(
    "flash_attention", Path(__file__).parent / "csrc" / "flash_attention.cu")
LIBRARY_BWD = KernelLibrary(
    "flash_attention_bwd",
    Path(__file__).parent / "csrc" / "flash_attention_bwd.cu")
LIBRARY_BWD_MMA = KernelLibrary(
    "flash_attention_bwd_mma",
    Path(__file__).parent / "csrc" / "flash_attention_bwd_mma.cu")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (q/k head dim, v head dim) -> the dtypes the kernels take at that pair.
HEAD_DIMS = {(16, 16): (torch.float32, torch.bfloat16),
             (64, 64): (torch.float32, torch.bfloat16),
             (80, 80): (torch.float32, torch.bfloat16),   # HuBERT-XLarge
             (128, 128): (torch.float32, torch.bfloat16),
             (192, 128): (torch.float32, torch.bfloat16)}  # MLA prefill
# q/k head dim -> the dtypes the split-KV kernel takes there; every other
# launch takes the prefill kernel of its dtype whatever its grid.  MLA
# decode attends on the latent cache without flash, and HuBERT never
# decodes.
SPLIT_HEAD_DIMS = {16: (torch.float32, torch.bfloat16),
                   64: (torch.float32, torch.bfloat16),
                   128: (torch.float32, torch.bfloat16),
                   192: (torch.bfloat16,)}
# Kernel names, in the order of their codes in flash_attention_launch.
KERNELS = ("prefill_wgmma", "decode_split", "prefill_mma_hd16", "prefill_f32")
TILE_ROWS = {"prefill_wgmma": 128, "prefill_mma_hd16": 64, "prefill_f32": 64}
H100_SMS = 132
# The prefill kernel takes a launch whose q-tile grid fills at least this
# share of the SMs.  At a grid of 128 blocks (MLA's 128 heads, one q tile)
# the wgmma kernel takes a third of the split kernel's time; every decode
# step's grid is 16-64 blocks (launch/bench_flash.py times both kernels
# across the threshold).
PREFILL_FILL = 0.75
SPLIT_KEYS = 128        # keys per split: a multiple of the 32-key warp tile
BLOCKS_PER_SM = 2       # the split grid holds at least this many per SM
_MAX_GRID_YZ = 65535


class Plan(NamedTuple):
    """Which kernel a launch takes and, for ``decode_split``, its grid:
    ``splits`` key ranges of ``keys_per_split`` keys and row tiles of
    ``row_tile`` (query position, head) rows."""

    kernel: str
    splits: int = 1
    keys_per_split: int = 0
    row_tile: int = 0


def plan_launch(B: int, Sq: int, Sk: int, H: int, Hkv: int, hd: int,
                dtype: torch.dtype, sms: int = H100_SMS) -> Plan:
    """The kernel for these shapes, from the shapes alone.

    The prefill kernel by dtype and q/k head dim ``hd`` (bf16 at 64, 80,
    128 or 192: the TMA + wgmma kernel; bf16 at 16: the mma.sync one;
    fp32: the 3xTF32 one)
    unless its grid of q tiles (``TILE_ROWS / G`` positions each) times
    Hkv times B is below ``PREFILL_FILL`` of ``sms`` (``sms=1`` always
    picks the prefill kernel) and the split-KV kernel takes ``hd`` in
    ``dtype`` (``SPLIT_HEAD_DIMS``): then the split-KV kernel, with
    enough splits of Sk that B * Hkv * row tiles * splits >= 2 * sms, or
    as many as splits of SPLIT_KEYS keys allow.
    """
    G = H // Hkv
    if dtype == torch.bfloat16:
        prefill = "prefill_mma_hd16" if hd == 16 else "prefill_wgmma"
    else:
        prefill = "prefill_f32"
    per_tile = max(1, TILE_ROWS[prefill] // G)        # query positions
    if -(-Sq // per_tile) * Hkv * B >= PREFILL_FILL * sms or \
            dtype not in SPLIT_HEAD_DIMS.get(hd, ()):
        if G > TILE_ROWS[prefill]:
            raise ValueError(f"{G} query heads per KV head exceed the "
                             f"{prefill} kernel's {TILE_ROWS[prefill]}-row "
                             f"tile")
        return Plan(prefill)
    rows = Sq * G
    # bf16 computes 16 rows as one mma.sync fragment; fp32 on the CUDA
    # cores takes 4-row tiles where that is enough.
    row_tile = 4 if rows <= 4 and dtype != torch.bfloat16 else 16
    blocks = B * Hkv * -(-rows // row_tile)
    want = -(-BLOCKS_PER_SM * sms // blocks)
    keys = max(SPLIT_KEYS, -(-Sk // want) // SPLIT_KEYS * SPLIT_KEYS)
    return Plan("decode_split", max(1, -(-Sk // keys)), keys, row_tile)


def _as_batch_vector(v, device) -> torch.Tensor:
    """A scalar or (B,) offset as a (1,) or (B,) int64 tensor."""
    t = torch.as_tensor(v, device=device).to(torch.int64)
    return t[None] if t.dim() == 0 else t


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, block_kv: int = 512, q_offset=0,
                        kv_valid_len=None, scale: float | None = None,
                        return_lse: bool = False):
    """Online-softmax attention over KV blocks (mirrors ``flash_ref``).

    q: (B, Sq, H, hd); k: (B, Sk, Hkv, hd); v: (B, Sk, Hkv, hd_v) with
    H % Hkv == 0.  Query i attends key j iff j < kv_valid_len and, when
    causal, j <= i + q_offset.  The scale defaults to hd ** -0.5.  fp32
    arithmetic (fp64 for fp64 operands).  A row with no valid key gives 0
    (the kernels' convention; ``flash_ref`` divides 0 by 0 there).
    ``return_lse``: also each row's logsumexp of its scaled scores (B, H,
    Sq), natural log, in the accumulation dtype; +inf for a row with no
    valid key.
    """
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    hv = v.shape[-1]
    dev = q.device
    scale = scale if scale is not None else hd ** -0.5
    acc_t = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(acc_t) * scale
    kf = k.to(acc_t)
    vf = v.to(acc_t)
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=2)
        vf = vf.repeat_interleave(rep, dim=2)
    nblk = -(-Sk // block_kv)
    pad = nblk * block_kv - Sk
    if pad:
        kf = F.pad(kf, (0, 0, 0, 0, 0, pad))
        vf = F.pad(vf, (0, 0, 0, 0, 0, pad))
    kf = kf.reshape(B, nblk, block_kv, H, hd)
    vf = vf.reshape(B, nblk, block_kv, H, hv)

    q_pos = (torch.arange(Sq, device=dev)[None, :]
             + _as_batch_vector(q_offset, dev)[:, None])          # (B?, Sq)
    limit = _as_batch_vector(Sk if kv_valid_len is None else kv_valid_len, dev)

    m = torch.full((B, H, Sq), float("-inf"), dtype=acc_t, device=dev)
    l = torch.zeros((B, H, Sq), dtype=acc_t, device=dev)
    acc = torch.zeros((B, H, Sq, hv), dtype=acc_t, device=dev)
    for i in range(nblk):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, i])
        kv_pos = i * block_kv + torch.arange(block_kv, device=dev)
        mask = kv_pos[None, None, :] < limit[:, None, None]       # (B?, 1, blk)
        if causal:
            mask = mask & (kv_pos[None, None, :] <= q_pos[:, :, None])
        s = torch.where(mask[:, None, :, :], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        base = torch.where(m_new == float("-inf"), 0.0, m_new)
        p = torch.exp(s - base[..., None])
        corr = torch.exp(m - base)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhv->bhqv", p,
                                                    vf[:, i])
        m = m_new
    out = acc / l[..., None].clamp(min=1e-20)
    out = out.movedim(1, 2).to(q.dtype)                           # (B, Sq, H, hv)
    if not return_lse:
        return out
    return out, torch.where(l > 0, m + torch.log(l), float("inf"))


def _is_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for CPU (plain version)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no flash attention for device {x.device}")


def _offset_arg(v, B: int, device, name: str):
    """(pointer or None, stride, constant) for a Python int or a (), (1,)
    or (B,) tensor, read by the kernel on the device."""
    if not isinstance(v, torch.Tensor):
        return None, 0, int(v)
    if v.device != device:
        raise ValueError(f"{name} must lie on the tensors' device {device}")
    t = v.reshape(-1)
    if t.numel() not in (1, B):
        raise ValueError(f"{name} must be a scalar or ({B},), not "
                         f"{tuple(v.shape)}")
    t = t.to(torch.int64).contiguous()
    return t, int(t.numel() == B and B > 1), 0


def _aligned(t: torch.Tensor) -> bool:
    """Unit-stride head dim, 16-byte aligned base and outer strides: the
    kernels read rows in 16-byte pieces (cp.async, TMA)."""
    if t.stride(-1) != 1:
        return False
    per_16 = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % per_16 == 0
                                          for s in t.stride()[:-1])


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launcher():
    """The C entry point with its argument types (set once)."""
    fn = LIBRARY.load().flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p, ctypes.c_int,
                                                 ctypes.c_longlong] * 2
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3)
    return fn


def _launch(q, k, v, causal, q_offset, kv_valid_len, scale, sms=None,
            lse=None):
    """Validate, plan, allocate the output (and the split workspace) and
    launch on the current stream.  Returns the output and the kernel that
    ran, or None when there was nothing to compute.  ``lse``: a (B, H, Sq)
    fp32 buffer that receives each row's logsumexp (every kernel)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError("expected q (B, Sq, H, hd), k (B, Sk, Hkv, hd) and "
                         "v (B, Sk, Hkv, hd_v)")
    B, Sq, H, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != hd or Hkv == 0 or H % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash attention kernel takes q, k, v all bf16 "
                        f"or all fp32, not {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype not in HEAD_DIMS.get((hd, hd_v), ()):
        pairs = ", ".join(f"({a}, {b})" for a, b in HEAD_DIMS)
        raise ValueError(f"the flash attention kernel takes (q/k, v) head "
                         f"dims {pairs}, not ({hd}, {hd_v}) in {q.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash attention operands must share one device")
    if not all(_aligned(t) for t in (q, k, v)):
        raise ValueError("flash attention needs a unit-stride head dim and "
                         "16-byte aligned bases and strides")
    if Hkv > _MAX_GRID_YZ or B > _MAX_GRID_YZ:
        raise ValueError(f"grid too large for B={B}, Hkv={Hkv}")
    plan = plan_launch(B, Sq, Sk, H, Hkv, hd, q.dtype,
                       _sm_count(q.device) if sms is None else sms)
    out = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out, None
    qo, qo_stride, qo_const = _offset_arg(q_offset, B, q.device, "q_offset")
    kl, kl_stride, kl_const = _offset_arg(
        Sk if kv_valid_len is None else kv_valid_len, B, q.device,
        "kv_valid_len")
    ws = None
    if plan.splits > 1:
        ws = torch.empty(plan.splits * B * Sq * H * (hd_v + 2),
                         dtype=torch.float32, device=q.device)
    fn = _launcher()
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(KERNELS.index(plan.kernel), _DTYPE_CODE[q.dtype], hd, hd_v,
             q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
             Sk, H, Hkv, int(causal), *strides,
             None if qo is None else qo.data_ptr(), qo_stride, qo_const,
             None if kl is None else kl.data_ptr(), kl_stride, kl_const,
             float(scale if scale is not None else hd ** -0.5), plan.splits,
             plan.keys_per_split, plan.row_tile,
             None if ws is None else ws.data_ptr(),
             None if lse is None else lse.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel {plan.kernel} launch "
                           f"failed: error {err}")
    return out, plan.kernel


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset=0, kv_valid_len=None,
                    scale: float | None = None,
                    block_kv: int = 512,
                    plain_backward: bool = False,
                    return_lse: bool = False):
    """Attention of q (B, Sq, H, hd) over k (B, Sk, Hkv, hd) and v
    (B, Sk, Hkv, hd_v) with absolute query positions ``i + q_offset`` and
    ``kv_valid_len`` valid keys per row (default all); the output is
    (B, Sq, H, hd_v).  ``block_kv`` is read by the plain version only.
    Differentiable over full sequences (see the module's notes).

    ``return_lse`` (no gradient): (out, lse), ``lse`` (B, H, Sq) fp32 each
    row's logsumexp of its scaled scores, +inf (and an output of 0) for a
    row with no valid key, from whichever kernel ``plan_launch`` picks:
    one shard's partial of attention over a cache split by positions
    (``repro_torch.models.attention.combine_partials`` merges them).  A
    shard's local ``kv_valid_len`` (the row's valid length less the
    shard's first position) may be below 0 or above Sk: the kernels clamp
    it to [0, Sk] as they read it (``Args::limit``, no extra launch on the
    card), and the plain version receives it clamped so."""
    if return_lse:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise ValueError("flash attention's logsumexp output has no "
                             "gradient")
        if not _is_cuda(q):
            Sk = k.shape[1]
            lim = Sk if kv_valid_len is None else \
                torch.as_tensor(kv_valid_len).clamp(0, Sk)
            out, lse = flash_attention_ref(
                q, k, v, causal=causal, block_kv=block_kv, q_offset=q_offset,
                kv_valid_len=lim, scale=scale, return_lse=True)
            return out, lse.to(torch.float32)
        B, Sq, H, _ = q.shape
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        out, kernel = _launch(q, k, v, causal, q_offset, kv_valid_len, scale,
                              lse=lse)
        if kernel is not None:
            flash_attention.launches += 1
            flash_attention.launches_by_kernel[kernel] += 1
            flash_attention.lse_launches += 1
        return out, lse
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if not (isinstance(q_offset, int) and q_offset == 0
                and kv_valid_len is None and k.shape[1] == q.shape[1]):
            raise ValueError("flash attention is differentiable over full "
                             "sequences only (q_offset 0, no kv_valid_len, "
                             "Sq == Sk)")
        return _FlashAttention.apply(q, k, v, causal, scale, block_kv,
                                     plain_backward)
    if not _is_cuda(q):
        return flash_attention_ref(q, k, v, causal=causal, block_kv=block_kv,
                                   q_offset=q_offset,
                                   kv_valid_len=kv_valid_len, scale=scale)
    out, kernel = _launch(q, k, v, causal, q_offset, kv_valid_len, scale)
    if kernel is not None:
        flash_attention.launches += 1
        flash_attention.launches_by_kernel[kernel] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_kernel = dict.fromkeys(KERNELS, 0)
flash_attention.lse_launches = 0        # of them, with return_lse


# ---------------------------------------------------------------- backward

# (q/k, v) head dims -> the dtypes the backward kernels take there: what
# the forward takes.  bf16 at 64, 80, 128 and MLA's (192, 128) on the wgmma
# kernels; fp32 everywhere and bf16 at 16 (the reduced configurations'
# width) on the mma.sync kernels.
BWD_HEAD_DIMS = HEAD_DIMS
# Backward kernels, by the name their launches are counted under.
BWD_KERNELS = ("wgmma", "mma_f32", "mma_bf16")


def bwd_kernel(dtype: torch.dtype, hd: int) -> str:
    """The backward kernel of a (dtype, q/k head dim) that
    ``BWD_HEAD_DIMS`` holds."""
    if dtype == torch.float32:
        return "mma_f32"
    return "mma_bf16" if hd == 16 else "wgmma"


def _bwd_contract(q, k, v) -> None:
    """What the backward kernels take, checked before any launch."""
    hd, hd_v = q.shape[-1], v.shape[-1]
    if q.dtype not in BWD_HEAD_DIMS.get((hd, hd_v), ()) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        pairs = ", ".join(f"({a}, {b})" for a, b in BWD_HEAD_DIMS)
        raise ValueError(f"the flash attention backward kernels take fp32 "
                         f"or bf16 at head dims {pairs}, not ({hd}, {hd_v}) "
                         f"in {q.dtype}, {k.dtype}, {v.dtype}")


# The plain backward runs over groups of KV heads whose fp32 scores take
# at most this many bytes (autograd keeps a few such tensors per group):
# MLA's 128 heads at S 4096 would otherwise keep tens of GB.
_REF_BWD_BYTES = 1 << 28


def flash_attention_bwd_ref(q, k, v, dout, *, causal: bool,
                            scale: float | None = None, block_kv: int = 512):
    """(dq, dk, dv) by autograd through :func:`flash_attention_ref`
    (recomputed), in the operands' dtypes; one group of KV heads (with
    their query heads) at a time, heads being independent."""
    B, Sq, H, _ = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    per_head = 4 * B * G * Sq * Sk
    step = max(1, min(Hkv, _REF_BWD_BYTES // max(per_head, 1)))
    parts = []
    with torch.enable_grad():
        for h0 in range(0, Hkv, step):
            hq = slice(h0 * G, min(Hkv, h0 + step) * G)
            hk = slice(h0, min(Hkv, h0 + step))
            leaves = [t.detach()[:, :, hs].requires_grad_(True)
                      for t, hs in ((q, hq), (k, hk), (v, hk))]
            out = flash_attention_ref(*leaves, causal=causal,
                                      block_kv=block_kv, scale=scale)
            parts.append(torch.autograd.grad(out, leaves, dout[:, :, hq]))
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(g, dim=2) for g in zip(*parts))


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool,
                        scale: float | None = None):
    """(dq, dk, dv) of full-sequence attention on the card: q (B, S, H,
    hd), k (B, S, Hkv, hd), v (B, S, Hkv, hd_v), out and dout (B, S, H,
    hd_v), fp32 or bf16 at a pair of ``BWD_HEAD_DIMS``, and the forward's
    logsumexp ``lse`` (B, H, S) fp32; one call launches the three kernels
    of ``bwd_kernel(q.dtype, hd)`` (counted once).  Deterministic: two
    calls on the same inputs give the same bits."""
    if not _is_cuda(q):
        return flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                       scale=scale)
    _bwd_contract(q, k, v)
    B, S, H, hd = q.shape
    Hkv, hd_v = k.shape[2], v.shape[3]
    if k.shape != (B, S, Hkv, hd) or v.shape != (B, S, Hkv, hd_v) or \
            out.shape != (B, S, H, hd_v) or dout.shape != out.shape or \
            lse.shape != (B, H, S) or lse.dtype != torch.float32 or H % Hkv:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, lse "
                         f"{tuple(lse.shape)}")
    ops = _bwd_operands(q, k, v, out, dout, lse, causal)
    _bwd_call(ops, causal, scale, 7)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_kernel[bwd_kernel(q.dtype, hd)] += 1
    flash_attention_bwd.launches_by_dims[(hd, hd_v)] += 1
    return ops[7:10]


def _tma_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where TMA reads it (unit-stride rows, 16-byte aligned
    base and strides: MLA's k and v, views of one tensor), else a
    contiguous copy."""
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and \
            all(st % 8 == 0 for st in t.stride()[:-1]):
        return t
    return t.contiguous()


def _bwd_operands(q, k, v, out, dout, lse, causal) -> tuple:
    """The kernels' inputs (q, out, dout, lse contiguous; k and v as TMA
    reads them), the workspace (lse log2(e) and rowsum(do o), each (B, H,
    S rounded up to 64)), dq, dk, dv (contiguous) and the last pass's
    scratch: at (192, 128) in bf16 the dS^T tiles the dK/dV pass hands the
    dQ pass (bf16, 64 x 64 a tile, the causal triangle's or the square's
    tiles a (b, h)); on the mma.sync kernels with H > Hkv the dK/dV pass's
    fp32 partials of each query head (:func:`bwd_partials_floats`); else
    None."""
    q, out, dout, lse = (t.contiguous() for t in (q, out, dout, lse))
    k, v = _tma_view(k), _tma_view(v)
    B, S, H, hd = q.shape
    Hkv, hd_v = v.shape[2], v.shape[3]
    n = -(-S // 64)
    ws = torch.empty(2 * B * H * n * 64, dtype=torch.float32,
                     device=q.device)
    ds = None
    kernel = bwd_kernel(q.dtype, hd)
    if hd == 192 and kernel == "wgmma":
        tiles = n * (n + 1) // 2 if causal else n * n
        ds = torch.empty(B * H * tiles * 64 * 64, dtype=torch.bfloat16,
                         device=q.device)
    elif kernel != "wgmma" and H > Hkv:
        ds = torch.empty(bwd_partials_floats(B, S, H, Hkv, hd, hd_v),
                         dtype=torch.float32, device=q.device)
    return (q, k, v, out, dout, lse, ws,
            *(torch.empty(t.shape, dtype=t.dtype, device=t.device)
              for t in (q, k, v)), ds)


def bwd_partials_floats(B: int, S: int, H: int, Hkv: int, hd: int,
                        hd_v: int) -> int:
    """Floats of the mma.sync backward's partials workspace: its dK/dV
    pass takes one query head a block and writes each head's dk and dv in
    fp32, (B, S, H, hd) then (B, S, H, hd_v), which a group-sum kernel adds
    over each KV head's H / Hkv query heads in head order; none where
    H == Hkv (the pass writes dk and dv itself)."""
    return 0 if H == Hkv else B * S * H * (hd + hd_v)


def _bwd_call(ops, causal, scale, parts: int) -> None:
    """Launch the kernels ``parts`` names (1 prep, 2 dK/dV, 4 dQ) of
    ``bwd_kernel`` (the mma.sync entry point takes the dtype first)."""
    q, k, v = ops[:3]
    B, S, H, hd = q.shape
    Hkv, hd_v = v.shape[2], v.shape[3]
    if bwd_kernel(q.dtype, hd) == "wgmma":
        fn, first = _bwd_launcher(), ()
    else:
        fn, first = _bwd_mma_launcher(), (_DTYPE_CODE[q.dtype],)
    err = fn(
        *first, *(None if t is None else t.data_ptr() for t in ops), B, S, H,
        Hkv,
        hd, hd_v, int(causal),
        float(scale if scale is not None else hd ** -0.5), parts,
        *(t.stride(d) for t in (k, v) for d in (2, 1, 0)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed at ({hd}, "
                           f"{hd_v}) in {q.dtype}: error {err}")


def bwd_stage_ms(q, k, v, out, dout, lse, *, causal: bool,
                 scale: float | None = None, iters: int = 5) -> dict:
    """Each of the backward's three kernels timed alone on the card (CUDA
    events around ``iters`` launches of one, after a warm-up), on the same
    operands as :func:`flash_attention_bwd`: ms of ``prep``, ``dkdv`` and
    ``dq``.  Not counted as launches."""
    _bwd_contract(q, k, v)
    ops = _bwd_operands(q, k, v, out, dout, lse, causal)
    _bwd_call(ops, causal, scale, 7)
    out_ms = {}
    for name, parts in (("prep", 1), ("dkdv", 2), ("dq", 4)):
        _bwd_call(ops, causal, scale, parts)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(iters):
            _bwd_call(ops, causal, scale, parts)
        end.record()
        end.synchronize()
        out_ms[name] = start.elapsed_time(end) / iters
    return out_ms


_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                 + [ctypes.c_float, ctypes.c_int] + [ctypes.c_longlong] * 6
                 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    """The wgmma backward's C entry point with its argument types (set
    once)."""
    fn = LIBRARY_BWD.load().flash_attention_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = _BWD_ARGTYPES
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_mma_launcher():
    """The mma.sync backward's C entry point: the dtype code, then the
    wgmma entry point's arguments (set once)."""
    fn = LIBRARY_BWD_MMA.load().flash_attention_bwd_mma_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + _BWD_ARGTYPES
    return fn


class _FlashAttention(torch.autograd.Function):
    """Full-sequence attention; saves q, k, v, the output and (on the card)
    the logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_kv, plain_backward):
        lse = None
        if _is_cuda(q):
            _bwd_contract(q, k, v)
            B, S, H, _ = q.shape
            lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
            # The logsumexp comes from the prefill kernel of the dtype and
            # head dim, which sms=1 selects whatever the grid
            # (plan_launch).
            out, kernel = _launch(q, k, v, causal, 0, None, scale, sms=1,
                                  lse=lse)
            if kernel is not None:
                flash_attention.launches += 1
                flash_attention.launches_by_kernel[kernel] += 1
        else:
            out = flash_attention_ref(q, k, v, causal=causal,
                                      block_kv=block_kv, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, block_kv, plain_backward)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, block_kv, plain_backward = ctx.args
        if plain_backward or lse is None:
            grads = flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                            scale=scale, block_kv=block_kv)
        else:
            grads = flash_attention_bwd(q, k, v, out, dout, lse,
                                        causal=causal, scale=scale)
        return (*grads, None, None, None, None)


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_kernel = dict.fromkeys(BWD_KERNELS, 0)
flash_attention_bwd.launches_by_dims = dict.fromkeys(BWD_HEAD_DIMS, 0)
