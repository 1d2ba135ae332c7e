"""EPLB's greedy replica placement: a hand-written Hopper kernel and its
plain version.

``eplb_place`` takes the place of the JAX package's device-resident EPLB
placement, ``repro.core.eplb._eplb_replication_jax`` (:130-183): a
``lax.while_loop`` (:154-174) that replicates, step by step, the expert
with the largest load per instance onto the admissible rank with the
lowest estimated load.  It is no Pallas kernel there, but in eager PyTorch
its translation is a masked loop of up to R * n_slot + E steps of about ten
launches each, or a loop that reads the device for its exit test; the
kernel runs the whole loop in one launch and reads nothing back.  The CUDA
source is ``csrc/eplb_place.cu``; its header says what bounds the kernel
and how it sums the estimate.

Dispatch is by the tensors' device only: CPU tensors run the plain version
(:func:`eplb_place_ref`, a Python loop whose conditions read scalars), CUDA
tensors launch the kernel or raise.  The wrapper counts its launches in
``eplb_place.launches``.

Inputs: ``lam_e`` (E,) float32 estimated per-expert load (non-negative),
``home`` (E,) int64 home rank of each expert (each rank the home of E / R,
as the layout gives), ``num_ranks`` R; ``n_slot`` replica slots a rank and
``max_rep`` instances an expert (mains included).  Output: ``hosted`` (E,
R) bool, mains included.  The estimate ``est[t]`` sums rank t's hosted
experts' loads per instance in f32 in ascending expert id, on both paths.
The kernel runs its loop in one warp and takes E up to 1024 and R up to
256 (``MAX_E``, ``MAX_R``); the wrapper raises on more.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary

__all__ = ["eplb_place", "eplb_place_ref", "step_chain_ms", "LIBRARY"]

LIBRARY = KernelLibrary("eplb_place",
                        Path(__file__).parent / "csrc" / "eplb_place.cu")

MAX_SMEM = 232448          # 227 KB: the dynamic shared memory of an H100 block
MAX_E, MAX_R = 1024, 256   # the kernel's lanes hold 32 experts, 8 ranks each


def _estimate(hosted: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """(R,) est[t] = the f32 sum of pi over the experts rank t hosts, in
    ascending expert id (the kernel's order)."""
    E, R = hosted.shape
    ids = torch.arange(E, device=pi.device)
    cols = torch.sort(torch.where(hosted.T, ids, E), dim=1).values   # (R, E)
    n = int(hosted.sum(dim=0).max())
    pi_pad = torch.cat([pi, pi.new_zeros(1)])
    est = pi.new_zeros(R)
    for j in range(n):
        est = est + pi_pad[cols[:, j]]     # + 0.0 past a rank's list: exact
    return est


def eplb_place_ref(lam_e: torch.Tensor, home: torch.Tensor, num_ranks: int,
                   *, n_slot: int, max_rep: int,
                   stats: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: the loop of ``repro.core.eplb._eplb_replication_jax``
    in Python, with the estimate summed by expert id.  Returns ``hosted``
    (E, R) bool; ``stats`` (2,), if given, receives (steps, placements)."""
    E, R = lam_e.shape[0], num_ranks
    lam_e = lam_e.to(torch.float32)
    hosted = torch.nn.functional.one_hot(home.to(torch.int64), R).bool()
    slots = [0] * R
    counts = torch.ones(E, dtype=torch.float32, device=lam_e.device)
    eligible = torch.ones(E, dtype=torch.bool, device=lam_e.device)
    budget = R * n_slot
    steps = placed = 0
    while budget > 0 and bool(eligible.any()):
        pi = lam_e / counts
        per_inst = torch.where(eligible, pi, -1.0)
        e = int(torch.argmax(per_inst))           # the first maximum
        adm = torch.tensor(slots, device=lam_e.device) < n_slot
        adm &= ~hosted[e]
        steps += 1
        if bool(adm.any()) and int(counts[e]) < max_rep and float(pi[e]) > 0:
            est = torch.where(adm, _estimate(hosted, pi), float("inf"))
            t = int(torch.argmin(est))             # the first minimum
            hosted[e, t] = True
            slots[t] += 1
            counts[e] += 1
            budget -= 1
            placed += 1
        else:
            eligible[e] = False
    if stats is not None:
        stats.copy_(torch.tensor([steps, placed], dtype=stats.dtype))
    return hosted


@functools.cache
def _library():
    """The C entry points, their ctypes signatures set once, at load."""
    lib = LIBRARY.load()
    lib.eplb_place_launch.restype = ctypes.c_int
    lib.eplb_place_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    lib.eplb_place_smem_bytes.restype = ctypes.c_longlong
    lib.eplb_place_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.eplb_place_reg_lists.restype = ctypes.c_int
    lib.eplb_place_reg_lists.argtypes = [ctypes.c_int] * 3
    lib.eplb_place_step_chain.restype = ctypes.c_int
    lib.eplb_place_step_chain.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p]
    return lib


def step_chain_ms(E: int, R: int, n_slot: int, device=None,
                  rounds: int = 1 << 14) -> tuple[float, float]:
    """The card's latency, in ms, of each of the two dependent chains of
    one step of the kernel at (E, R, n_slot): (the argmin's two redux.sync
    rounds and the re-sum of the chosen rank's estimate, the vote and the
    argmax's two rounds).  The re-sum is the kernel's own form there: 8
    pairs in registers where the kernel keeps its lists there
    (``eplb_place_reg_lists``), else E / R + n_slot pairs from shared
    memory.  Each is a chain of
    ``rounds`` timed with CUDA events against a chain of 1.  The two run
    side by side in the kernel, so its bound is its steps times the
    larger."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = torch.empty(1, dtype=torch.int32, device=device)
    stream = torch._C._cuda_getCurrentRawStream(out.device.index)
    lib = _library()
    n = E // R + n_slot
    argmin_part = 0 if lib.eplb_place_reg_lists(E, R, n_slot) else 1

    def run(part, count):
        err = lib.eplb_place_step_chain(count, part, n, out.data_ptr(),
                                        stream)
        if err != 0:
            raise RuntimeError(f"step chain launch failed: CUDA error {err}")

    def chain(part):
        run(part, rounds)
        times = []
        for count in (1, rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(part, count)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return (times[1] - times[0]) / (rounds - 1)

    return chain(argmin_part), chain(2)


def eplb_place(lam_e: torch.Tensor, home: torch.Tensor, num_ranks: int, *,
               n_slot: int, max_rep: int,
               stats: torch.Tensor | None = None) -> torch.Tensor:
    """``hosted`` (E, R) bool of EPLB's greedy placement on ``lam_e``.

    ``stats``, if given, is an int32 (2,) tensor on the inputs' device that
    receives (steps, placements)."""
    if lam_e.device.type == "cpu":
        return eplb_place_ref(lam_e, home, num_ranks, n_slot=n_slot,
                              max_rep=max_rep, stats=stats)
    if lam_e.device.type != "cuda":
        raise ValueError(f"no EPLB placement for device {lam_e.device}")
    E, R = lam_e.shape[0], num_ranks
    if R < 1 or E % R != 0:
        raise ValueError(f"eplb_place: E={E} must be a multiple of R={R}")
    if E > MAX_E or R > MAX_R:
        raise ValueError(f"eplb_place: the kernel takes E <= {MAX_E} and "
                         f"R <= {MAX_R}, not E={E}, R={R}")
    if n_slot < 0 or max_rep < 1:
        raise ValueError(f"eplb_place: n_slot={n_slot}, max_rep={max_rep}")
    if (lam_e.dtype != torch.float32 or not lam_e.is_contiguous()
            or lam_e.dim() != 1):
        raise ValueError("eplb_place: lam_e must be contiguous float32 (E,)")
    if (home.dtype != torch.int64 or tuple(home.shape) != (E,)
            or not home.is_contiguous() or home.device != lam_e.device):
        raise ValueError(f"eplb_place: home must be contiguous int64 ({E},) "
                         f"on {lam_e.device}")
    if stats is not None and (stats.dtype != torch.int32 or stats.shape != (2,)
                              or stats.device != lam_e.device):
        raise ValueError("eplb_place: stats must be int32 (2,) on the "
                         "inputs' device")
    lib = _library()
    smem = lib.eplb_place_smem_bytes(E, R, n_slot)
    if smem > MAX_SMEM:
        raise ValueError(f"eplb_place: E={E}, R={R}, n_slot={n_slot} need "
                         f"{smem} B of shared memory, more than {MAX_SMEM}")
    hosted = torch.empty((E, R), dtype=torch.bool, device=lam_e.device)
    stream = torch._C._cuda_getCurrentRawStream(lam_e.device.index)
    err = lib.eplb_place_launch(
        lam_e.data_ptr(), home.data_ptr(), E, R, n_slot, max_rep,
        hosted.data_ptr(), None if stats is None else stats.data_ptr(),
        stream)
    if err != 0:
        raise RuntimeError(f"eplb_place kernel launch failed: CUDA error "
                           f"{err}")
    eplb_place.launches += 1
    return hosted


eplb_place.launches = 0
