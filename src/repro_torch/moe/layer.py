"""Balanced MoE layer: config, parameters and the public entry point.

Mirrors ``repro.moe.layer``: :func:`moe_layer_local` is the per-rank view of
one balanced MoE layer and delegates to :func:`repro_torch.moe.stages.
run_staged_moe`.  It runs an EP group of ``ep_size`` ranks over
``torch.distributed`` (``axis_name`` the group, an
:class:`repro_torch.parallel.collectives.EPGroup`; None for one rank): a
flat one in the ``a2a`` and ``replicated`` dispatch modes, a factored one
of ``racks`` racks (``collectives.factor``) in ``hier_a2a`` (the
rack-aware plan, the two-hop token exchange and the tiered replica stream
of DESIGN.md S9) and ``replicated``; with the fused permutation engine or
the reference one (``dispatch_impl``), ``overlap_chunks`` token chunks
sharing one plan, the wire codec (``wire_dtype``) and the w8a8 expert FFN
(``ffn_dtype``) of DESIGN.md S12.  It is differentiable
(``repro_torch.moe.stages``: training) in the fp FFN with no wire codec,
on one rank or an EP group.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.balancer import BalancerConfig
from repro_torch.core.layout import ExpertLayout
from repro_torch.core.quantize import FFN_DTYPES, WIRE_DTYPES
from repro_torch.moe.expert import quantize_weight_cols
from repro_torch.moe.gating import GatingConfig
from repro_torch.moe.stages import MoEStats, run_staged_moe

__all__ = ["MoEConfig", "MoEParams", "GatheredMoE", "MoEStats",
           "moe_layer_local", "init_moe_params", "default_capacities"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    gating: GatingConfig
    balancer: BalancerConfig
    d_model: int
    d_ff: int                      # per-expert hidden size
    ep_size: int                   # R (EP group size)
    cap_pair: int                  # tokens per (src, dst) pair buffer
    cap_slot: int                  # tokens per physical expert slot
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    dispatch_mode: str = "a2a"     # "a2a" | "replicated" | "hier_a2a"
    # "hier_a2a": two-level (rack x lane) EP on a factored group; the
    # fused engine only; "a2a" on one rack, bit for bit
    dispatch_impl: str = "fused"   # "fused" (single-sort permutation
    # engine, moe.permute) | "reference" (multi-sort scatter path,
    # moe.dispatch: the equivalence oracle)
    racks: int = 1                 # racks of the two-level EP group
    overlap_chunks: int = 1        # token chunks sharing one plan, chunk
    # i+1's exchange issued before chunk i's FFN (moe.stages); must divide
    # the local token count at call time
    wire_dtype: str = "none"       # EP-wire payload codec: "none" | "bf16" |
    # "int8" (per-row symmetric, fp32 scales packed in-band); token payloads
    # both ways in "a2a" and the replica weight stream
    ffn_dtype: str = "none"        # expert FFN: "none" (fp) | "int8" (w8a8);
    # with wire_dtype "int8" too, the wire codes feed the kernel directly
    distribute_chunks: int = 1     # replica stream: reduce-scatters over the
    # packed weight axis (tile streaming)
    plain_backward: bool = False   # the grouped FFN's backward as autograd
    # through its plain versions (a check of the backward kernels in place)

    def __post_init__(self):
        # Fail at construction (mirrors repro.moe.layer.MoEConfig).
        if self.dispatch_impl not in ("fused", "reference"):
            raise ValueError(f"unknown dispatch_impl: {self.dispatch_impl!r}")
        if self.dispatch_mode not in ("a2a", "replicated", "hier_a2a"):
            raise ValueError(f"unknown dispatch_mode: {self.dispatch_mode!r}")
        if self.dispatch_mode == "hier_a2a" and self.dispatch_impl != "fused":
            raise ValueError(
                "dispatch_mode='hier_a2a' requires dispatch_impl='fused' "
                "(the reference scatter path is the flat-EP oracle)")
        if self.racks < 1 or self.ep_size % self.racks != 0:
            raise ValueError(
                f"racks={self.racks} must divide ep_size={self.ep_size}")
        if self.distribute_chunks < 1:
            raise ValueError(
                f"distribute_chunks={self.distribute_chunks} must be >= 1")
        if self.overlap_chunks < 1:
            raise ValueError(
                f"overlap_chunks={self.overlap_chunks} must be >= 1")
        if self.overlap_chunks > 1 and self.dispatch_impl != "fused":
            raise ValueError(
                "overlap_chunks > 1 requires dispatch_impl='fused' (the "
                "reference scatter path is the unchunked equivalence oracle)")
        if self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"unknown wire_dtype: {self.wire_dtype!r}")
        if self.ffn_dtype not in FFN_DTYPES:
            raise ValueError(f"unknown ffn_dtype: {self.ffn_dtype!r}")
        if self.wire_dtype != "none" and self.dispatch_impl != "fused":
            raise ValueError(
                "wire_dtype != 'none' requires dispatch_impl='fused' (the "
                "reference scatter path is the uncompressed oracle)")

    @property
    def ranks_per_rack(self) -> int:
        return self.ep_size // self.racks

    @property
    def rack_size(self) -> int | None:
        """Ranks per rack when the topology is two-level, else None (flat)."""
        return self.ranks_per_rack if self.racks > 1 else None

    @property
    def layout(self) -> ExpertLayout:
        return ExpertLayout(self.gating.num_experts, self.ep_size,
                            self.balancer.n_slot)


class MoEParams(nn.Module):
    """Per-rank MoE parameters (mirrors the ``repro.moe.layer.MoEParams``
    fields: router (D, E) fp32, w1/w3 (E_local, D, F), w2 (E_local, F, D),
    optional shared expert (D, F_sh), (D, F_sh), (F_sh, D)).

    Each expert weight lives in a slot buffer of ``E_local + n_slot`` rows:
    ``w1`` is a view of its first ``E_local`` rows and the distribute stage
    writes the plan's replicas into the remaining rows in place, so the
    grouped FFN reads one contiguous (num_slots, ...) tensor without a copy
    of the mains on every call.  The tail is scratch: its contents belong
    to the last call.

    Training: the parameters are built with ``requires_grad=False`` (the
    serve path); ``requires_grad_(True)`` makes them trainable.  Under a
    gradient the distribute stage returns the slot buffers through
    :func:`repro_torch.moe.distribute.slot_weights`, so ``w1``'s gradient is
    its own slot rows' plus its replicas', and an optimizer updates the
    mains in place (the buffers' heads), never rebinding them.

    The w8a8 path (``ffn_dtype="int8"``) reads int8 slot buffers of the same
    shape beside them (:meth:`q8_slot_buffers`): their head rows hold the
    mains' column codes and scales, computed once on first use, and the
    distribute stage requantizes only the replica tail on each call.  The
    codes are stored K-contiguous, the layout the q8 kernels take.  Like
    the slot buffers, they assume the mains do not change: build a new
    MoEParams for new weights.
    """

    def __init__(self, router, w1, w3, w2, shared_w1=None, shared_w3=None,
                 shared_w2=None, *, n_slot: int):
        super().__init__()
        self.n_slot = n_slot
        self.router = nn.Parameter(router, requires_grad=False)
        self._slots = []
        for name, w in (("w1", w1), ("w3", w3), ("w2", w2)):
            buf = w.new_zeros((w.shape[0] + n_slot,) + tuple(w.shape[1:]))
            buf[: w.shape[0]].copy_(w)
            self._slots.append(buf)
            setattr(self, name, nn.Parameter(buf[: w.shape[0]],
                                             requires_grad=False))
        for name, w in (("shared_w1", shared_w1), ("shared_w3", shared_w3),
                        ("shared_w2", shared_w2)):
            setattr(self, name, None if w is None
                    else nn.Parameter(w, requires_grad=False))
        self._q8 = None

    def slot_buffers(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The (num_slots, ...) buffers whose heads are w1, w3, w2."""
        for buf, w in zip(self._slots, (self.w1, self.w3, self.w2)):
            if buf.data_ptr() != w.data_ptr():
                raise RuntimeError("MoEParams expert weights were replaced; "
                                   "build a new MoEParams instead")
        return tuple(self._slots)

    def q8_slot_buffers(self) -> tuple:
        """``((w1q, w1s), (w3q, w3s), (w2q, w2s))`` over all slots: codes
        int8 (num_slots, K, N) as views of (num_slots, N, K) storage, scales
        fp32 (num_slots, N).  The head rows equal ``quantize_weight_cols``
        of the mains; the tail rows are scratch, like the slot buffers'."""
        self.slot_buffers()
        if self._q8 is None:
            self._q8 = tuple(_q8_slots(w, self.n_slot)
                             for w in (self.w1, self.w3, self.w2))
        return self._q8

    def forward(self, x: torch.Tensor, cfg: MoEConfig, *, axis_name=None,
                router_bias: torch.Tensor | None = None):
        return moe_layer_local(x, self, cfg, axis_name=axis_name,
                               router_bias=router_bias)


class GatheredMoE:
    """:class:`MoEParams`' fields over the weights one call computes with
    (``repro_torch.models.transformer`` on the sharded layout: the rank's
    experts gathered over the data axis, FSDP): ``w1``, ``w3``, ``w2``
    the heads of ``slots`` (the call's own slot buffers, or the
    parameters' where no gather was needed), each carrying its gradient
    back to the shard it was gathered from."""

    def __init__(self, router, w1, w3, w2, shared_w1=None, shared_w3=None,
                 shared_w2=None, *, n_slot: int, slots: tuple):
        self.router, self.w1, self.w3, self.w2 = router, w1, w3, w2
        self.shared_w1, self.shared_w3 = shared_w1, shared_w3
        self.shared_w2 = shared_w2
        self.n_slot = n_slot
        self._slots = slots
        self._q8 = None

    def slot_buffers(self):
        return self._slots

    def q8_slot_buffers(self) -> tuple:
        if self._q8 is None:
            self._q8 = tuple(_q8_slots(w.detach(), self.n_slot)
                             for w in (self.w1, self.w3, self.w2))
        return self._q8

    def __call__(self, x: torch.Tensor, cfg: MoEConfig, **kw):
        return MoEParams.forward(self, x, cfg, **kw)


def _q8_slots(w: torch.Tensor, n_slot: int):
    """Column codes and scales of ``w`` (E, K, N) in slot buffers of
    ``E + n_slot`` rows, quantized 16 experts at a time to bound the fp32
    temporaries (quantization is independent per expert)."""
    E, K, N = w.shape
    codes = torch.zeros((E + n_slot, N, K), dtype=torch.int8, device=w.device)
    scales = torch.zeros((E + n_slot, N), dtype=torch.float32, device=w.device)
    for e0 in range(0, E, 16):
        c, s = quantize_weight_cols(w[e0:e0 + 16])
        codes[e0:e0 + 16].copy_(c.transpose(1, 2))
        scales[e0:e0 + 16].copy_(s)
    return codes.transpose(1, 2), scales


def default_capacities(tokens_per_rank: int, top_k: int, ep_size: int,
                       slots_per_rank: int, *, cf_pair: float = 2.0,
                       cf_slot: float = 2.0,
                       topology=None) -> tuple[int, int]:
    """Static capacity bounds sized off the balanced expectation (mirrors
    ``repro.moe.layer.default_capacities``).  ``topology`` (a
    :class:`repro_torch.core.topology.Topology` of more than one rack)
    takes the per-rack pair bound: the rack-local reroute tier concentrates
    a source's traffic in its rack, so a pair buffer is sized for all of a
    source's traffic to one rack landing on one rank."""
    items = tokens_per_rank * top_k
    if topology is not None and topology.racks > 1:
        cap_pair = max(8, int(-(-items * cf_pair // topology.racks)))
    else:
        cap_pair = max(8, int(-(-items * cf_pair // ep_size)))
    cap_slot = max(8, int(-(-items * cf_slot // slots_per_rank)))
    return cap_pair, cap_slot


def init_moe_params(cfg: MoEConfig, generator: torch.Generator, *,
                    dtype=torch.float32, device="cuda",
                    ep_rank: int = 0) -> MoEParams:
    """Per-rank parameter shard (E_local experts), drawn from ``generator``
    (which must live on ``device``).

    Every rank draws the weights of all E experts and keeps its own
    ``[ep_rank * E_local, (ep_rank + 1) * E_local)``, so the ranks of a
    group draw from one seed what one rank holds at ``ep_size == 1``, and
    the generator ends in the same state on every rank."""
    E = cfg.gating.num_experts
    epr = E // cfg.ep_size
    D, F = cfg.d_model, cfg.d_ff
    if not 0 <= ep_rank < cfg.ep_size:
        raise ValueError(f"ep_rank {ep_rank} of ep_size {cfg.ep_size}")
    mine = slice(ep_rank * epr, (ep_rank + 1) * epr)

    def normal(shape, scale, dt=dtype):
        return torch.randn(shape, generator=generator, dtype=dt,
                           device=device) * scale

    def experts(shape, scale):
        w = normal((E,) + shape, scale)
        return w[mine]          # MoEParams copies it into its slot buffer

    router = normal((D, E), D ** -0.5, torch.float32)
    w1 = experts((D, F), D ** -0.5)
    w3 = experts((D, F), D ** -0.5)
    w2 = experts((F, D), F ** -0.5)
    shared = [None, None, None]
    if cfg.n_shared_experts > 0:
        Fs = cfg.shared_d_ff * cfg.n_shared_experts
        shared = [normal((D, Fs), D ** -0.5), normal((D, Fs), D ** -0.5),
                  normal((Fs, D), Fs ** -0.5)]
    return MoEParams(router, w1, w3, w2, *shared, n_slot=cfg.balancer.n_slot)


def moe_layer_local(x: torch.Tensor, params: MoEParams, cfg: MoEConfig, *,
                    axis_name=None, router_bias: torch.Tensor | None = None,
                    lam_e_est: torch.Tensor | None = None, resilience=None
                    ) -> tuple[torch.Tensor, torch.Tensor, MoEStats]:
    """One balanced MoE layer, per-rank view.  x: (T_local, D).

    Returns (y, aux_loss, stats) with y (T_local, D).  ``axis_name`` is the
    EP group (:class:`repro_torch.parallel.collectives.EPGroup` of
    ``cfg.ep_size`` ranks, each calling with its own tokens and its
    ``params`` shard; factored into ``cfg.racks`` racks for ``hier_a2a``),
    or None when ``cfg.ep_size == 1``.  In the
    ``replicated`` mode every rank passes the same tokens and gets the
    same y.  ``lam_e_est``: optional stale per-expert load estimate (the
    ``eplb`` balancer mode).  ``resilience``: optional
    :class:`repro_torch.moe.stages.Resilience` -- health-weighted planning,
    the degradation ladder, and payload screening (DESIGN.md S13).
    """
    return run_staged_moe(x, params, cfg, axis_name=axis_name,
                          router_bias=router_bias, lam_e_est=lam_e_est,
                          resilience=resilience)
