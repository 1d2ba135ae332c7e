"""Roofline terms of a step on the card, and the model's useful FLOPs.

The port's counterpart of ``repro.roofline.analysis``:

  compute    = FLOPs / the card's peak for the dtype
  memory     = bytes / HBM bandwidth
  collective = collective bytes / interconnect bandwidth

The reference reads the FLOPs and bytes from XLA's cost analysis of the
compiled program and the collective bytes from its HLO text
(``roofline_from_compiled``, ``parse_hlo_collectives``).  PyTorch has no
compiled program to read, and ``FlopCounterMode`` does not see the port's
kernels (ctypes launches), so :func:`roofline_terms` takes the FLOPs and
bytes from its caller (counted from the shapes, as ``chip_smoke.py``
bounds each kernel) and the collective bytes from the counts that
``repro_torch.parallel.collectives`` keeps as it issues each collective
(the counterpart of the HLO parse; :func:`collective_bytes`).

:func:`model_flops` is the reference's formula on the port's own configs:
6 N_active D for a train step, 2 N_active D for inference, the numerator
of a model-FLOPs utilisation.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import layer_kinds
from repro_torch.roofline.hw import H100, Hardware

__all__ = ["RooflineTerms", "collective_bytes", "roofline_terms",
           "model_flops"]


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    collectives_by_kind: dict
    warnings: list

    def as_dict(self):
        return dataclasses.asdict(self)


def collective_bytes(counts: dict | None = None) -> int:
    """The bytes of every collective in ``counts`` ({kind: {"bytes",
    "calls"}}; default: this process's counts since
    ``collectives.reset_counts()``)."""
    if counts is None:
        from repro_torch.parallel import collectives

        counts = collectives.counts()
    return sum(c["bytes"] for c in counts.values())


def roofline_terms(flops: float, bytes_: float,
                   collective_bytes_: float | None = None,
                   hw: Hardware = H100, *,
                   dtype: str = "bf16") -> RooflineTerms:
    """Three-term roofline of one device's work: ``flops`` at the card's
    ``dtype`` rate (``Hardware.peak``), ``bytes_`` at its HBM rate and
    ``collective_bytes_`` at its interconnect rate; without
    ``collective_bytes_``, this process's collective counts since
    ``collectives.reset_counts()`` (kept in ``collectives_by_kind``)."""
    by_kind = {}
    if collective_bytes_ is None:
        from repro_torch.parallel import collectives

        by_kind = collectives.counts()
        collective_bytes_ = collective_bytes(by_kind)
    compute_s = flops / hw.peak(dtype)
    memory_s = bytes_ / hw.hbm_bw
    collective_s = collective_bytes_ / hw.ici_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    return RooflineTerms(
        flops_per_device=float(flops),
        bytes_per_device=float(bytes_),
        collective_bytes_per_device=float(collective_bytes_),
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=max(terms, key=terms.get),
        collectives_by_kind=by_kind,
        warnings=[],
    )


def model_flops(cfg, shape, *, backward: bool) -> float:
    """MODEL_FLOPS = 6 N_active D (train) or 2 N_active D (inference).

    N_active counts embedding-free active parameters (MoE: top_k experts +
    shared, and the router); D = processed tokens.  The same arithmetic as
    the reference, so the two agree exactly.
    """
    D = cfg.d_model
    n = 0
    for kind in layer_kinds(cfg):
        mixer, ffn = kind.split("+")
        if mixer == "attn":
            if cfg.is_mla:
                qk = cfg.qk_nope_dim + cfg.qk_rope_dim
                n += D * cfg.q_lora_rank + cfg.q_lora_rank * cfg.num_heads * qk
                n += D * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                n += cfg.kv_lora_rank * cfg.num_heads * (
                    cfg.qk_nope_dim + cfg.v_head_dim)
                n += cfg.num_heads * cfg.v_head_dim * D
            else:
                n += D * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
                n += cfg.num_heads * cfg.head_dim * D
        else:
            s = cfg.ssm
            n += D * (2 * s.d_inner + 2 * s.n_groups * s.d_state
                      + s.d_inner // s.headdim)
            n += s.d_inner * D
        if ffn == "dense":
            n += 3 * D * cfg.d_ff
        elif ffn == "moe":
            m = cfg.moe
            n += 3 * D * m.d_ff * m.top_k
            n += 3 * D * m.shared_d_ff * m.n_shared_experts
            n += D * m.num_experts  # router
    # lm head (tied or not, the matmul runs)
    n_head = cfg.d_model * cfg.vocab_size
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if backward else 2.0
    return mult * (n + n_head) * tokens
