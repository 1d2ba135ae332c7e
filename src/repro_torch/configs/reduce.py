"""Family-faithful reduced configs (mirrors ``repro.configs.reduce``).

``reduced(cfg)`` keeps what defines the architecture family -- attention
flavour, MoE layout (top-k, shared experts, layer period, first-dense
prefix), tying -- while shrinking widths and depth so a step runs in
milliseconds on the CPU.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

__all__ = ["reduced"]


def reduced(cfg: ModelConfig, *, layers: int | None = None,
            d_model: int = 64, vocab: int = 512) -> ModelConfig:
    period = 1
    if cfg.ssm is not None and cfg.ssm.attn_period:
        period = max(period, cfg.ssm.attn_period)
    if cfg.moe is not None:
        period = max(period, cfg.moe.layer_period)
    prefix = cfg.moe.first_dense_layers if cfg.moe else 0
    L = layers if layers is not None else max(prefix + period, 2)

    moe = None
    if cfg.moe is not None:
        m = cfg.moe
        n_exp = max(8, min(16, m.num_experts))
        moe = dataclasses.replace(
            m, num_experts=n_exp, top_k=min(m.top_k, 4), d_ff=32,
            shared_d_ff=32 if m.n_shared_experts else 0,
            first_dense_layers=min(prefix, 1), n_slot=2,
        )
    ssm = None
    if cfg.ssm is not None:
        s = cfg.ssm
        ssm = dataclasses.replace(
            s, d_inner=2 * d_model, d_state=16, headdim=16,
            n_groups=min(s.n_groups, 2), chunk=16,
        )
    is_mla = cfg.is_mla
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=L,
        d_model=d_model,
        vocab_size=vocab,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=(4 if cfg.num_kv_heads == cfg.num_heads else 2)
        if cfg.num_kv_heads else 0,
        head_dim=16 if cfg.num_heads else 0,
        q_lora_rank=16 if is_mla else 0,
        kv_lora_rank=16 if is_mla else 0,
        qk_nope_dim=8 if is_mla else 0,
        qk_rope_dim=4 if is_mla else 0,
        v_head_dim=8 if is_mla else 0,
        d_ff=2 * d_model if cfg.d_ff else 0,
        moe=moe,
        ssm=ssm,
        num_patches=8 if cfg.frontend == "vision_patches" else cfg.num_patches,
    )
