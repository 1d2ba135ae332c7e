"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4 (fine-grained).  [hf:databricks/dbrx-base; unverified]

UltraEP applicable: coarse-expert regime (1 main expert per rank at EP16).

Mirrors ``repro.configs.dbrx_132b``.
"""
from repro_torch.configs.base import ModelConfig, MoEArch, register


@register("dbrx-132b")
def dbrx_132b() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=40,
        d_model=6144,
        vocab_size=100_352,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        moe=MoEArch(num_experts=16, top_k=4, d_ff=10_752, n_slot=4),
        shape_skips=("long_500k",),
        source="hf:databricks/dbrx-base",
    )
