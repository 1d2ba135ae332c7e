"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544.  [arXiv:2403.17297; hf]

Mirrors ``repro.configs.internlm2_1_8b``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("internlm2-1.8b")
def internlm2_1_8b() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        num_layers=24,
        d_model=2048,
        vocab_size=92_544,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        shape_skips=("long_500k",),
        source="arXiv:2403.17297",
    )
