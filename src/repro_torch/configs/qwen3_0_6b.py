"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.

qk_norm, GQA, head_dim=128.  [hf:Qwen/Qwen3-8B family; hf]

Mirrors ``repro.configs.qwen3_0_6b``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-0.6b")
def qwen3_0_6b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b",
        family="dense",
        num_layers=28,
        d_model=1024,
        vocab_size=151_936,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        qk_norm=True,
        d_ff=3072,
        rope_theta=1e6,
        tie_embeddings=True,
        shape_skips=("long_500k",),
        source="hf:Qwen/Qwen3-0.6B",
    )
