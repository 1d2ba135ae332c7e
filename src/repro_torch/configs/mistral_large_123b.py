"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407; unverified]

Mirrors ``repro.configs.mistral_large_123b``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("mistral-large-123b")
def mistral_large_123b() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b",
        family="dense",
        num_layers=88,
        d_model=12_288,
        vocab_size=32_768,
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28_672,
        rope_theta=1e6,
        shape_skips=("long_500k",),
        source="hf:mistralai/Mistral-Large-Instruct-2407",
    )
