"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553.  InternViT frontend + InternLM2 backbone.

[arXiv:2404.16821; hf]  The vision frontend is a STUB: input_specs()
provides precomputed patch embeddings injected at the sequence prefix.

Mirrors ``repro.configs.internvl2_26b``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("internvl2-26b")
def internvl2_26b() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        num_layers=48,
        d_model=6144,
        vocab_size=92_553,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16_384,
        frontend="vision_patches",
        num_patches=256,
        shape_skips=("long_500k",),
        source="arXiv:2404.16821",
    )
