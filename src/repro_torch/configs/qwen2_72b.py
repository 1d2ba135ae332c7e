"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

GQA with QKV bias.  [arXiv:2407.10671; hf]
UltraEP inapplicable (dense FFN, no EP) -- see DESIGN.md S4.

Mirrors ``repro.configs.qwen2_72b``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-72b")
def qwen2_72b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        num_layers=80,
        d_model=8192,
        vocab_size=152_064,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        qkv_bias=True,
        d_ff=29_568,
        rope_theta=1e6,
        shape_skips=("long_500k",),   # full quadratic attention
        source="arXiv:2407.10671",
    )
