"""qwen3-235b-a22b [paper model]: 94L d_model=4096 64H (GQA kv=4) 128 experts
top-8, expert d_ff=1536, vocab=151936.  Paper Table 3 evaluation model.
[arXiv:2505.09388; hf]

Mirrors ``repro.configs.qwen3_235b_a22b``.
"""
from repro_torch.configs.base import ModelConfig, MoEArch, register


@register("qwen3-235b-a22b")
def qwen3_235b_a22b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        vocab_size=151_936,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        qk_norm=True,
        moe=MoEArch(num_experts=128, top_k=8, d_ff=1536, n_slot=2),
        shape_skips=("long_500k",),
        source="arXiv:2505.09388 (paper Table 3)",
    )
