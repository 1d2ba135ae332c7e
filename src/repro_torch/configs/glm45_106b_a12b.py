"""glm4.5-106b-a12b [paper model]: 46L d_model=4096 128 experts top-8,
GShard aux loss.  Paper Table 3 evaluation model.  [arXiv:2508.06471]

Mirrors ``repro.configs.glm45_106b_a12b``.
"""
from repro_torch.configs.base import ModelConfig, MoEArch, register


@register("glm45-106b-a12b")
def glm45_106b_a12b() -> ModelConfig:
    return ModelConfig(
        name="glm45-106b-a12b",
        family="moe",
        num_layers=46,
        d_model=4096,
        vocab_size=151_552,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        moe=MoEArch(num_experts=128, top_k=8, d_ff=1408, n_slot=2,
                    n_shared_experts=1, shared_d_ff=1408),
        shape_skips=("long_500k",),
        source="arXiv:2508.06471 (paper Table 3)",
    )
