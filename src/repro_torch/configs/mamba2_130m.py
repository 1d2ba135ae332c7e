"""mamba2-130m [ssm]: 24L d_model=768, attn-free, vocab=50280, ssm_state=128.

SSD (state-space duality).  [arXiv:2405.21060; unverified]
UltraEP inapplicable (no experts) -- see DESIGN.md S4.

Mirrors ``repro.configs.mamba2_130m``.
"""
from repro_torch.configs.base import ModelConfig, SSMArch, register


@register("mamba2-130m")
def mamba2_130m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        vocab_size=50_280,
        ssm=SSMArch(d_inner=1536, d_state=128, headdim=64, n_groups=1),
        tie_embeddings=True,
        shape_skips=(),   # sub-quadratic: long_500k runs
        source="arXiv:2405.21060",
    )
