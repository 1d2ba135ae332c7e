"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2, Mamba+attn 1:7 interleave.

[arXiv:2403.19887; hf]  Attention at layer i % 8 == 4; MoE every other
layer.  UltraEP balances the MoE layers.  Jamba uses the Mamba-1 selective
scan; the SSM blocks here use the Mamba-2 SSD form (d_state=16 as
published), as the JAX package does.

Mirrors ``repro.configs.jamba_v01_52b``.
"""
from repro_torch.configs.base import ModelConfig, MoEArch, SSMArch, register


@register("jamba-v0.1-52b")
def jamba_v01_52b() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        vocab_size=65_536,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14_336,
        moe=MoEArch(num_experts=16, top_k=2, d_ff=14_336, layer_period=2,
                    n_slot=2),
        ssm=SSMArch(d_inner=8192, d_state=16, headdim=64, n_groups=8,
                    attn_period=8, attn_offset=4),
        shape_skips=(),   # hybrid: long_500k runs
        source="arXiv:2403.19887",
    )
