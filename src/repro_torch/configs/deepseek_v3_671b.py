"""deepseek-v3-671b [moe]: 61L d_model=7168 128H MLA d_ff=2048(expert)
vocab=129280, MoE 256e top-8 + 1 shared, aux-free sigmoid router.

[arXiv:2412.19437; hf]  The paper's flagship UltraEP case.  MLA in its
cache-efficient latent form (q_lora=1536, kv_lora=512, nope=128, rope=64,
v=128).  First 3 layers dense FFN (d_ff=18432).  MTP head out of scope.

Mirrors ``repro.configs.deepseek_v3_671b``.  Like the reference, it has no
group-limited routing (DeepSeek's ``n_group`` / ``topk_group``: every
token picks its 8 experts among all 256) and no YaRN scaling of the rotary
frequencies.
"""
from repro_torch.configs.base import ModelConfig, MoEArch, register


@register("deepseek-v3-671b")
def deepseek_v3_671b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        num_layers=61,
        d_model=7168,
        vocab_size=129_280,
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        d_ff=18_432,
        moe=MoEArch(num_experts=256, top_k=8, d_ff=2048, score_fn="sigmoid",
                    use_bias=True, aux_loss_weight=0.0, routed_scaling=2.5,
                    n_shared_experts=1, shared_d_ff=2048,
                    first_dense_layers=3, n_slot=2),
        shape_skips=("long_500k",),   # MLA is still quadratic
        source="arXiv:2412.19437",
    )
