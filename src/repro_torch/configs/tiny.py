"""Reduced test configs: same families, tiny dims (smoke tests / CI).

Mirrors ``repro.configs.tiny`` (the port keeps its own copy), so the port
and the reference can run ``tiny-moe`` side by side, the frontend stubs
(``tiny-audio``, ``tiny-vlm``) among them.
"""
from repro_torch.configs.base import ModelConfig, MoEArch, SSMArch, register


@register("tiny-dense")
def tiny_dense() -> ModelConfig:
    return ModelConfig(
        name="tiny-dense", family="dense", num_layers=2, d_model=32,
        vocab_size=128, num_heads=4, num_kv_heads=2, head_dim=8,
        qkv_bias=True, qk_norm=True, d_ff=64, shape_skips=("long_500k",),
    )


@register("tiny-moe")
def tiny_moe() -> ModelConfig:
    return ModelConfig(
        name="tiny-moe", family="moe", num_layers=2, d_model=32,
        vocab_size=128, num_heads=4, num_kv_heads=2, head_dim=8,
        moe=MoEArch(num_experts=8, top_k=2, d_ff=32, n_slot=2),
        shape_skips=("long_500k",),
    )


@register("tiny-mla-moe")
def tiny_mla_moe() -> ModelConfig:
    return ModelConfig(
        name="tiny-mla-moe", family="moe", num_layers=2, d_model=32,
        vocab_size=128, num_heads=4, num_kv_heads=4, head_dim=0,
        q_lora_rank=16, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=4,
        v_head_dim=8, d_ff=64,
        moe=MoEArch(num_experts=8, top_k=2, d_ff=32, score_fn="sigmoid",
                    use_bias=True, aux_loss_weight=0.0, n_shared_experts=1,
                    shared_d_ff=32, first_dense_layers=1, n_slot=2),
        shape_skips=("long_500k",),
    )


@register("tiny-ssm")
def tiny_ssm() -> ModelConfig:
    return ModelConfig(
        name="tiny-ssm", family="ssm", num_layers=2, d_model=32,
        vocab_size=128, ssm=SSMArch(d_inner=64, d_state=16, headdim=16,
                                    chunk=16),
        tie_embeddings=True,
    )


@register("tiny-hybrid")
def tiny_hybrid() -> ModelConfig:
    return ModelConfig(
        name="tiny-hybrid", family="hybrid", num_layers=4, d_model=32,
        vocab_size=128, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
        moe=MoEArch(num_experts=8, top_k=2, d_ff=32, layer_period=2,
                    n_slot=2),
        ssm=SSMArch(d_inner=64, d_state=16, headdim=16, chunk=16,
                    attn_period=4, attn_offset=2),
    )


@register("tiny-audio")
def tiny_audio() -> ModelConfig:
    return ModelConfig(
        name="tiny-audio", family="audio", num_layers=2, d_model=32,
        vocab_size=64, num_heads=4, num_kv_heads=4, head_dim=8, d_ff=64,
        causal=False, frontend="audio_frames",
        shape_skips=("decode_32k", "long_500k"),
    )


@register("tiny-vlm")
def tiny_vlm() -> ModelConfig:
    return ModelConfig(
        name="tiny-vlm", family="vlm", num_layers=2, d_model=32,
        vocab_size=128, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
        frontend="vision_patches", num_patches=8,
        shape_skips=("long_500k",),
    )
