"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only (bidirectional), same backbone as wav2vec2.
[arXiv:2106.07447; unverified]  Modality frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, S, d_model).  No decode shapes.

Mirrors ``repro.configs.hubert_xlarge``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("hubert-xlarge")
def hubert_xlarge() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        vocab_size=504,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        causal=False,
        d_ff=5120,
        frontend="audio_frames",
        shape_skips=("decode_32k", "long_500k"),   # encoder-only
        source="arXiv:2106.07447",
    )
