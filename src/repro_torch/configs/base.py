"""Config schema: architectures and the registry.

The port keeps its own copy of ``repro.configs.base`` (the port imports
nothing of the JAX package): :class:`ModelConfig`, :class:`MoEArch`,
:func:`layer_kinds`, :class:`ShapeSpec` with the ``SHAPES`` table and the
registry mirror it field for field, so a config built here describes the
same model as the JAX one of the same name.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["MoEArch", "SSMArch", "ModelConfig", "ShapeSpec", "SHAPES",
           "register", "get_config", "list_archs", "layer_kinds"]


@dataclasses.dataclass(frozen=True)
class MoEArch:
    num_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden
    score_fn: str = "softmax"
    norm_topk_prob: bool = True
    aux_loss_weight: float = 1e-2   # GShard loss (0 = disabled)
    use_bias: bool = False          # DeepSeek aux-free bias router
    bias_update_speed: float = 1e-3
    routed_scaling: float = 1.0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    layer_period: int = 1           # MoE every k-th layer
    first_dense_layers: int = 0     # leading dense-FFN layers
    n_slot: int = 2                 # redundant slots per rank (Table 3)


@dataclasses.dataclass(frozen=True)
class SSMArch:
    d_inner: int
    d_state: int = 128
    headdim: int = 64
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 128
    attn_period: int = 0            # hybrid: attention every k-th layer
    attn_offset: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    vocab_size: int
    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    causal: bool = True
    rope_theta: float = 10000.0
    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # dense FFN hidden (non-MoE layers)
    d_ff: int = 0
    moe: MoEArch | None = None
    ssm: SSMArch | None = None
    frontend: str = "none"
    num_patches: int = 256
    tie_embeddings: bool = False
    shape_skips: tuple[str, ...] = ()
    source: str = ""

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def has_decode(self) -> bool:
        return self.causal


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Per-layer block kind '<mixer>+<ffn>' (mirrors repro.configs.base.layer_kinds)."""
    kinds = []
    for i in range(cfg.num_layers):
        if cfg.ssm is not None:
            is_attn = (cfg.ssm.attn_period > 0
                       and i % cfg.ssm.attn_period == cfg.ssm.attn_offset)
            mixer = "attn" if is_attn else "mamba"
        else:
            mixer = "attn"
        if cfg.moe is not None:
            if i < cfg.moe.first_dense_layers:
                ffn = "dense"
            elif (i % cfg.moe.layer_period) == (cfg.moe.layer_period - 1) or \
                    cfg.moe.layer_period == 1:
                ffn = "moe"
            else:
                ffn = "dense"
        elif cfg.d_ff > 0:
            ffn = "dense"
        else:
            ffn = "none"
        kinds.append(f"{mixer}+{ffn}")
    return kinds


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
