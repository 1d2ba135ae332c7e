"""Architecture registry of the port: importing it registers every arch."""

from repro_torch.configs import (  # noqa: F401
    base,
    dbrx_132b,
    deepseek_v3_671b,
    glm45_106b_a12b,
    hubert_xlarge,
    internlm2_1_8b,
    internvl2_26b,
    jamba_v01_52b,
    mamba2_130m,
    mistral_large_123b,
    qwen2_72b,
    qwen3_0_6b,
    qwen3_235b_a22b,
    tiny,
)
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    MoEArch,
    ShapeSpec,
    SSMArch,
    get_config,
    layer_kinds,
    list_archs,
)

ASSIGNED_ARCHS = [
    "mamba2-130m",
    "qwen2-72b",
    "qwen3-0.6b",
    "mistral-large-123b",
    "internlm2-1.8b",
    "jamba-v0.1-52b",
    "hubert-xlarge",
    "internvl2-26b",
    "dbrx-132b",
    "deepseek-v3-671b",
]
PAPER_ARCHS = ["qwen3-235b-a22b", "glm45-106b-a12b"]
