"""Architecture registry of the port: importing it registers every arch."""

from repro_torch.configs import (  # noqa: F401
    base,
    deepseek_v3_671b,
    glm45_106b_a12b,
    jamba_v01_52b,
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
