"""Architecture registry of the port: importing it registers every arch."""

from repro_torch.configs import base, glm45_106b_a12b  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    MoEArch,
    get_config,
    layer_kinds,
    list_archs,
)
