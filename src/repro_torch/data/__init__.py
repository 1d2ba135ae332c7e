"""Training data (mirrors ``repro.data``)."""

from repro_torch.data.pipeline import DataConfig, SyntheticLMStream  # noqa: F401
