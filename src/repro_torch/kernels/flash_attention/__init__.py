"""Flash attention with cache offsets (CUDA C++ for sm_90a)."""

from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
