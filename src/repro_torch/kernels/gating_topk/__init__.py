"""Fused router top-k kernel (CUDA C++ for sm_90a)."""

from repro_torch.kernels.gating_topk.ops import (  # noqa: F401
    gating_topk,
    gating_topk_ref,
)
