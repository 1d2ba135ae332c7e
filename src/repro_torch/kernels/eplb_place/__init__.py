"""EPLB greedy replica placement kernel (CUDA C++ for sm_90a)."""

from repro_torch.kernels.eplb_place.ops import (  # noqa: F401
    eplb_place,
    eplb_place_ref,
)
