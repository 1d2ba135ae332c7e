"""Grouped GEMM kernels of the MoE expert FFN (CUDA C++ for sm_90a)."""

from repro_torch.kernels.grouped_gemm.ops import (  # noqa: F401
    grouped_matmul,
    grouped_matmul_q8,
    grouped_matmul_nt,
    grouped_matmul_nt_ref,
    grouped_matmul_q8_ref,
    grouped_matmul_ref,
    grouped_swiglu,
    grouped_swiglu_bwd,
    grouped_swiglu_bwd_ref,
    grouped_swiglu_q8,
    grouped_swiglu_q8_ref,
    grouped_swiglu_ref,
    grouped_wgrad,
    grouped_wgrad_ref,
)
