"""UltraEP plan solve kernel (CUDA C++ for sm_90a)."""

from repro_torch.kernels.plan_solve.ops import (  # noqa: F401
    plan_solve,
    plan_solve_ref,
)
