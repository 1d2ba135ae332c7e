"""SSD (Mamba-2) intra-chunk scan kernel (CUDA C++ for sm_90a)."""

from repro_torch.kernels.ssd_scan.ops import (  # noqa: F401
    ssd_chunk_scan,
    ssd_chunk_scan_ref,
    ssd_intra_chunk,
    ssd_intra_chunk_ref,
)
