"""Target hardware constants: one NVIDIA H100 SXM5 80 GB.

The port's counterpart of ``repro.roofline.hw`` (whose ``V5E`` is the TPU
the reference was written for): the same ``Hardware`` fields, and
``H100`` in place of ``V5E``.  Every figure is NVIDIA's data sheet for
the SXM5 part (dense rates, no sparsity), at its full 700 W power limit;
a card set below that limit runs slower under load, so a measured share
of these peaks stands beside the card's ``power.limit`` from
``nvidia-smi``.

``peak_flops`` is the bf16 tensor-core rate, as the reference's field is
its chip's bf16 rate.  The port also runs fp32 (on the CUDA cores, or on
the tensor cores in 3xTF32: three TF32 products for each fp32 one) and
int8, so ``peak_by_dtype`` holds a rate for each and :meth:`Hardware.peak`
reads it.
"""

from __future__ import annotations

import dataclasses
from types import MappingProxyType
from typing import Mapping

__all__ = ["Hardware", "H100"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float       # bf16 FLOP/s per card (dense)
    hbm_bw: float           # bytes/s per card
    ici_bw: float           # bytes/s of the card's interconnect (see H100)
    hbm_bytes: float        # capacity per card
    peak_by_dtype: Mapping[str, float] = dataclasses.field(
        default_factory=dict)

    def peak(self, dtype: str) -> float:
        """Operations a second in ``dtype``: "bf16", "fp16", "tf32",
        "tf32x3" (an fp32 product as three TF32 ones), "fp32" (the CUDA
        cores), "int8", "fp8"."""
        try:
            return self.peak_by_dtype[dtype]
        except KeyError:
            raise KeyError(f"{self.name} has no peak for {dtype!r}; it has "
                           f"{sorted(self.peak_by_dtype)}") from None


_TF32 = 495e12

H100 = Hardware(
    name="nvidia-h100-sxm5-80gb",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    # NVLink 4 (18 links): 900 GB/s to the other cards of the host, both
    # directions together (450 GB/s each way).
    ici_bw=900e9,
    hbm_bytes=80e9,
    peak_by_dtype=MappingProxyType({
        "bf16": 989e12, "fp16": 989e12, "tf32": _TF32, "tf32x3": _TF32 / 3,
        "fp32": 67e12, "int8": 1979e12, "fp8": 1979e12}),
)
