"""Roofline analysis: the card's figures and the terms of a step."""

from repro_torch.roofline.analysis import (
    RooflineTerms,
    collective_bytes,
    model_flops,
    roofline_terms,
)
from repro_torch.roofline.hw import H100, Hardware

__all__ = ["H100", "Hardware", "RooflineTerms", "collective_bytes",
           "roofline_terms", "model_flops"]
