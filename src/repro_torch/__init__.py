"""PyTorch/CUDA port of the UltraEP reproduction.

A second package beside the JAX one (``src/repro``), which stays the
reference: module names and layout mirror it, and every function says which
``repro.<module>.<function>`` it follows.  The port imports ``torch`` and
numpy only.  Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; the hand-written Hopper kernels live under
:mod:`repro_torch.kernels`.
"""
