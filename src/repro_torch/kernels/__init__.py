"""Hand-written Hopper kernels of the port (see ``build.py``)."""
