"""The port's counterparts of ``examples/``: runnable end-to-end drivers,
on the card by default (``--device cpu`` for the CPU):

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.balancing_demo
    PYTHONPATH=src python -m repro_torch.examples.train_moe_100m
"""
