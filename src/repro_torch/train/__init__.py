"""Training (mirrors ``repro.train``): the train step (``loop``) and the
fault-tolerant supervisor (``fault``)."""
