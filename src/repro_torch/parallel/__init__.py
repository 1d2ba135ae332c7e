"""Process groups, collectives, placement and the pipeline over
``torch.distributed`` (mirrors ``repro.parallel``)."""
