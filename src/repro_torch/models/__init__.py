"""Model hosts of the port: GQA attention, residual blocks, the LM."""
