"""Training loop (mirrors ``repro.train``; the fault-tolerant supervisor is
not ported yet)."""
