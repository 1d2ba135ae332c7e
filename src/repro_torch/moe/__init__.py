"""Balanced MoE layer of the port: gate, plan, distribute, dispatch,
grouped FFN, combine."""
