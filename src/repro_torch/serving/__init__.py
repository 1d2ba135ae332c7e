"""Serving layer of the port: engine and model adapter."""
