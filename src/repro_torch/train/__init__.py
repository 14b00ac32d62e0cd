"""Serving steps of the port (the training step waits for ROADMAP A1)."""
