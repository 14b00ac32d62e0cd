"""Optimizers of the port."""
