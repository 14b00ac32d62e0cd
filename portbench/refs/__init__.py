"""Plain references: plain PyTorch, importing neither the program nor JAX."""
