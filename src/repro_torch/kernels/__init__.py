"""Hand-written CUDA kernels of the port (see ``_build``), each beside its
plain PyTorch version."""
