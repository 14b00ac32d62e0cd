"""PyTorch/CUDA port of the TASTI system in ``repro``.

Module paths mirror ``src/repro/``.  Plain tensor code is PyTorch; each of
the JAX package's Pallas kernels on the ported path is a CUDA C++ kernel for
Hopper under ``csrc/``, built on first use by :mod:`repro_torch.kernels._build`.
Entry points run on CUDA unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).
"""
