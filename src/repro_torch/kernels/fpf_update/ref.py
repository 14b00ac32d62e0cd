"""Plain PyTorch version of the FPF min-distance/argmax step (the CPU path
and the card's reference for ``csrc/fpf_update.cu``)."""
from __future__ import annotations

import torch


def fpf_update_ref(x: torch.Tensor, rep: torch.Tensor, min_d2: torch.Tensor):
    """x (N,D), rep (D,), min_d2 (N,) -> (new_min_d2 (N,), argmax idx, max
    val), the index an int32 scalar tensor, the first one on ties.

    new_min = min(min_d2, ||x - rep||^2); the argmax of new_min is the next
    FPF representative (Gonzalez 1985).
    """
    d2 = ((x.to(torch.float32) - rep.to(torch.float32)[None]) ** 2).sum(1)
    new_min = torch.minimum(min_d2, d2)
    idx = torch.argmax(new_min)
    return new_min, idx.to(torch.int32), new_min[idx]
