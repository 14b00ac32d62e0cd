"""Plain PyTorch version of RMSNorm (the CPU path, the training path and
the card's reference for ``csrc/rmsnorm.cu``): the eager composition the
port's models ran before the kernel."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """In float32, cast back to x's dtype (``repro.models.common.rmsnorm``)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)
