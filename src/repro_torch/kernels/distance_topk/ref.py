"""Plain PyTorch version of blocked pairwise-L2 + top-k (the CPU path and
the card's reference for ``csrc/distance_topk.cu``)."""
from __future__ import annotations

import torch


def distance_topk_ref(x: torch.Tensor, r: torch.Tensor, k: int):
    """x (N,D), r (C,D) -> (dists (N,k) float32, ids (N,k) int32), ascending
    by distance, lower id first on ties (as ``lax.top_k``).

    Distances are squared L2 in the reference's expanded form
    ``|x|^2 + |r|^2 - 2 x.r``, clamped at 0, in float32.
    """
    # TF32 would keep ~3 decimal digits; the plain version is exact float32
    torch.backends.cuda.matmul.allow_tf32 = False
    xf = x.to(torch.float32)
    rf = r.to(torch.float32)
    d2 = ((xf * xf).sum(1)[:, None] + (rf * rf).sum(1)[None, :]
          - 2.0 * (xf @ rf.T))
    d2 = torch.clamp_min(d2, 0.0)
    vals, ids = torch.sort(d2, dim=1, stable=True)
    return vals[:, :k].contiguous(), ids[:, :k].to(torch.int32).contiguous()
