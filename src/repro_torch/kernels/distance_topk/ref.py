"""Plain PyTorch versions of blocked pairwise-L2 + top-k: the CPU path and
the card's reference for ``csrc/distance_topk.cu`` (:func:`distance_topk_ref`),
and the arithmetic of its tensor-core route in plain PyTorch
(:func:`distance_topk_tc_ref`)."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_float32_matmul():
    """Float32 products in full float32 inside the block (no TF32 on a
    card); the process-wide setting is restored on the way out."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _topk_of(d2: torch.Tensor, k: int):
    d2 = torch.clamp_min(d2, 0.0)
    vals, ids = torch.sort(d2, dim=1, stable=True)
    return vals[:, :k].contiguous(), ids[:, :k].to(torch.int32).contiguous()


def _sqnorm(a: torch.Tensor) -> torch.Tensor:
    return (a * a).sum(1)


def distance_topk_ref(x: torch.Tensor, r: torch.Tensor, k: int):
    """x (N,D), r (C,D) -> (dists (N,k) float32, ids (N,k) int32), ascending
    by distance, lower id first on ties (as ``lax.top_k``).

    Distances are squared L2 in the reference's expanded form
    ``|x|^2 + |r|^2 - 2 x.r``, clamped at 0, in float32.
    """
    xf = x.to(torch.float32)
    rf = r.to(torch.float32)
    with exact_float32_matmul():       # TF32 would keep ~3 decimal digits
        xr = xf @ rf.T
    return _topk_of((_sqnorm(xf)[:, None] + _sqnorm(rf)[None, :]) - 2.0 * xr,
                    k)


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the bit pattern of float32 ``a``: round to
    nearest, ties away from zero, at TF32's 10 mantissa bits (the 13 bits
    below cleared).  The magnitude's bits are rounded as an integer, so a
    carry moves into the exponent as the hardware's does."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def tf32_split(a: torch.Tensor):
    """(hi, lo): hi = rna(a), lo = rna(a - hi), both TF32 values."""
    a = a.to(torch.float32)
    hi = tf32_round(a)
    return hi, tf32_round(a - hi)


def distance_topk_tc_ref(x: torch.Tensor, r: torch.Tensor, k: int,
                         passes: int = 3):
    """The tc route's arithmetic in plain PyTorch: float32 inputs as
    3xTF32, ``(x_hi.r_lo + x_lo.r_hi) + x_hi.r_hi`` (``passes=3``, the small
    terms summed first, in the kernel's order), or
    single-pass TF32, ``x_hi.r_hi`` (``passes=1``, the witness of what the
    split is for).  Each product of two TF32 values is exact in float32;
    the sums are float32.  16-bit inputs take one pass of exact products,
    which is :func:`distance_topk_ref`.  Norms and the epilogue as there."""
    if x.dtype != torch.float32:
        return distance_topk_ref(x, r, k)
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    xh, xl = tf32_split(x)
    rh, rl = tf32_split(r)
    with exact_float32_matmul():
        acc = xh @ rh.T
        if passes == 3:
            acc = (xh @ rl.T + xl @ rh.T) + acc
    return _topk_of((_sqnorm(x)[:, None] + _sqnorm(r)[None, :]) - 2.0 * acc,
                    k)
