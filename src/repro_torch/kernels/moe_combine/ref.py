"""Plain PyTorch versions of the dropless MoE's combine (the CPU path and
the card's references for ``csrc/moe_combine.cu``).

:func:`moe_combine_ref` is the eager composition the port's dropless MoE
ran before the kernel: the rows times their weights in float32, added
back to their tokens by a scatter-add, cast once.  :func:`positions_ref`
is the inverse of the sort's order, which the kernel makes on the device;
:func:`combine_in_choice_order` is the kernel's own arithmetic (each
token's k products added in choice order), against which the kernel is
equal bit for bit."""
from __future__ import annotations

import torch


def moe_combine_ref(y: torch.Tensor, order: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """y (T k, d), the experts' rows in expert order (row i is the
    (token, choice) pair ``order[i]``, flattened as ``t * k + j``), weights
    (T, k) float32 -> (T, d) in y's dtype: each token's weighted rows
    summed in float32 by ``index_add_`` (on CUDA by atomics, in no fixed
    order)."""
    k = weights.shape[-1]
    scaled = y * weights.reshape(-1).index_select(0, order)[:, None]
    out = torch.zeros((weights.shape[0], y.shape[-1]), dtype=torch.float32,
                      device=y.device)
    out.index_add_(0, order // k, scaled)
    return out.to(y.dtype)


def positions_ref(order: torch.Tensor) -> torch.Tensor:
    """The inverse of the permutation ``order`` (int32): the row of y that
    holds each (token, choice) pair."""
    n = order.numel()
    return torch.empty(n, dtype=torch.int32, device=order.device).scatter_(
        0, order, torch.arange(n, dtype=torch.int32, device=order.device))


def combine_in_choice_order(y: torch.Tensor, pos: torch.Tensor,
                            weights: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic: for each token, from zero, add each
    choice's product ``y[pos[t, j]] * weights[t, j]`` (rounded to float32)
    in choice order j = 0 .. k - 1, then round once to y's dtype."""
    pos = pos.reshape(weights.shape).long()
    acc = torch.zeros((weights.shape[0], y.shape[-1]), dtype=torch.float32,
                      device=y.device)
    for j in range(weights.shape[1]):
        acc = acc + y.index_select(0, pos[:, j]).float() * weights[:, j, None]
    return acc.to(y.dtype)


#: explicit mantissa bits of each row type
_MANTISSA = {torch.float32: 23, torch.float16: 10, torch.bfloat16: 7}


def ulp(v: torch.Tensor) -> torch.Tensor:
    """The spacing of v's floating type at |v|, in float32 (at 0 and in
    the subnormal range, the spacing of the smallest normal binade)."""
    p = _MANTISSA[v.dtype]
    tiny = torch.finfo(v.dtype).tiny
    _, e = torch.frexp(v.float().abs().clamp(min=tiny))
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 1 - p)


def allowed_error(y: torch.Tensor, pos: torch.Tensor, weights: torch.Tensor,
                  a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The largest |a - b| (T, d) float32 for two sums of the same rounded
    products taken in two orders, each rounded once to y's type: each
    float32 order is within (k - 1) 2^-24 of the sum of |products| of the
    exact sum, and each rounding moves its result by at most half the
    spacing at the rounded value.  Where a token's terms do not cancel the
    first part is far below the second, so a and b lie within one ulp."""
    pos = pos.reshape(weights.shape).long()
    k = weights.shape[1]
    total = torch.zeros((weights.shape[0], y.shape[-1]), dtype=torch.float32,
                        device=y.device)
    for j in range(k):
        total += (y.index_select(0, pos[:, j]).float()
                  * weights[:, j, None]).abs()
    return (2 * (k - 1) * 2.0 ** -24 * (1 + 2.0 ** -20)) * total \
        + torch.maximum(ulp(a), ulp(b))
