"""Wrapper of the ``moe_combine`` CUDA kernel, beside its plain version
(``ref.moe_combine_ref``).

:func:`moe_combine_route` picks the version from the inputs alone: the
plain version for a CPU tensor; the kernel for a CUDA tensor, or raises
where the kernel cannot take it (an input that needs a gradient, since no
kernel of the port has a backward, or a type or shape it does not take:
there is no fallback).  A tensor with no data (the dry run's) raises too:
no traced path runs the dropless MoE.  :data:`VERSIONS` holds the
function of each route, so that a caller that records the route calls
the one it recorded.  One kernel call is one launch of the library: the
positions (the inverse of the sort's order, a scatter of T k integers)
and the combine, two kernels on the caller's stream, nothing read back to
the host.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_combine.ref import moe_combine_ref

#: the kernel's row types, as the dtype codes of ``csrc/common.cuh``
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: the most choices a token (``csrc/moe_combine.cu``'s MAX_K)
MAX_K = 32


def _check(y: torch.Tensor, order: torch.Tensor,
           weights: torch.Tensor) -> None:
    """Raise where the kernel cannot take y, order and weights."""
    if y.dtype not in _DTYPES or weights.dtype != torch.float32 or \
            order.dtype != torch.int64:
        raise TypeError(f"moe_combine kernel takes float32/float16/bfloat16 "
                        f"rows, float32 weights and an int64 order, got "
                        f"{y.dtype}, {weights.dtype} and {order.dtype}")
    if y.ndim != 2 or weights.ndim != 2 or \
            tuple(order.shape) != (y.shape[0],) or \
            y.shape[0] != weights.numel():
        raise ValueError(f"moe_combine kernel takes rows (T k, d), an order "
                         f"(T k,) and weights (T, k), got "
                         f"{tuple(y.shape)}, {tuple(order.shape)} and "
                         f"{tuple(weights.shape)}")
    if not {order.device, weights.device} <= {y.device}:
        raise ValueError("moe_combine kernel takes its inputs on one device")
    k = weights.shape[1]
    if not 1 <= k <= MAX_K or y.shape[0] >= 2 ** 31:
        raise ValueError(f"moe_combine kernel takes 1 to {MAX_K} choices a "
                         f"token and fewer than 2^31 rows, got {k} and "
                         f"{y.shape[0]}")
    d = y.shape[1]
    if d == 0 or (d * y.element_size()) % 16:
        raise ValueError(f"moe_combine kernel takes rows of a multiple of 16 "
                         f"bytes, got {d} x {y.dtype}")


def moe_combine_route(y: torch.Tensor, order: torch.Tensor,
                      weights: torch.Tensor) -> str:
    """``"plain"`` or ``"kernel"``: the version that the inputs take, from
    their device alone; raises for a CUDA input the kernel cannot take
    (one that needs a gradient among them), and for any other device."""
    if y.device.type == "cpu":
        return "plain"
    if y.device.type == "cuda":
        _build.refuse_grad("moe_combine", y, weights)
        _check(y, order, weights)
        return "kernel"
    raise ValueError(f"no moe_combine for device {y.device}")


def _launch(y: torch.Tensor, order: torch.Tensor, weights: torch.Tensor):
    """(out, positions): the kernel on inputs that ``_check`` passed, and
    the inverse of ``order`` it made."""
    tokens, k = weights.shape
    out = torch.empty((tokens, y.shape[1]), dtype=y.dtype, device=y.device)
    pos = torch.empty(tokens * k, dtype=torch.int32, device=y.device)
    if tokens == 0:
        return out, pos
    y, order = _build.aligned16(y), order.contiguous()
    weights = weights.contiguous()
    fn = _build.bind("moe_combine", "moe_combine_launch",
                     [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p])
    status = fn(_build.ptr(y), _build.ptr(order), _build.ptr(weights),
                _build.ptr(pos), _build.ptr(out), tokens, k, y.shape[1],
                _DTYPES[y.dtype], _build.stream_of(y))
    _build.check("moe_combine", status, "moe_combine")
    _build.count_launch(moe_combine)
    return out, pos


def _kernel(y: torch.Tensor, order: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    return _launch(y, order, weights)[0]


#: the function of each route of :func:`moe_combine_route`
VERSIONS = {"plain": moe_combine_ref, "kernel": _kernel}


def moe_combine(y: torch.Tensor, order: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """y (T k, d), the experts' rows in expert order (row i is the
    (token, choice) pair ``order[i]``, flattened as ``t * k + j``), weights
    (T, k) float32 -> (T, d) in y's dtype: ``out[t] = sum_j weights[t, j]
    * y[row of (t, j)]`` in float32, through the version
    :func:`moe_combine_route` picks."""
    return VERSIONS[moe_combine_route(y, order, weights)](y, order, weights)


#: kernel launches since the count was last reset
moe_combine.launches = 0
