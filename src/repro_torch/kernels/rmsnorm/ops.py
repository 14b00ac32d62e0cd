"""Wrapper of the ``rmsnorm`` CUDA kernel, beside its plain version
(``ref.rmsnorm_ref``).

:func:`rmsnorm_route` picks the version from the inputs alone: the plain
version for a CPU tensor and for an input that needs a gradient (no kernel
of the port has a backward, so training keeps autograd through the plain
version); the kernel for any other CUDA tensor, or raises where the kernel
cannot take it (there is no fallback).  The mesh paths hand the norm each
rank's local tensor.  A CUDA tensor launches the kernel directly; a tensor
with no data (``device.is_traced``: the dry run's) takes the custom op
``torch.ops.repro_torch.rmsnorm``, whose fake implementation returns an
output of x's shape and dtype, launches nothing and records the call
(``_build.count_traced``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import is_traced
from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

#: the kernel's element types, as the dtype codes of ``csrc/common.cuh``
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: the widest row the kernel holds: 1,024 threads of eight 16-byte chunks
#: (``csrc/rmsnorm.cu``'s MAX_THREADS and MAX_CHUNKS)
MAX_ROW_BYTES = 1024 * 8 * 16


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise where the kernel cannot take x and scale."""
    d = x.shape[-1] if x.ndim else 0
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32/float16/bfloat16 x "
                        f"and scale, got {x.dtype} and {scale.dtype}")
    if tuple(scale.shape) != (d,) or scale.device != x.device:
        raise ValueError(f"rmsnorm kernel takes a scale of shape ({d},) on "
                         f"x's device, got {tuple(scale.shape)} on "
                         f"{scale.device}")
    row = d * x.element_size()
    if d == 0 or row % 16 or row > MAX_ROW_BYTES:
        raise ValueError(f"rmsnorm kernel takes rows of a multiple of 16 "
                         f"bytes up to {MAX_ROW_BYTES}, got {d} x "
                         f"{x.dtype}")


def rmsnorm_route(x: torch.Tensor, scale: torch.Tensor) -> str:
    """``"plain"`` or ``"kernel"``: the version that x and scale take, from
    their device, grad mode and type alone; raises for a CUDA (or traced)
    input the kernel cannot take, and for any other device."""
    if x.device.type == "cpu":
        return "plain"
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return "plain"
    if x.device.type == "cuda" or is_traced(x):
        _check(x, scale)
        return "kernel"
    raise ValueError(f"no rmsnorm for device {x.device}")


def traced_cost(rows: int, d: int, item: int, scale_item: int):
    """(operations, bytes) of a launch on ``rows`` rows of ``d``: four
    operations an element (square, sum, two products), x read and y written
    once, the scale read once."""
    return 4.0 * rows * d, 2 * rows * d * item + d * scale_item


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=(),
                         device_types="cuda")
def _rmsnorm_op(x: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    _check(x, scale)
    return _launch(x, scale, eps)


@_rmsnorm_op.register_fake
def _rmsnorm_traced(x, scale, eps):
    _check(x, scale)
    d = x.shape[-1]
    flops, nbytes = traced_cost(x.numel() // d, d, x.element_size(),
                                scale.element_size())
    _build.count_traced(rmsnorm, "kernel", flops, nbytes)
    return x.new_empty(x.shape)


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel on x and scale that ``_check`` passed."""
    d = x.shape[-1]
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x.numel() // d
    if rows == 0:
        return out
    x2 = x.reshape(rows, d)             # a view where the layout allows
    stride = x2.stride(0) if rows > 1 else d
    if x2.stride(1) != 1 or (stride * x.element_size()) % 16 or \
            x2.data_ptr() % 16:
        x2, stride = _build.aligned16(x2), d
    scale = _build.aligned16(scale)
    fn = _build.bind("rmsnorm", "rmsnorm_launch",
                     [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_float,
                                              ctypes.c_void_p])
    status = fn(_build.ptr(x2), _build.ptr(scale), _build.ptr(out), rows, d,
                stride, _DTYPES[x.dtype], _DTYPES[scale.dtype], float(eps),
                _build.stream_of(x))
    _build.check("rmsnorm", status, "rmsnorm")
    _build.count_launch(rmsnorm)
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x (..., d), scale (d,) -> x * rsqrt(mean(x^2) + eps) * scale over the
    last dim, in float32, in x's dtype; through the version
    :func:`rmsnorm_route` picks."""
    if rmsnorm_route(x, scale) == "plain":
        return rmsnorm_ref(x, scale, eps)
    if is_traced(x):
        return torch.ops.repro_torch.rmsnorm(x, scale, float(eps))
    return _launch(x, scale, eps)


#: kernel launches since the count was last reset
rmsnorm.launches = 0
