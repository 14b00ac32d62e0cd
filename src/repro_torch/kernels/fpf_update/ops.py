"""Wrapper of the ``fpf_update`` CUDA kernel: CPU tensors take the plain
version, CUDA tensors launch the kernel (or raise)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distance_topk.ops import _DTYPES
from repro_torch.kernels.fpf_update.ref import fpf_update_ref

#: the kernel keeps the rep in 48 KB of shared memory
MAX_D = 12288


def _launch(x: torch.Tensor, rep: torch.Tensor, min_d2: torch.Tensor):
    _build.refuse_grad("fpf_update", x, rep, min_d2)
    if x.dtype not in _DTYPES or rep.dtype != x.dtype:
        raise TypeError(f"fpf_update kernel takes float32/float16/bfloat16 x "
                        f"and rep of one dtype, got {x.dtype} and {rep.dtype}")
    if min_d2.dtype != torch.float32:
        raise TypeError(f"min_d2 must be float32, got {min_d2.dtype}")
    n, d = x.shape
    if rep.shape != (d,) or min_d2.shape != (n,):
        raise ValueError(f"shapes {tuple(x.shape)}, {tuple(rep.shape)}, "
                         f"{tuple(min_d2.shape)}")
    if n == 0 or n >= 2 ** 31 or d > MAX_D:
        raise ValueError(f"fpf_update kernel takes 1 <= N < 2**31 records "
                         f"and D <= {MAX_D}, got {n} x {d}")
    x, rep, min_d2 = x.contiguous(), rep.contiguous(), min_d2.contiguous()
    new_min = torch.empty_like(min_d2)
    best = torch.empty((1,), dtype=torch.int64, device=x.device)  # scratch
    idx = torch.empty((), dtype=torch.int32, device=x.device)
    val = torch.empty((), dtype=torch.float32, device=x.device)
    fn = _build.bind("fpf_update", "fpf_update_launch",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p] * 5)
    status = fn(_build.ptr(x), _build.ptr(rep), _build.ptr(min_d2), n, d,
                _DTYPES[x.dtype], _build.ptr(new_min), _build.ptr(best),
                _build.ptr(idx), _build.ptr(val), _build.stream_of(x))
    _build.check("fpf_update", status, "fpf_update")
    _build.count_launch(fpf_update)
    return new_min, idx, val


def fpf_update(x: torch.Tensor, rep: torch.Tensor, min_d2: torch.Tensor):
    """One FPF step: x (N,D), rep (D,), min_d2 (N,) float32 ->
    (new_min (N,), argmax (int32 scalar tensor), max (float32 scalar
    tensor)), the lowest index on ties.  Results stay on the device."""
    if x.device.type == "cpu":
        return fpf_update_ref(x, rep, min_d2)
    if x.device.type == "cuda":
        return _launch(x, rep, min_d2)
    raise ValueError(f"no fpf_update for device {x.device}")


#: kernel launches since the count was last reset
fpf_update.launches = 0
