"""Device policy of the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Without CUDA, asking for it (or for nothing) raises; the port
    never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def as_device_tensor(a, device: Optional[torch.device]) -> torch.Tensor:
    """``a`` (numpy or tensor) as a float tensor on ``device``, keeping
    float32/float16/bfloat16 and casting anything else to float32."""
    t = torch.as_tensor(a, device=device)
    if t.dtype not in (torch.float32, torch.float16, torch.bfloat16):
        t = t.to(torch.float32)
    return t
