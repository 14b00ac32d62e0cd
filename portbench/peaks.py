"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet,
dense rates, at its 700 W limit), and the least time they allow."""
from __future__ import annotations

FLOPS = {"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989e12}
BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, peak: str) -> float:
    """The larger of the operations over the peak rate of ``peak`` and
    the bytes over the memory bandwidth."""
    return max(flops / FLOPS[peak], nbytes / BYTES_PER_S)
