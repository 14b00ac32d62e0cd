"""Matrix products at a stated precision, for the references and their
controls: float32 with TF32 off (the references), TF32 (float32 inputs
rounded to 10 mantissa bits, then float32 products and sums: what the
tensor cores do) and fp8 (e4m3 with one scale a tensor, products summed in
float32 and the result rounded to bfloat16).  The roundings are done by
hand, so a control computes the same on the CPU as on the card."""
from __future__ import annotations

from contextlib import contextmanager

import torch

PRECISIONS = ("float32", "tf32", "fp8")
#: the control's precision: the nearest below the one a configuration states
BELOW = {"float32": "tf32", "bfloat16": "fp8"}
FP8_MAX = 448.0


@contextmanager
def exact_float32():
    """TF32 off for the products inside, whatever it was before."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest-even at TF32's 10 mantissa bits."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def fp8(x: torch.Tensor):
    """(x as e4m3 values in bfloat16, 1 / its scale): the tensor scaled so
    that its largest magnitude is e4m3's largest, then rounded."""
    amax = x.abs().amax().float().clamp_min(1e-30)
    scale = FP8_MAX / amax
    q = (x.float() * scale).to(torch.float8_e4m3fn).to(torch.bfloat16)
    return q, 1.0 / scale


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b (or an einsum's operands through ``ein``) at ``precision``,
    float32 out."""
    return ein("...ij,...jk->...ik", a, b, precision=precision)


def ein(spec: str, a: torch.Tensor, b: torch.Tensor,
        precision: str) -> torch.Tensor:
    if precision == "float32":
        return torch.einsum(spec, a.float(), b.float())
    if precision == "tf32":
        return torch.einsum(spec, round_tf32(a), round_tf32(b))
    if precision == "fp8":
        qa, sa = fp8(a)
        qb, sb = fp8(b)
        return torch.einsum(spec, qa, qb).float() * (sa * sb)
    raise ValueError(f"precision {precision!r}; have {PRECISIONS}")
