"""Int8 error-feedback gradient compression for the data-parallel
all-reduce, as ``repro.optim.compression`` computes it.

Each gradient is quantized to int8 codes with a per-tensor max-abs scale,
and the quantization residual is carried as error feedback into the next
step's gradient:

    s   = max over ranks of the local max-abs / 127   (one scalar all_reduce)
    q_i = round(g_i / s), clipped to +-127            (int8 codes)
    g   = sum over ranks of q_i * s / n               (shared scale: exact)

The codes are summed as int32 (no overflow: |q| <= 127 on up to 2**24
ranks), so the wire carries 4 bytes an element, not 1: the JAX package's
docstring calls its payload int8, but it psums int32 too.  The
arithmetic is the JAX package's: ``torch.round`` rounds half to even, as
``jnp.round`` does, and the scale has a floor of 1e-12.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.common import (PyTree, tree_leaves,
                                       tree_unflatten_like)
from repro_torch.parallel import collectives


def _scale(max_abs: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(max_abs, 1e-12) / 127.0


def _codes(gf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g -> (int8 codes, float32 scalar scale)."""
    gf = g.float()
    scale = _scale(torch.max(torch.abs(gf)))
    return _codes(gf, scale), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_decompress(g: torch.Tensor,
                        error: Optional[torch.Tensor] = None):
    """Local error-feedback quantization round trip: returns (the
    dequantized ``g + error`` in g's dtype, the new float32 error)."""
    gf = g.float()
    if error is not None:
        gf = gf + error.float()
    q, scale = quantize(gf)
    deq = dequantize(q, scale, torch.float32)
    return deq.to(g.dtype), gf - deq


def make_compressed_psum(mesh, dp_axes: Sequence[str]):
    """Returns f(local_grads, errors) -> (mean_grads, new_errors): the
    compressed mean over the ``DeviceMesh`` dims ``dp_axes`` (the ranks
    that share this rank's other coordinates), leaf by leaf over a tree.

    Per leaf: one ``all_reduce(MAX)`` of the local max-abs of ``g + e``, a
    scale shared by every rank, one ``all_reduce(SUM)`` of the int8 codes
    as int32, the mean in g's dtype, and the local error
    ``g + e - dequant(q)`` in float32."""
    dp_axes = tuple(dp_axes)
    n_shards = collectives.group_size(mesh, dp_axes)

    def local(g: torch.Tensor, e: torch.Tensor):
        gf = g.float() + e
        # shared scale: a per-rank scale cannot be undone after the sum
        local_max = torch.max(torch.abs(gf)).reshape(1)
        collectives.all_reduce(local_max, mesh, dp_axes,
                               op=dist.ReduceOp.MAX)
        scale = _scale(local_max[0])
        q = _codes(gf, scale)
        q_sum = collectives.all_reduce(q.to(torch.int32), mesh, dp_axes)
        mean_g = (q_sum.float() * scale) / n_shards
        new_e = gf - dequantize(q, scale, torch.float32)
        return mean_g.to(g.dtype), new_e

    def compressed(grads: PyTree, errors: PyTree):
        outs = [local(g, e) for g, e in zip(tree_leaves(grads),
                                             tree_leaves(errors))]
        return (tree_unflatten_like(grads, [o[0] for o in outs]),
                tree_unflatten_like(grads, [o[1] for o in outs]))

    return compressed
