"""Minimal functional parameter system + shared layers.

As in the JAX package, parameters are nested dicts (and tuples) of tensors,
and each layer exposes ``*_specs(cfg) -> tree of ParamSpec`` and an
``apply``-style function.  The trees have the JAX package's layout, leaf for
leaf, with blocks stacked over ``n_repeats`` on a leading axis, so
:func:`params_from_jax` is a plain conversion of every leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device

PyTree = Any

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones


def tree_map(fn: Callable, tree: PyTree) -> PyTree:
    """``fn`` over the leaves of a tree of dicts and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def init_params(specs: PyTree, generator: Optional[torch.Generator] = None,
                device=None) -> PyTree:
    """Materialize parameters as ``repro.models.common.init_params`` draws
    them: normal / sqrt(fan_in) with fan_in = ``shape[-2]`` (so a stacked
    (n_repeats, in, out) leaf scales by ``in``), zeros and ones where the
    spec says so.  Drawn in float32 from ``generator`` on its device, leaf
    by leaf in flattening order, then cast and placed on ``device``: CUDA
    unless the caller asks for another (``repro_torch.device``)."""
    device = resolve_device(device)
    draw_on = generator.device if generator is not None else device

    def one(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = 1.0 / np.sqrt(max(fan_in, 1))
        return (torch.randn(spec.shape, generator=generator, device=draw_on)
                * scale).to(device=device, dtype=spec.dtype)

    def build(tree):            # draw in sorted-key order, keep the layout
        if isinstance(tree, dict):
            vals = {k: build(tree[k]) for k in sorted(tree)}
            return {k: vals[k] for k in tree}
        if isinstance(tree, tuple):
            return tuple(build(v) for v in tree)
        return one(tree)

    return build(specs)


def stack_specs(tree: PyTree, n: int) -> PyTree:
    """Add a leading stacked-layer dimension to every spec."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, s.dtype, s.init),
                    tree)


def take_layer(params: PyTree, i: int) -> PyTree:
    """Slice layer ``i`` out of a stacked parameter tree (views)."""
    return tree_map(lambda a: a[i], params)


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree: PyTree) -> PyTree:
    """A JAX parameter pytree (numpy arrays, blocks stacked over
    ``n_repeats``) as the port's tree of CPU tensors: the same layout, leaf
    for leaf, the same dtypes (bfloat16 included)."""
    return tree_map(_to_tensor, tree)


class ParamTree(nn.Module):
    """A parameter tree held by an :class:`torch.nn.Module`, so that it
    moves with ``.to`` and saves with ``state_dict`` under dotted paths
    (``"blocks.0.attn.wq"``); :meth:`tree` gives the tree back."""

    def __init__(self, tree: PyTree):
        super().__init__()
        self._tuple = isinstance(tree, tuple)
        items = enumerate(tree) if self._tuple else tree.items()
        self._keys = []
        for k, v in items:
            self._keys.append(k)
            if isinstance(v, torch.Tensor):
                self.register_parameter(str(k), nn.Parameter(
                    v, requires_grad=False))
            else:
                self.add_module(str(k), ParamTree(v))

    def tree(self) -> PyTree:
        def get(k):
            v = getattr(self, str(k))
            return v.tree() if isinstance(v, ParamTree) else v
        if self._tuple:
            return tuple(get(k) for k in self._keys)
        return {k: get(k) for k in self._keys}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_specs(d: int, dtype: torch.dtype) -> PyTree:
    return {"scale": ParamSpec((d,), dtype, init="ones")}


def rmsnorm(params: PyTree, x: torch.Tensor, eps: float) -> torch.Tensor:
    """In float32, cast back to x's dtype (``repro.models.common.rmsnorm``)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)
