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
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops

PyTree = Any

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ParamSpec:
    """A leaf's shape, dtype and initialisation, and one logical axis name
    per dim (``None`` for a replicated dim; ``logical_axes=None`` for all),
    which ``repro_torch.parallel.sharding`` maps to mesh axes."""
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones
    init_scale: float = 1.0
    logical_axes: Optional[Tuple[Optional[str], ...]] = None

    def __post_init__(self):
        if self.logical_axes is None:
            object.__setattr__(self, "logical_axes",
                               (None,) * len(self.shape))
        assert len(self.shape) == len(self.logical_axes), (
            self.shape, self.logical_axes)


#: a leaf whose float32 draw would exceed this many bytes is drawn slice by
#: slice along its leading axis (a stacked expert leaf of qwen3-moe-30b-a3b,
#: (48, 128, 2048, 768), would take 38.6 GB in float32 at once)
SLICE_DRAW_BYTES = 4 << 30


def tree_map(fn: Callable, tree: PyTree) -> PyTree:
    """``fn`` over the leaves of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: PyTree) -> list:
    """The leaves of a tree of dicts, tuples and lists in the JAX package's
    flattening order: dict keys sorted, sequences in order, ``None`` no
    leaf.  A list of tensors is its own leaves, so the same code serves a
    module's ``parameters()`` and a parameter tree."""
    return [leaf for _, leaf in tree_leaves_with_names(tree)]


def tree_leaves_with_names(tree: PyTree, prefix: str = "") -> list:
    """``(name, leaf)`` pairs in :func:`tree_leaves` order, each name the
    keys and indices of the leaf's path joined by ``/`` (``"blocks/0/wq"``),
    as ``repro.checkpoint.checkpointer`` names them."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(tree_leaves_with_names(v, f"{prefix}/{k}" if prefix else k))
    return out


def tree_unflatten_like(tree: PyTree, leaves: list) -> PyTree:
    """A tree of ``tree``'s layout holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def init_params(specs: PyTree, generator: Optional[torch.Generator] = None,
                device=None) -> PyTree:
    """Materialize parameters as ``repro.models.common.init_params`` draws
    them: normal x init_scale / sqrt(fan_in) with fan_in = ``shape[-2]``
    (so a stacked (n_repeats, in, out) leaf scales by ``in``), zeros and
    ones where the spec says so.  Drawn in float32 from ``generator`` on its
    device, leaf by leaf in flattening order, then cast and placed on
    ``device``: CUDA unless the caller asks for another
    (``repro_torch.device``).  A leaf whose float32 draw exceeds
    ``SLICE_DRAW_BYTES`` is drawn slice by slice along its leading axis,
    each slice cast into the placed tensor."""
    device = resolve_device(device)
    draw_on = generator.device if generator is not None else device

    def draw(shape, scale) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=draw_on) * scale

    def one(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.init_scale / np.sqrt(max(fan_in, 1))
        if 4 * int(np.prod(spec.shape)) <= SLICE_DRAW_BYTES:
            return draw(spec.shape, scale).to(device=device, dtype=spec.dtype)
        out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
        for part in out:
            part.copy_(draw(spec.shape[1:], scale))
        return out

    def build(tree):            # draw in sorted-key order, keep the layout
        if isinstance(tree, dict):
            vals = {k: build(tree[k]) for k in sorted(tree)}
            return {k: vals[k] for k in tree}
        if isinstance(tree, tuple):
            return tuple(build(v) for v in tree)
        return one(tree)

    return build(specs)


def is_spec_leaf(x) -> bool:
    return isinstance(x, ParamSpec)


def spec_map(fn: Callable[[ParamSpec], Any], tree: PyTree) -> PyTree:
    """``fn`` over the :class:`ParamSpec` leaves of a spec tree."""
    return tree_map(fn, tree)


def abstract_params(specs: PyTree) -> PyTree:
    """ParamSpec tree -> a tree of tensors on the ``meta`` device (shape and
    dtype, no storage): the counterpart of the JAX package's
    ``ShapeDtypeStruct`` tree."""
    return spec_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def stack_specs(tree: PyTree, n: int) -> PyTree:
    """Add a leading stacked-layer dimension (logical axis ``layers``) to
    every spec."""
    return spec_map(lambda s: ParamSpec((n,) + s.shape, s.dtype, s.init,
                                        s.init_scale,
                                        ("layers",) + s.logical_axes), tree)


def take_layer(params: PyTree, i: int) -> PyTree:
    """Slice layer ``i`` out of a stacked parameter tree (views)."""
    return tree_map(lambda a: a[i], params)


def unstack_layers(params: PyTree, n: int) -> list:
    """The ``n`` layers of a stacked parameter tree, one tree of views each,
    from one ``unbind`` per leaf: under autograd each leaf's gradient is
    then stacked once, not summed from ``n`` full-size zero-filled slices
    as ``n`` calls of :func:`take_layer` would give it."""
    if isinstance(params, dict):
        parts = {k: unstack_layers(v, n) for k, v in params.items()}
        return [{k: parts[k][i] for k in params} for i in range(n)]
    if isinstance(params, tuple):
        parts = [unstack_layers(v, n) for v in params]
        return [tuple(p[i] for p in parts) for i in range(n)]
    return list(params.unbind(0))


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
                self.register_parameter(str(k), nn.Parameter(v))
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
    """In float32, cast back to x's dtype (``repro.models.common.rmsnorm``):
    the ``rmsnorm`` kernel or its plain version, as
    ``kernels.rmsnorm.ops.rmsnorm_route`` picks."""
    return rmsnorm_ops.rmsnorm(x, params["scale"], eps)


def layernorm_specs(d: int, dtype: torch.dtype) -> PyTree:
    return {"scale": ParamSpec((d,), dtype, init="ones"),
            "bias": ParamSpec((d,), dtype, init="zeros")}


def layernorm(params: PyTree, x: torch.Tensor, eps: float) -> torch.Tensor:
    """In float32 with the population variance (``jnp.var``), cast back to
    x's dtype (``repro.models.common.layernorm``)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(x / cap)``; ``x`` itself when ``cap`` is 0."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)
