"""AdamW with configurable state dtypes + cosine schedule + global-norm clip,
as ``repro.optim.adamw`` computes it.

Not ``torch.optim.AdamW`` with its defaults: b2 is 0.95, the learning rate
warms up linearly and then decays along a cosine to ``min_lr`` (in
float32), gradients are clipped by their global norm (``+1e-9``), the bias
corrections are float32, weight decay is decoupled and scaled by the
learning rate, and the moments are held in ``state_dtype`` while the update
is computed in float32 and cast back to each parameter's dtype.

The functions take a tree of tensors (dicts, tuples, lists): a module's
``list(parameters())`` or the LM's parameter tree alike.  The update is in
place and goes through each leaf in chunks of :data:`CHUNK` elements, so
that its float32 temporaries stay a few hundred MB whatever the leaf: one
MLP leaf of h2o-danube-3-4b, (24, 3840, 10240), is 944M elements.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.device import is_traced
from repro_torch.models.common import (DTYPES, PyTree, spec_map, tree_leaves,
                                       tree_unflatten_like)
from repro_torch.parallel import collectives

#: elements of a leaf updated at once (float32 temporaries of 64 MB each)
CHUNK = 1 << 24


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"


def schedule(opt: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a float32 scalar on the CPU)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = opt.peak_lr * step / max(opt.warmup_steps, 1)
    t = torch.clamp((step - opt.warmup_steps)
                    / max(opt.total_steps - opt.warmup_steps, 1), 0.0, 1.0)
    cos = opt.min_lr + 0.5 * (opt.peak_lr - opt.min_lr) * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < opt.warmup_steps, warm, cos)


def opt_state_specs(param_specs: PyTree, opt: OptimizerConfig) -> Dict:
    """ParamSpec tree -> ParamSpec trees for the (mu, nu) moments: zeros
    in ``state_dtype``, each leaf's logical axes kept."""
    dt = DTYPES[opt.state_dtype]
    moment = spec_map(lambda s: dataclasses.replace(s, dtype=dt,
                                                    init="zeros"),
                      param_specs)
    return {"mu": moment, "nu": moment, "step": None}


def init_opt_state(params: PyTree, opt: OptimizerConfig,
                   shapes=None) -> Dict:
    """Zero moments of ``params``' layout in ``state_dtype`` on each leaf's
    device, and the step count (an int32 scalar on the CPU).  ``shapes``
    (in ``tree_leaves`` order) sets the moments' shapes where they are
    not the leaves' (their own slices on a mesh)."""
    dt = DTYPES[opt.state_dtype]
    leaves = tree_leaves(params)
    shapes = shapes or [p.shape for p in leaves]

    def zeros():
        return tree_unflatten_like(params, [
            torch.zeros(s, dtype=dt, device=p.device)
            for p, s in zip(leaves, shapes)])

    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32)}


def _chunks(t: torch.Tensor):
    flat = t.detach().view(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


@torch.no_grad()
def global_norm(tree: PyTree, mesh=None, split=None) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32 (a scalar on
    the leaves' device).  On ``mesh`` the leaves are this rank's slices and
    ``split`` names, for each leaf in ``tree_leaves`` order, the mesh dims
    it is split over: each leaf's squares are summed over those dims, so
    a slice counts once however many ranks hold it."""
    sums = {}
    for i, x in enumerate(tree_leaves(tree)):
        key = () if mesh is None else tuple(split[i])
        for c in _chunks(x):
            s = torch.sum(torch.square(c.float()))
            sums[key] = s if key not in sums else sums[key] + s
    total = None
    for key in sorted(sums):
        s = sums[key]
        if key:
            s = collectives.all_reduce(s, mesh, key)
        total = s if total is None else total + s
    return torch.sqrt(total)


def _host_float(t: torch.Tensor) -> float:
    """``float(t)``; 1.0 for a tensor with no data (the dry run's fake
    step count), whose trace needs the step's shapes only."""
    return 1.0 if is_traced(t) else float(t)


@torch.no_grad()
def adamw_update(params: PyTree, grads: PyTree, state: Dict,
                 opt: OptimizerConfig, mesh=None, split=None,
                 zero=None) -> Tuple[PyTree, Dict, Dict]:
    """One AdamW step: ``params`` and ``state`` are updated in place and
    returned with ``{"lr", "grad_norm"}``.  ``grads`` has ``params``'
    layout, or is the list of their leaves in :func:`tree_leaves` order.
    On ``mesh`` every leaf (parameter, gradient and moments alike) is this
    rank's slice, split over the mesh dims ``split`` names for it (see
    :func:`global_norm`): the update is elementwise but for the clipping
    norm, which spans the mesh.  ``zero`` (in leaf order; None for most)
    holds a ``parallel.tensor_parallel.MomentSlice`` for each leaf whose
    moments are sliced otherwise: its step runs on the moments' slice."""
    state["step"] += 1
    step = state["step"].to(torch.float32)
    lr = schedule(opt, step)
    gnorm = global_norm(grads, mesh, split)
    scale = (torch.clamp(opt.clip_norm / (gnorm + 1e-9), max=1.0)
             if opt.clip_norm else torch.ones((), device=gnorm.device))
    f32 = torch.float32
    bc1, bc2, lr_f = (_host_float(x) for x in (
        1 - torch.tensor(opt.b1, dtype=f32) ** step,
        1 - torch.tensor(opt.b2, dtype=f32) ** step, lr))
    flat = [tree_leaves(t) for t in (params, grads, state["mu"], state["nu"])]
    if len({len(f) for f in flat}) != 1:
        raise ValueError(f"params, grads and moments hold {[len(f) for f in flat]} "
                         "leaves")
    for i, (p, g, mu, nu) in enumerate(zip(*flat)):
        if g.shape != p.shape:
            raise ValueError(f"gradient {tuple(g.shape)} for a parameter "
                             f"{tuple(p.shape)}")
        cut = None if zero is None else zero[i]
        if cut is not None:
            whole, (p, g) = p, cut.take(p, g)
        if mu.shape != p.shape:
            raise ValueError(f"moments {tuple(mu.shape)} for a parameter "
                             f"{tuple(p.shape)}")
        for pc, gc, mc, nc in zip(_chunks(p), _chunks(g.contiguous()),
                                  _chunks(mu), _chunks(nu)):
            gs = gc.float() * scale                 # a new float32 tensor
            m = mc if mc.dtype == f32 else mc.float()
            v = nc if nc.dtype == f32 else nc.float()
            m.mul_(opt.b1).add_(gs, alpha=1 - opt.b1)
            v.mul_(opt.b2).addcmul_(gs, gs, value=1 - opt.b2)
            denom = torch.div(v, bc2).sqrt_().add_(opt.eps)
            delta = torch.div(m, bc1, out=gs).div_(denom)
            pf = pc if pc.dtype == f32 else pc.float()
            if opt.weight_decay:
                delta.add_(pf, alpha=opt.weight_decay)
            pf.add_(delta, alpha=-lr_f)
            for dst, src in ((pc, pf), (mc, m), (nc, v)):
                if src is not dst:
                    dst.copy_(src)
        if cut is not None:
            cut.put(whole, p)
    return params, state, {"lr": lr, "grad_norm": gnorm}


def minimize(params: list, loss_fn, batches, opt: OptimizerConfig) -> list:
    """AdamW over the tensors ``params``: one step per batch (a tuple of
    ``loss_fn``'s arguments), gradients by autograd.  Returns the losses
    as host floats, read once at the end."""
    state = init_opt_state(params, opt)
    losses = []
    for batch in batches:
        with torch.enable_grad():
            loss = loss_fn(*batch)
            grads = torch.autograd.grad(loss, params)
        adamw_update(params, list(grads), state, opt)
        losses.append(loss.detach())
    return torch.stack(losses).tolist() if losses else []
