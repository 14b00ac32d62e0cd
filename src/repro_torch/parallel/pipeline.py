"""GPipe-style pipeline parallelism over one mesh dim (``pod`` by
default), as ``repro.parallel.pipeline`` schedules it.

The layer blocks are split across the dim's ranks, the stages, and
microbatches stream through them: stage i computes microbatch m while
stage i+1 computes m-1, with the activations sent from each stage to the
next (``send``/``recv``).  The ranks of the other mesh dims each run the
same pipeline on their own copy.  Forward only.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.common import PyTree, tree_map
from repro_torch.parallel import collectives


def split_blocks(params_blocks: PyTree, n_stages: int,
                 stage: int) -> PyTree:
    """Slice the stacked (R, ...) block params into stage ``stage``'s
    (R/n_stages, ...) (views)."""
    def one(a):
        per = a.shape[0] // n_stages
        return a[stage * per:(stage + 1) * per]
    return tree_map(one, params_blocks)


def _peer(mesh, axis: str, stage: int) -> int:
    """The global rank at ``stage`` on ``axis`` with this rank's other
    coordinates."""
    coord = list(mesh.get_coordinate())
    coord[mesh.mesh_dim_names.index(axis)] = stage
    return int(mesh.mesh[tuple(coord)])


def pipeline_fwd(block_apply: Callable[[PyTree, torch.Tensor], torch.Tensor],
                 params_blocks: PyTree, h: torch.Tensor, mesh,
                 n_microbatches: int, axis: str = "pod") -> torch.Tensor:
    """h (B, S, D) -> (B, S, D) through all stages, on every rank.

    ``block_apply(stage_params, h_micro)`` runs this stage's blocks on one
    microbatch.  Stages = the size of ``mesh``'s dim ``axis``;
    B % n_microbatches == 0.  The schedule has n_microbatches + n_stages - 1
    ticks: at tick t stage 0 takes microbatch t, every other stage the
    activations its predecessor sent at tick t-1, and each stage sends its
    output on; the last stage keeps microbatch t - (n_stages - 1).  A stage
    skips the ticks where it holds no microbatch (the JAX package's
    lockstep scan computes them and discards the result).  The last stage
    then broadcasts the activations to every stage."""
    names = mesh.mesh_dim_names
    n_stages = mesh.size(names.index(axis))
    stage = mesh.get_coordinate()[names.index(axis)]
    group = mesh.get_group(axis)
    b = h.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not split into {n_microbatches} "
                         "microbatches")
    my_params = split_blocks(params_blocks, n_stages, stage)
    micro = h.reshape(n_microbatches, b // n_microbatches, *h.shape[1:])
    out = torch.zeros_like(micro)
    buf = torch.empty_like(micro[0])
    for t in range(n_microbatches + n_stages - 1):
        m_idx = t - stage                  # the microbatch here at tick t
        if not 0 <= m_idx < n_microbatches:
            continue
        if stage == 0:
            incoming = micro[m_idx]
        else:
            incoming = collectives.recv(buf, _peer(mesh, axis, stage - 1),
                                        group)
        y = block_apply(my_params, incoming)
        if stage < n_stages - 1:
            collectives.send(y, _peer(mesh, axis, stage + 1), group)
        else:
            out[m_idx] = y
    collectives.broadcast(out, _peer(mesh, axis, n_stages - 1), group)
    return out.reshape(h.shape)
