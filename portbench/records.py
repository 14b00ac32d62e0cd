"""Seeded night-street-shaped records, made on the device in a few large
calls.

The structure is that of the port's synthetic video (``VideoWorkload``):
an object count on a sticky Markov chain (most frames empty, rare heavy
ones), positions that drift and bounce off the frame's edges, a slowly
varying nuisance latent that dominates the features' variance, and a fixed
random nonlinear rendering of each frame's objects plus noise.  Nothing
here loops over frames: the chain is a running maximum over the frames
where the count was drawn again, the velocities and the nuisance are
first-order recurrences solved by matrix products over blocks of frames,
and the positions are their sum folded back into [0, 1].

``target_dnn_batch`` (the oracle TASTI's index calls for its
representatives) builds the scenes of the ids asked for, and no others.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

#: frames a block of the recurrences' matrix products spans
_BLOCK = 1024


@dataclass
class Scene:
    """A frame's induced schema: object positions in [0, 1]^2."""
    boxes: np.ndarray

    @property
    def count(self) -> int:
        return len(self.boxes)


def ar1(noise: torch.Tensor, decay: float, start: torch.Tensor) -> torch.Tensor:
    """y_t = decay * y_{t-1} + noise_t with y_{-1} = ``start``, for noise
    (T, C) float64, by matrix products: within blocks of ``_BLOCK`` frames,
    then the carry from block to block."""
    t, c = noise.shape
    pad = (-t) % _BLOCK
    e = torch.cat([noise, noise.new_zeros(pad, c)]) if pad else noise
    nb = e.shape[0] // _BLOCK
    dev = noise.device
    i = torch.arange(_BLOCK, device=dev, dtype=torch.float64)
    lag = i[:, None] - i[None, :]
    within = torch.where(lag >= 0, decay ** lag.clamp_min(0),
                         torch.zeros((), dtype=torch.float64, device=dev))
    local = torch.matmul(within, e.reshape(nb, _BLOCK, c))     # (nb, L, C)
    b = torch.arange(nb, device=dev, dtype=torch.float64)
    blag = b[:, None] - b[None, :]
    across = torch.where(blag >= 0, (decay ** _BLOCK) ** blag.clamp_min(0),
                         torch.zeros((), dtype=torch.float64, device=dev))
    start = start.to(torch.float64)
    # y at the last frame of each block
    ends = (torch.matmul(across, local[:, -1, :])
            + ((decay ** _BLOCK) ** (b + 1))[:, None] * start[None])
    # the carry into block j is y at its previous frame: block j-1's end,
    # and for j = 0 the start value
    carry = torch.cat([start[None], ends[:-1]])
    y = local + (decay ** (i + 1))[None, :, None] * carry[:, None, :]
    return y.reshape(-1, c)[:t]


def _fold(x: torch.Tensor) -> torch.Tensor:
    """x folded into [0, 1] as a point bouncing between the edges."""
    m = torch.remainder(x, 2.0)
    return torch.where(m > 1.0, 2.0 - m, m)


class Records:
    """One seed's frames: ``features`` (N, F) float32 on the host, which
    the port's ``build_tasti`` reads, and the latents behind them on the
    device (``counts`` (N,), ``positions`` (N, M, 2))."""

    def __init__(self, spec: dict, seed: int, device):
        n = int(spec["n_frames"])
        f = int(spec["feature_dim"])
        m = int(spec["max_objects"])
        self.spec = spec
        g = torch.Generator(device=device).manual_seed(int(seed))
        f64 = dict(dtype=torch.float64, device=device)

        def normal(*shape, std=1.0):
            return torch.randn(shape, generator=g, **f64) * std

        def uniform(*shape):
            return torch.rand(shape, generator=g, **f64)

        # sticky chain over counts: redraw with probability 1 - p_stay,
        # a redraw geometric(p) - 1 objects capped at max_objects
        redraw = uniform(n) > float(spec["p_stay"])
        geo = torch.floor(torch.log(uniform(n).clamp_min(1e-300))
                          / np.log(1.0 - float(spec["geometric_p"])))
        drawn = geo.clamp_max(m).to(torch.int64)
        last = torch.where(redraw, torch.arange(n, device=device),
                           torch.full((), -1, device=device))
        last = torch.cummax(last, 0).values
        counts = torch.where(last >= 0, drawn[last.clamp_min(0)],
                             torch.zeros((), dtype=torch.int64,
                                         device=device))
        # positions: velocity an AR(1) per coordinate, position its sum
        vel = ar1(normal(n, 2 * m, std=float(spec["velocity_noise"])),
                  float(spec["velocity_decay"]),
                  normal(2 * m, std=float(spec["velocity_init"])))
        pos = _fold(uniform(2 * m)[None] + torch.cumsum(vel, 0))
        positions = pos.reshape(n, m, 2)
        # the rendering: each present object adds tanh([pos, 1] @ w_pos)
        width = int(spec["appearance_width"])
        w_pos = normal(3, width, std=float(spec["w_pos_std"]))
        w_mix = normal(width, f) / np.sqrt(width)
        background = normal(f, std=float(spec["background_std"]))
        appear = torch.zeros(n, width, **f64)
        for j in range(m):
            a = torch.tanh(positions[:, j] @ w_pos[:2] + w_pos[2])
            appear += a * (counts > j)[:, None]
        mixed = appear @ w_mix
        del appear
        # the nuisance latent: slow, schema-blind, dominant
        k = int(spec["nuisance_dim"])
        nuis = ar1(normal(n, k, std=float(spec["nuisance_noise"])),
                   float(spec["nuisance_decay"]), normal(k))
        w_gain = normal(k, f, std=float(spec["w_gain_std"]))
        w_add = normal(k, f, std=float(spec["w_add_std"]))
        gain = 1.0 + torch.tanh(nuis @ w_gain)
        feats = torch.tanh((mixed + background[None]) * gain + nuis @ w_add)
        feats += normal(n, f, std=float(spec["noise"]))
        self.features = feats.to(torch.float32).cpu().numpy()
        self.counts = counts
        self.positions = positions.to(torch.float32)

    def target_dnn_batch(self, ids) -> List[Scene]:
        """The oracle's scenes of ``ids``: each frame's present objects."""
        idx = torch.as_tensor(np.asarray(ids, np.int64),
                              device=self.counts.device)
        counts = self.counts[idx].cpu().numpy()
        pos = self.positions[idx].cpu().numpy()
        return [Scene(boxes=p[:c].copy()) for p, c in zip(pos, counts)]
