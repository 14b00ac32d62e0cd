"""Triplet-loss training of the embedder (TASTI-T, paper §3.2).

Only the configuration is ported so far: :class:`TripletConfig` is part of
:class:`~repro_torch.core.pipeline.TastiConfig`.  Mining and training wait
for the training slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class TripletConfig:
    margin: float = 1.0
    batch: int = 256
    steps: int = 400
    lr: float = 1e-3
    max_triplets: int = 200_000
    seed: int = 0
