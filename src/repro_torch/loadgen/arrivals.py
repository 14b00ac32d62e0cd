"""Arrival-time schedules: Poisson and gamma-renewal processes.

An open-loop experiment is only as honest as its arrival process.  This
module generates the *schedule* (absolute offsets from the run start) ahead
of time, so the generator's firing loop has nothing to compute on the hot
path and the schedule itself is reproducible from the seed.

Burstiness is parameterized by the coefficient of variation ``cv`` of the
inter-arrival times: a gamma renewal process with shape ``1/cv**2`` and
scale ``cv**2 / rate`` has mean inter-arrival ``1/rate`` and the requested
cv.  ``cv=1`` is exactly the exponential — a Poisson process; ``cv<1``
approaches a metronome; ``cv>1`` produces the bursty, clumped arrivals that
stress a scheduler's fairness.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass(frozen=True)
class ArrivalProcess:
    """A reproducible renewal process: ``rate`` requests/second with
    inter-arrival coefficient of variation ``cv``.

        offsets = ArrivalProcess(rate=25.0).times(duration=3.0)

    ``times`` returns sorted offsets in ``[0, duration)`` seconds.
    """

    rate: float            # mean requests per second
    cv: float = 1.0        # 1 = Poisson; >1 bursty; <1 regular
    seed: int = 0

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if self.cv <= 0:
            raise ValueError(f"cv must be > 0, got {self.cv}")

    def times(self, duration: float) -> List[float]:
        """Arrival offsets (seconds from start) over ``duration`` seconds."""
        if duration <= 0:
            return []
        rng = np.random.default_rng(self.seed)
        shape = 1.0 / (self.cv ** 2)
        scale = (self.cv ** 2) / self.rate
        out: List[float] = []
        t = 0.0
        # draw in blocks: ~rate*duration arrivals expected, 4-sigma headroom
        block = max(16, int(self.rate * duration * 1.5) + 16)
        while True:
            gaps = rng.gamma(shape, scale, size=block)
            for g in gaps:
                t += float(g)
                if t >= duration:
                    return out
                out.append(t)
