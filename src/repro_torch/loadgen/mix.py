"""Request-class mixes: what an open-loop arrival actually carries.

A :class:`SpecClass` is one kind of traffic — a spec-list template plus the
scheduling envelope it travels in (priority class, relative deadline, oracle
budget).  A :class:`SpecMix` samples classes by weight, so one arrival
process can carry, say, 90% interactive aggregations and 10% heavy scans.

Budgets and spec lists may be given as values or as callables of the mix's
``numpy`` generator, so per-request variation (jittered budgets, randomized
predicates) stays reproducible from the mix seed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

Specs = List[dict]
SpecsLike = Union[Specs, Callable[[np.random.Generator], Specs]]
BudgetLike = Union[None, int, Tuple[int, int],
                   Callable[[np.random.Generator], Optional[int]]]


@dataclass(frozen=True)
class SpecClass:
    """One traffic class: a spec template and its scheduling envelope."""

    name: str
    specs: SpecsLike                     # template list, or rng -> list
    weight: float = 1.0
    priority: Optional[int] = None       # scheduling class (0 most urgent)
    deadline_ms: Optional[float] = None  # relative EDF deadline
    budget: BudgetLike = None            # int | (lo, hi) uniform | callable

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight for {self.name!r} must be > 0, "
                             f"got {self.weight}")

    def sample_specs(self, rng: np.random.Generator) -> Specs:
        if callable(self.specs):
            return self.specs(rng)
        # copy the template: downstream stamping must not mutate the class
        return [dict(s) for s in self.specs]

    def sample_budget(self, rng: np.random.Generator) -> Optional[int]:
        b = self.budget
        if b is None or isinstance(b, int):
            return b
        if callable(b):
            return b(rng)
        lo, hi = b
        return int(rng.integers(int(lo), int(hi) + 1))


@dataclass
class SpecMix:
    """Weighted sampling over :class:`SpecClass` es.

        mix = SpecMix([interactive, heavy], seed=0)
        cls, specs, budget = mix.sample()
    """

    classes: Sequence[SpecClass]
    seed: int = 0
    _rng: np.random.Generator = field(init=False, repr=False)
    _probs: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        if not self.classes:
            raise ValueError("mix needs at least one SpecClass")
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate class names: {names}")
        self._rng = np.random.default_rng(self.seed)
        weights = np.asarray([c.weight for c in self.classes], np.float64)
        self._probs = weights / weights.sum()

    def sample(self) -> Tuple[SpecClass, Specs, Optional[int]]:
        """Draw one request: its class, a fresh spec list, and a budget."""
        i = int(self._rng.choice(len(self.classes), p=self._probs))
        cls = self.classes[i]
        return cls, cls.sample_specs(self._rng), cls.sample_budget(self._rng)
