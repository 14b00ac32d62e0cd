"""Query-executor registry: the pluggable half of the declarative engine.

Each query kind (``aggregation``, ``selection``, ``limit``, ...) registers a
:class:`QueryExecutor` describing how to plan and run specs of that kind.  The
query modules in this package register themselves at import time, so new query
types plug in without touching :mod:`repro_torch.core.engine`:

    @register_executor
    class MyExecutor(QueryExecutor):
        kind = "my-kind"
        default_propagation = "numeric"
        def execute(self, plan, proxy, oracle):
            ...
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, Type

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from repro_torch.core.engine import QueryPlan, QueryResult


class QueryExecutor:
    """One query kind's planning defaults + execution strategy.

    Subclasses set the class attributes and implement :meth:`execute`;
    :meth:`validate` may raise ``ValueError`` for malformed specs at *plan*
    time (before any oracle cost is spent).
    """

    #: registry key; ``QuerySpec.kind`` strings resolve against this
    kind: str = ""
    #: propagation mode used when the spec does not pin one
    #: ("numeric" | "top1" | "categorical")
    default_propagation: str = "numeric"
    #: clip propagated scores into [0, 1] (probability-shaped proxies)
    clip01: bool = False

    def validate(self, spec) -> None:
        """Raise ``ValueError`` if ``spec`` is not executable for this kind."""

    def preview(self, plan: "QueryPlan", proxy: np.ndarray) -> np.ndarray:
        """Record ids this plan will deterministically request first.

        Sessions prefetch these through the oracle broker before executing
        any spec, so one combined ``target_dnn_batch`` flush serves many
        specs.  Must be a *certain* prefix of the execution's requests (no
        speculation — prefetched labels are charged to the spec).  Default:
        nothing to prefetch."""
        return np.empty(0, np.int64)

    def execute(self, plan: "QueryPlan", proxy: np.ndarray,
                oracle: Callable[[np.ndarray], np.ndarray]):
        """Run the plan.  Returns the kind-specific raw result object;
        the engine wraps it into a uniform ``QueryResult``."""
        raise NotImplementedError

    def summarize(self, raw) -> Dict:
        """Map the raw result onto the uniform ``QueryResult`` fields.
        Must include ``n_invocations``; may include ``estimate``,
        ``selected``, ``threshold``, ``ci_half_width``."""
        raise NotImplementedError


_EXECUTORS: Dict[str, QueryExecutor] = {}


def register_executor(cls: Type[QueryExecutor]) -> Type[QueryExecutor]:
    """Class decorator: instantiate and register an executor under its kind."""
    if not cls.kind:
        raise ValueError(f"{cls.__name__} must set a non-empty `kind`")
    _EXECUTORS[cls.kind] = cls()
    return cls


def get_executor(kind: str) -> QueryExecutor:
    try:
        return _EXECUTORS[kind]
    except KeyError:
        raise KeyError(
            f"unknown query kind {kind!r}; registered: {sorted(_EXECUTORS)}"
        ) from None


def registered_kinds() -> list:
    return sorted(_EXECUTORS)
