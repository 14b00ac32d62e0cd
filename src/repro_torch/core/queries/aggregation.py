"""Approximate aggregation with control variates + empirical-Bernstein (EB)
adaptive stopping — the BlazeIt query processing TASTI plugs into (paper §4.3).

The estimator for E[f] uses the proxy scores p as a control variate:
    E[f] = mean_all(p) + E[f - c*p] + (c-1)*...   (c = cov/var, online)
EB stopping is adaptive in the *residual* variance, so better proxy scores
(higher rho^2) => fewer target-DNN invocations — exactly the paper's fig. 4
mechanism.  Metric: number of target-DNN invocations at a given error bound.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


@dataclass
class AggResult:
    estimate: float
    n_invocations: int
    ci_half_width: float
    sampled_ids: np.ndarray
    sampled_f: np.ndarray


def eb_half_width(var: float, rng_width: float, n: int, delta: float) -> float:
    """Empirical-Bernstein confidence half-width (Maurer & Pontil / BlazeIt)."""
    log_term = np.log(3.0 / delta)
    return float(np.sqrt(2.0 * var * log_term / n)
                 + 3.0 * rng_width * log_term / n)


def sample_order(n: int, seed: int,
                 shared: Optional[np.ndarray] = None) -> np.ndarray:
    """The id order an aggregation walks: the session-shared sample order
    when given (so specs over the same score draw nested samples), else a
    seeded uniform permutation."""
    if shared is not None:
        order = np.asarray(shared, np.int64)
        if len(order) != n:
            raise ValueError(f"shared sample order covers {len(order)} "
                             f"records, proxy has {n}")
        return order
    return np.random.default_rng(seed).permutation(n)


def first_sample_size(n: int, min_samples: int,
                      max_samples: Optional[int]) -> int:
    """Size of the first (deterministic) oracle batch of the EB loop."""
    return min(min_samples, max_samples or n, n)


def aggregate_control_variates(proxy: np.ndarray,
                               oracle: Callable[[np.ndarray], np.ndarray],
                               err: float, delta: float = 0.05,
                               batch: int = 32, min_samples: int = 64,
                               max_samples: Optional[int] = None,
                               seed: int = 0,
                               use_cv: bool = True,
                               order: Optional[np.ndarray] = None) -> AggResult:
    """Sample until the EB CI half-width <= err (absolute).

    ``oracle(ids) -> f values`` counts as target-DNN invocations.
    ``use_cv=False`` gives the plain random-sampling baseline.
    ``order`` overrides the sampling order (sessions pass a shared
    stratified order so sibling specs' samples nest).
    """
    n = len(proxy)
    order = sample_order(n, seed, shared=order)
    max_samples = max_samples or n
    p_mean = float(proxy.mean())

    taken = 0
    fs: list = []
    ps: list = []
    while taken < max_samples:
        m = min(batch if taken else min_samples, max_samples - taken)
        ids = order[taken:taken + m]
        fs.extend(oracle(ids).tolist())
        ps.extend(proxy[ids].tolist())
        taken += m
        f_arr = np.asarray(fs)
        p_arr = np.asarray(ps)
        if use_cv and len(f_arr) >= 8:
            var_p = p_arr.var() + 1e-12
            c = float(np.cov(f_arr, p_arr)[0, 1] / var_p)
            resid = f_arr - c * p_arr
            est = float(resid.mean() + c * p_mean)
            v = float(resid.var())
            width = float(resid.max() - resid.min()) + 1e-12
        else:
            est = float(f_arr.mean())
            v = float(f_arr.var())
            width = float(f_arr.max() - f_arr.min()) + 1e-12
        hw = eb_half_width(v, width, taken, delta)
        if taken >= min_samples and hw <= err:
            break
    return AggResult(estimate=est, n_invocations=taken, ci_half_width=hw,
                     sampled_ids=order[:taken], sampled_f=np.asarray(fs))


def aggregate_direct(proxy: np.ndarray) -> float:
    """No-guarantee aggregation: the statistic straight off the proxy scores
    (paper §6.5, Table 1)."""
    return float(proxy.mean())


# ---------------------------------------------------------------------------
# Engine plug-in (repro_torch.core.engine): declarative access to this algorithm.
# ---------------------------------------------------------------------------
from repro_torch.core.queries.registry import (QueryExecutor,  # noqa: E402
                                         register_executor)


@register_executor
class AggregationExecutor(QueryExecutor):
    """EB-stopped control-variate aggregation; numeric propagation (§4.2)."""

    kind = "aggregation"
    default_propagation = "numeric"
    clip01 = False

    def validate(self, spec) -> None:
        if spec.err <= 0:
            raise ValueError("aggregation needs a positive error bound `err`")

    def preview(self, plan, proxy) -> np.ndarray:
        s = plan.spec
        order = sample_order(len(proxy), s.seed, shared=plan.shared_order)
        return order[:first_sample_size(len(proxy), s.min_samples,
                                        s.max_samples)]

    def execute(self, plan, proxy, oracle) -> AggResult:
        s = plan.spec
        return aggregate_control_variates(
            proxy, oracle, err=s.err, delta=s.delta, batch=s.batch or 32,
            min_samples=s.min_samples, max_samples=s.max_samples,
            seed=s.seed, use_cv=s.use_cv, order=plan.shared_order)

    def summarize(self, raw: AggResult) -> dict:
        return {"estimate": raw.estimate, "ci_half_width": raw.ci_half_width,
                "n_invocations": raw.n_invocations}
