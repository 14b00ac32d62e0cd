"""SUPG recall-target selection with importance sampling (Kang et al. 2020),
the algorithm TASTI's proxy scores feed for guaranteed selection (paper §4.3).

Given proxy scores p in [0,1], an oracle budget n, recall target gamma and
confidence delta: sample n records with probability proportional to sqrt(p)
(importance sampling), label them, and pick the *lowest* threshold tau whose
importance-weighted recall lower bound still meets gamma; return
{p >= tau} u {labeled positives}.  Metric: false positives in the returned
set at the fixed budget (paper fig. 5; lower is better).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np


@dataclass
class SUPGResult:
    selected: np.ndarray        # record ids
    threshold: float
    n_invocations: int
    sampled_ids: np.ndarray
    sampled_labels: np.ndarray


def importance_sample(proxy: np.ndarray, budget: int, seed: int = 0):
    """SUPG's sqrt-proxy importance sample: (sampled ids, p, q).

    Deterministic in (proxy, budget, seed) — sessions call this ahead of
    execution to prefetch exactly the ids the query will label."""
    n = len(proxy)
    rng = np.random.default_rng(seed)
    p = np.clip(proxy.astype(np.float64), 1e-6, 1.0)
    q = np.sqrt(p)
    q = q / q.sum()
    ids = rng.choice(n, size=min(budget, n), replace=True, p=q)
    return ids, p, q


def supg_recall_target(proxy: np.ndarray,
                       oracle: Callable[[np.ndarray], np.ndarray],
                       budget: int, recall_target: float = 0.9,
                       delta: float = 0.05, seed: int = 0) -> SUPGResult:
    n = len(proxy)
    budget = min(budget, n)
    ids, p, q = importance_sample(proxy, budget, seed)
    labels = oracle(ids).astype(np.float64)  # 1.0 if matches predicate
    w = 1.0 / (n * q[ids])                    # importance weights (mean-1 scale)

    # importance-weighted positive mass above each candidate threshold
    cand = np.unique(p[ids])[::-1]
    wpos = w * labels
    total_pos = wpos.sum()
    if total_pos <= 0:
        # no positives sampled: return everything above the tiniest proxy —
        # conservative (can't certify recall otherwise)
        tau = float(np.min(p))
    else:
        z = np.sqrt(2.0 * np.log(1.0 / delta))
        tau = float(np.min(p))
        # walk thresholds from high to low until recall LB >= target
        for t in cand:
            above = p[ids] >= t
            mass_above = float(wpos[above].sum())
            # delta-method std of the recall ratio estimate
            m_var = wpos[above].var() * above.sum() if above.any() else 0.0
            t_var = wpos.var() * len(wpos)
            se = np.sqrt((m_var + t_var)) / max(total_pos * np.sqrt(budget), 1e-9)
            recall_lb = mass_above / total_pos - z * se
            if recall_lb >= recall_target:
                tau = float(t)
                break
    selected = np.where(p >= tau)[0]
    pos_sampled = np.unique(ids[labels > 0.5])
    selected = np.union1d(selected, pos_sampled)
    return SUPGResult(selected=selected, threshold=tau, n_invocations=budget,
                      sampled_ids=ids, sampled_labels=labels)


def false_positive_rate(selected: np.ndarray, truth: np.ndarray) -> float:
    """truth: boolean (N,).  FPR = FP / selected (the paper reports FP rate of
    the returned set at fixed budget)."""
    if len(selected) == 0:
        return 0.0
    fp = float((~truth[selected]).sum())
    return fp / len(selected)


def achieved_recall(selected: np.ndarray, truth: np.ndarray) -> float:
    total = float(truth.sum())
    if total == 0:
        return 1.0
    return float(truth[selected].sum()) / total


# ---------------------------------------------------------------------------
# Engine plug-in (repro_torch.core.engine): declarative access to this algorithm.
# ---------------------------------------------------------------------------
from repro_torch.core.queries.registry import (QueryExecutor,  # noqa: E402
                                         register_executor)


@register_executor
class SelectionExecutor(QueryExecutor):
    """SUPG recall-target selection; probability-shaped proxy in [0,1]."""

    kind = "selection"
    default_propagation = "numeric"
    clip01 = True

    def validate(self, spec) -> None:
        if not spec.budget or spec.budget <= 0:
            raise ValueError("selection needs a positive oracle `budget`")
        if not (0.0 < spec.recall_target <= 1.0):
            raise ValueError("recall_target must be in (0, 1]")

    def preview(self, plan, proxy) -> np.ndarray:
        s = plan.spec
        ids, _, _ = importance_sample(proxy, s.budget, s.seed)
        return np.unique(ids)

    def execute(self, plan, proxy, oracle) -> SUPGResult:
        s = plan.spec
        return supg_recall_target(proxy, oracle, budget=s.budget,
                                  recall_target=s.recall_target,
                                  delta=s.delta, seed=s.seed)

    def summarize(self, raw: SUPGResult) -> dict:
        return {"selected": raw.selected, "threshold": raw.threshold,
                "n_invocations": raw.n_invocations}
