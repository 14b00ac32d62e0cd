"""Limit queries (paper §4.3): find K records matching a rare predicate by
walking records in descending proxy-score order, invoking the target DNN on
each until K matches are found.  Metric: target-DNN invocations (fig. 6).
TASTI recommends k=1 propagation with distance tie-breaks for these (§6.3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np


@dataclass
class LimitResult:
    found_ids: np.ndarray
    n_invocations: int
    examined_ids: np.ndarray


def scan_order(proxy: np.ndarray) -> np.ndarray:
    """Deterministic descending-proxy visit order of the limit scan."""
    return np.argsort(-proxy, kind="stable")


def limit_query(proxy: np.ndarray,
                oracle: Callable[[np.ndarray], np.ndarray],
                k_results: int, batch: int = 16,
                max_invocations: int = 0) -> LimitResult:
    n = len(proxy)
    order = scan_order(proxy)
    max_inv = max_invocations or n
    found: list = []
    examined = 0
    for start in range(0, n, batch):
        # batching is vectorization sugar; the scan is conceptually one record
        # at a time, so stop counting at the record that yields the Kth match
        ids = order[start:start + min(batch, max_inv - examined)]
        labels = oracle(ids)
        done_at = len(ids)
        for j, (i, lab) in enumerate(zip(ids, labels)):
            if lab > 0.5:
                found.append(int(i))
                if len(found) >= k_results:
                    done_at = j + 1
                    break
        examined += done_at
        if len(found) >= k_results or examined >= max_inv:
            break
    return LimitResult(found_ids=np.asarray(found[:k_results], np.int64),
                       n_invocations=examined,
                       examined_ids=order[:examined])


# ---------------------------------------------------------------------------
# Engine plug-in (repro_torch.core.engine): declarative access to this algorithm.
# ---------------------------------------------------------------------------
from repro_torch.core.queries.registry import (QueryExecutor,  # noqa: E402
                                         register_executor)


@register_executor
class LimitExecutor(QueryExecutor):
    """Proxy-ordered scan for K matches; top-1 propagation with distance
    tie-breaks, the paper's recommendation for limit queries (§6.3)."""

    kind = "limit"
    default_propagation = "top1"
    clip01 = False

    def validate(self, spec) -> None:
        if not spec.k_results or spec.k_results <= 0:
            raise ValueError("limit needs a positive `k_results`")

    def preview(self, plan, proxy) -> np.ndarray:
        # only the first batch is certain: the scan stops as soon as the Kth
        # match lands, so prefetching deeper would speculate with real labels
        s = plan.spec
        first = min(s.batch or 16, s.max_invocations or len(proxy))
        return scan_order(proxy)[:first]

    def execute(self, plan, proxy, oracle) -> LimitResult:
        s = plan.spec
        return limit_query(proxy, oracle, k_results=s.k_results,
                           batch=s.batch or 16,
                           max_invocations=s.max_invocations)

    def summarize(self, raw: LimitResult) -> dict:
        return {"selected": raw.found_ids,
                "n_invocations": raw.n_invocations}
