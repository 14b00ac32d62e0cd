"""JSON wire form of a :class:`~repro_torch.core.engine.QueryResult`.

One codec serves every presentation layer: the
``repro_torch.launch.query`` CLI prints these rows, and a serving layer
returns them to HTTP clients.  It lives in core so presentation layers
depend on core, never on each other.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


def result_row(res, workload: Optional[str] = None) -> Dict[str, Any]:
    """Flatten a ``QueryResult`` into JSON-safe primitives.  ``workload`` is
    the mounted workload that actually executed the query (multi-workload
    servers stamp it so interleaved clients can tell rows apart).  There is
    deliberately no fallback to the spec's own routing field: a caller that
    does not route (the ``launch.query`` CLI) must not report one."""
    row = {
        "kind": res.kind,
        "n_invocations": res.n_invocations,
        "n_oracle_fresh": res.n_oracle_fresh,
        "n_oracle_cached": res.n_oracle_cached,
        "n_cracked": res.n_cracked,
        "query_cost_s": round(sum(res.cost.values()), 3),
        "plan": res.plan.trace,
    }
    if workload is not None:
        row["workload"] = workload
    # scheduling fields echo back only when the caller set them, so rows
    # from unscheduled runs stay byte-identical to pre-scheduler output
    spec = res.plan.spec
    if spec.priority is not None:
        row["priority"] = int(spec.priority)
    if spec.deadline_ms is not None:
        row["deadline_ms"] = float(spec.deadline_ms)
    if res.estimate is not None:
        row["estimate"] = round(res.estimate, 6)
    if res.ci_half_width is not None:
        row["ci_half_width"] = round(res.ci_half_width, 6)
    if res.threshold is not None:
        row["threshold"] = round(res.threshold, 6)
    if res.selected is not None:
        row["n_selected"] = int(len(res.selected))
        row["selected_head"] = [int(i) for i in res.selected[:10]]
    if res.session is not None:
        row["session"] = res.session
    return row
