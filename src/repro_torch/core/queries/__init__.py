"""Query-processing algorithms (paper §4.3) + the executor registry that
plugs them into the declarative engine (:mod:`repro_torch.core.engine`).

Importing this package registers the built-in executors for the three paper
query kinds: ``aggregation``, ``selection`` (SUPG), and ``limit``.
"""
from repro_torch.core.queries import registry  # noqa: F401
from repro_torch.core.queries import aggregation, limit, selection  # noqa: F401

from repro_torch.core.queries.registry import (  # noqa: F401
    QueryExecutor, get_executor, register_executor, registered_kinds)
