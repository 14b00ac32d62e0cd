"""Tiered persistent label store (hot RAM -> warm segments -> oracle).

The public surface is :class:`LabelStore` and :func:`index_fingerprint`,
unchanged in spirit from the single-file v1 store this package replaced:
open against an index lineage, ``attach`` to a broker, and every oracle
label paid for is journaled and reusable across restarts.  What the
package adds is *bigger-than-memory* operation: a byte-budgeted hot tier,
mmap-backed warm segment files, rotating journals with background
compaction, and tier-attributed observability.  See
``docs/api/label-store.md`` for the lifecycle, on-disk format, and
invariants.
"""
from repro_torch.serve.store.store import LabelStore, index_fingerprint

__all__ = ["LabelStore", "index_fingerprint"]
