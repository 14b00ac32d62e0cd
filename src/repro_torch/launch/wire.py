"""Per-device collective wire bytes: the counterpart of the JAX package's
``launch/hlo_analysis.py``.

The JAX package reads its collectives out of the compiled HLO text.  The
port has no compiler and no HLO: every collective of the port goes through
``parallel.collectives``, which records each call while
:func:`count_collectives` is open, and this module turns the records into
wire bytes by the same ring formulas over the group size g:

* all-reduce:      2 (g-1)/g * result_bytes
* all-gather:        (g-1)/g * result_bytes
* reduce-scatter:    (g-1)/g * operand_bytes (= result * g)
* all-to-all:        (g-1)/g * result_bytes
* collective-permute:            result_bytes

``collectives.all_reduce`` and ``all_reduce_many`` are all-reduces,
``all_gather_cat`` an all-gather, ``reduce_scatter`` a reduce-scatter, and
``send`` and ``recv`` a collective-permute each, on the rank that calls it.
``broadcast`` has no XLA counterpart in these formulas: it counts as its own
op, ``broadcast``, at its result bytes (each rank but the source receives
the tensor once).

A collective over several mesh dims runs over one dim's group at a time
(``parallel.collectives``), and each call counts with its own group size:
an all-reduce over (data, model) of a 16 x 16 mesh is an all-reduce over 16
ranks, then another over 16, 2 * 2 * 15/16 of the bytes, where XLA's single
all-reduce over the 256 ranks of the product counts 2 * 255/256.

The port runs eagerly: every layer's collectives are recorded where they
run, so there are no loop bodies to scale by a trip count and ``loops`` is
always empty.
"""
from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterable, Tuple

from repro_torch.parallel import collectives

#: the ops a record names
OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute", "broadcast")


def wire_bytes(op: str, result_bytes: int, g: int) -> float:
    """Bytes one device sends for ``op`` with a result of ``result_bytes``
    over a group of ``g`` (``hlo_analysis._wire_bytes``' formulas, and
    ``broadcast`` at its result bytes)."""
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if op == "all-reduce":
        return 2.0 * frac * result_bytes
    if op == "all-gather":
        return frac * result_bytes
    if op == "reduce-scatter":
        return frac * result_bytes * g
    if op == "all-to-all":
        return frac * result_bytes
    if op in ("collective-permute", "broadcast"):
        return float(result_bytes)
    return 0.0


def summarize(records: Iterable[Tuple[str, int, int]]) -> Dict[str, object]:
    """``{"wire_bytes_per_device", "op_counts", "loops"}`` of records
    ``(op, result bytes, group size)``, as ``analyze_collectives``
    returns them."""
    wire = 0.0
    counts: Dict[str, float] = defaultdict(float)
    for op, nbytes, g in records:
        wire += wire_bytes(op, nbytes, g)
        counts[op] += 1
    return {"wire_bytes_per_device": float(wire),
            "op_counts": {k: float(v) for k, v in counts.items()},
            "loops": {}}


class CollectiveCount:
    """What :func:`count_collectives` saw: ``records`` in call order, and
    their :func:`summarize` as :meth:`summary`."""

    def __init__(self):
        self.records: list = []

    def summary(self) -> Dict[str, object]:
        return summarize(self.records)


@contextmanager
def count_collectives():
    """While open, every call of ``parallel.collectives`` in this process
    appends ``(op, result bytes, group size)`` to the yielded
    :class:`CollectiveCount`'s ``records``."""
    count = CollectiveCount()
    collectives._recordings.append(count.records)
    try:
        yield count
    finally:
        collectives._recordings.remove(count.records)
