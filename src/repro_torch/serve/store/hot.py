"""Hot tier: the in-memory map, LRU-bounded by tracked approximate bytes.

Entries carry a durability state that doubles as eviction eligibility:

* ``DIRTY`` — in memory only (a bare :meth:`LabelStore.update`).  Evicting
  it would lose a paid label, so it is pinned until a save/compaction.
* ``PINNED`` — durable in a journal file but not yet folded into a warm
  segment.  Still unreadable from the warm tier, so still pinned; budget
  pressure resolves this by *compacting*, not by evicting.
* ``CLEAN`` — warm-resident: the same annotation is readable from a warm
  segment, so the hot copy is pure cache and may be dropped.

The invariant the tests lean on: **only CLEAN entries are ever evicted**,
so no journaled (or merely updated) label can be lost to budget pressure —
it either stays hot or becomes readable from warm first.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.serve.store.format import approx_nbytes

DIRTY = 0    # memory only: pinned until saved
PINNED = 1   # journal-durable: pinned until compacted into a warm segment
CLEAN = 2    # warm-resident: evictable


class HotTier:
    """Insertion-ordered ``{id: [annotation, nbytes, state]}`` with
    move-to-end on touch; not thread-safe (the owning store locks)."""

    def __init__(self, budget: Optional[int] = None):
        self.budget = budget
        self._entries: "OrderedDict[int, List[Any]]" = OrderedDict()
        self.bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, i: int) -> bool:
        return i in self._entries

    def get(self, i: int, touch: bool = True):
        """``(annotation, True)`` on a hit (LRU-touched), ``(None, False)``
        on a miss — annotations may legitimately be None."""
        e = self._entries.get(i)
        if e is None:
            return None, False
        if touch:
            self._entries.move_to_end(i)
        return e[0], True

    def get_many(self, ids, touch: bool = True):
        """Batch probe: ``({id: annotation}, [missing ids])`` — one tight
        loop instead of a method call per id (the tiered ``get_many`` fast
        path)."""
        entries = self._entries
        move = entries.move_to_end
        hits: Dict[int, Any] = {}
        missing: List[int] = []
        for i in ids:
            e = entries.get(i)
            if e is None:
                missing.append(i)
            else:
                hits[i] = e[0]
                if touch:
                    move(i)
        return hits, missing

    def put(self, i: int, a: Any, state: int) -> None:
        """Insert or overwrite.  An overwrite keeps the *highest* durability
        seen for the id: labels are deterministic per record (the oracle is
        a pure function of the id), so a re-put never invalidates the copy
        already sitting in a journal or warm segment."""
        old = self._entries.get(i)
        nbytes = approx_nbytes(a)
        if old is not None:
            self.bytes -= old[1]
            state = max(old[2], state)
            self._entries.move_to_end(i)  # fresh assignment appends at end
        self._entries[i] = [a, nbytes, state]
        self.bytes += nbytes

    def mark(self, ids, state: int) -> None:
        """Promote durability (DIRTY -> PINNED -> CLEAN); never demotes."""
        for i in ids:
            e = self._entries.get(int(i))
            if e is not None and e[2] < state:
                e[2] = state

    def state(self, i: int) -> Optional[int]:
        e = self._entries.get(i)
        return None if e is None else e[2]

    def pinned_count(self) -> int:
        return sum(1 for e in self._entries.values() if e[2] != CLEAN)

    def items(self) -> Iterator[Tuple[int, Any]]:
        for i, e in self._entries.items():
            yield i, e[0]

    def non_clean(self) -> Dict[int, Any]:
        """Everything a full compaction still has to persist."""
        return {i: e[0] for i, e in self._entries.items() if e[2] != CLEAN}

    def evict(self, limit: Optional[int] = None) -> int:
        """Drop CLEAN entries in LRU order until ``bytes <= limit`` (the
        tier budget when None).  Returns how many entries were dropped;
        stops early when only pinned entries remain."""
        limit = self.budget if limit is None else limit
        if limit is None or self.bytes <= limit:
            return 0
        evicted = 0
        for i in list(self._entries):
            if self.bytes <= limit:
                break
            e = self._entries[i]
            if e[2] != CLEAN:
                continue
            del self._entries[i]
            self.bytes -= e[1]
            evicted += 1
        return evicted
