"""Rotating write-ahead journal for the label store.

The *active* journal keeps the v1 contract byte-for-byte: JSONL at
``<stem>.labels.jsonl``, a lineage header on line 0, one fsync'd
``{"ids": [...], "annotations": [...]}`` line per broker flush — O(batch),
crash-safe up to a torn final line.  What is new is **rotation**: once the
active file crosses ``rotate_bytes`` it is sealed by a single atomic
rename to ``<stem>.labels.jnl-N.jsonl`` (crash-safe at the boundary: the
rename either happened or it did not, and replay reads sealed files in
sequence order then the active file, applying the torn-tail rule to each
independently).  Sealed journals are immutable; compaction folds them into
warm segments and unlinks them.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.serve.store import format as fmt

_SEALED_SEQ = re.compile(r"\.labels\.jnl-(\d+)\.jsonl$")


class JournalWriter:
    """Appends + rotation for one store stem; the owning store locks."""

    def __init__(self, stem: pathlib.Path, lineage: Callable[[], Dict],
                 rotate_bytes: int = fmt.DEFAULT_JOURNAL_ROTATE_BYTES):
        self.stem = stem
        self.path = fmt.journal_path(stem)
        self.rotate_bytes = int(rotate_bytes)
        self._lineage = lineage
        self._active_since: Optional[float] = None
        self.sealed: List[pathlib.Path] = fmt.sealed_journals(stem)

    def next_seq(self) -> int:
        seqs = [int(m.group(1)) for p in self.sealed
                if (m := _SEALED_SEQ.search(p.name))]
        return (max(seqs) + 1) if seqs else 1

    def append(self, ids: List[int], encoded: List[Any]) -> bool:
        """Durably append one batch; returns True when the append sealed
        the active file (rotation happened)."""
        entry = {"ids": ids, "annotations": encoded}
        new = not self.path.exists()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a") as f:
            if new:
                f.write(json.dumps(self._lineage()) + "\n")
                self._active_since = time.time()
            f.write(json.dumps(entry) + "\n")
            f.flush()
            os.fsync(f.fileno())
            size = f.tell()
        if size >= self.rotate_bytes:
            self.rotate()
            return True
        return False

    def rotate(self) -> Optional[pathlib.Path]:
        """Seal the active journal (atomic rename); no-op when empty."""
        if not self.path.exists():
            return None
        sealed = fmt.sealed_journal_path(self.stem, self.next_seq())
        os.replace(self.path, sealed)
        self.sealed.append(sealed)
        self._active_since = None
        return sealed

    def drop(self, paths: List[pathlib.Path]) -> None:
        """Forget + unlink sealed journals a compaction subsumed."""
        for p in paths:
            p.unlink(missing_ok=True)
        gone = set(paths)
        self.sealed = [p for p in self.sealed if p not in gone]

    def clear(self) -> None:
        """Unlink everything (a full save subsumed all journal content)."""
        self.drop(list(self.sealed))
        self.path.unlink(missing_ok=True)
        self._active_since = None

    def nbytes(self) -> int:
        total = 0
        for p in [*self.sealed, self.path]:
            try:
                total += p.stat().st_size
            except OSError:
                pass
        return total

    def oldest_age_s(self) -> float:
        """Seconds since the oldest un-compacted journal byte was written
        (0 when no journal exists) — the 'how far behind is compaction'
        gauge."""
        oldest: Optional[float] = None
        for p in self.sealed:
            try:
                m = p.stat().st_mtime
            except OSError:
                continue
            oldest = m if oldest is None else min(oldest, m)
        if oldest is None and self._active_since is not None:
            oldest = self._active_since
        return max(0.0, time.time() - oldest) if oldest is not None else 0.0


def read_journal(path: pathlib.Path,
                 lineage_matches: Callable[[Dict], bool]
                 ) -> Tuple[Dict[int, Any], int]:
    """``({id: ENCODED annotation}, n_records)`` from one journal file.

    Line 0 must be a lineage header matching this store, else the whole
    file belongs to another index generation and is ignored.  A torn line
    (crash mid-append) stops the replay of *this* file; later files (and
    the active journal) are read independently.
    """
    out: Dict[int, Any] = {}
    n = 0
    if not path.exists():
        return out, 0
    with open(path) as f:
        for lineno, line in enumerate(f):
            try:
                entry = json.loads(line)
            except json.JSONDecodeError:
                break  # torn tail: keep everything before it
            if lineno == 0:
                if not lineage_matches(entry):
                    return {}, 0
                continue
            for i, a in zip(entry["ids"], entry["annotations"]):
                out[int(i)] = a
                n += 1
    return out, n
