"""On-disk format constants and small pure helpers for the tiered store.

Everything here is deliberately dependency-light: path naming, the format
version, the approximate-bytes estimator the hot tier budgets with, the
bloom-style per-segment id membership filter, and human byte-size parsing
for ``--store-budget``.  See ``docs/api/label-store.md`` for the format
table these constants pin down.
"""
from __future__ import annotations

import pathlib
import sys
from typing import Optional

import numpy as np

#: Version 2 is the tiered layout: a manifest (``.labels.json``) naming warm
#: segment files, a global id index (``.labels.npz``), rotating journal
#: segments.  Version 1 (one inline snapshot + one journal) is still READ —
#: its labels load pinned-hot and migrate to v2 on the next compaction.
FORMAT_VERSION = 2

#: Rotate the active journal once it crosses this many bytes (override per
#: store; a hot budget shrinks it so pinned journal backlog stays small).
DEFAULT_JOURNAL_ROTATE_BYTES = 256 << 10
#: Kick a background compaction once this many sealed journals accumulate.
DEFAULT_COMPACT_AFTER = 4
#: Fold every warm segment into one when a compaction would exceed this.
DEFAULT_MAX_SEGMENTS = 8

_SUFFIX_MANIFEST = ".labels.json"
_SUFFIX_IDS = ".labels.npz"
_SUFFIX_JOURNAL = ".labels.jsonl"


def sib(stem: pathlib.Path, suffix: str) -> pathlib.Path:
    """Sibling file of a store stem.  Suffixes are appended (not
    substituted) so dotted stems survive."""
    return stem.parent / (stem.name + suffix)


def manifest_path(stem: pathlib.Path) -> pathlib.Path:
    return sib(stem, _SUFFIX_MANIFEST)


def ids_path(stem: pathlib.Path) -> pathlib.Path:
    return sib(stem, _SUFFIX_IDS)


def journal_path(stem: pathlib.Path) -> pathlib.Path:
    return sib(stem, _SUFFIX_JOURNAL)


def sealed_journal_path(stem: pathlib.Path, seq: int) -> pathlib.Path:
    return sib(stem, f".labels.jnl-{seq:06d}.jsonl")


def segment_ids_path(stem: pathlib.Path, seq: int) -> pathlib.Path:
    return sib(stem, f".labels.seg-{seq:06d}.npz")


def segment_ann_path(stem: pathlib.Path, seq: int) -> pathlib.Path:
    return sib(stem, f".labels.seg-{seq:06d}.ann.jsonl")


def sealed_journals(stem: pathlib.Path) -> list:
    """Sealed journal files next to ``stem``, ascending by sequence."""
    return sorted(stem.parent.glob(stem.name + ".labels.jnl-*.jsonl"))


def store_files(stem: pathlib.Path) -> list:
    """Every file the store owns at ``stem`` (for orphan cleanup)."""
    out = [manifest_path(stem), ids_path(stem), journal_path(stem)]
    out += sealed_journals(stem)
    out += sorted(stem.parent.glob(stem.name + ".labels.seg-*"))
    return out


def log(msg: str) -> None:
    """Operator-facing store event line (lineage invalidation, corrupt-file
    degradation, compaction) — one grep-able prefix, documented in
    ``docs/runbook.md``."""
    print(f"[label-store] {msg}", file=sys.stderr)


# ---------------------------------------------------------------------------
# Approximate in-memory footprint of an annotation.  The hot tier budgets
# tracked bytes, not entry counts; this estimator only has to be consistent
# and monotone in payload size, not exact to the allocator.
# ---------------------------------------------------------------------------
def approx_nbytes(a) -> int:
    boxes = getattr(a, "boxes", None)  # schema.Scene without the import;
    if boxes is not None:              # first: the dominant video payload
        if isinstance(boxes, np.ndarray):
            return 112 + int(boxes.nbytes)
        return 112 + int(np.asarray(boxes).nbytes)
    if a is None or isinstance(a, (bool, int, float, np.integer, np.floating)):
        return 16
    if isinstance(a, str):
        return 56 + len(a)
    if isinstance(a, np.ndarray):
        return int(a.nbytes) + 112
    if isinstance(a, (list, tuple)):
        return 64 + sum(approx_nbytes(x) for x in a)
    if isinstance(a, dict):
        return 64 + sum(approx_nbytes(k) + approx_nbytes(v)
                        for k, v in a.items())
    return 64  # TextRecord and other small schema records


def parse_bytes(value) -> Optional[int]:
    """``--store-budget`` / manifest spelling of a byte count: an int, or a
    string with an optional k/m/g suffix (``"64k"``, ``"1.5m"``)."""
    if value is None:
        return None
    if isinstance(value, bool):
        raise ValueError(f"byte size must be a number, got {value!r}")
    if isinstance(value, (int, float, np.integer)):
        n = int(value)
    else:
        s = str(value).strip().lower()
        mult = 1
        for suffix, m in (("g", 1 << 30), ("m", 1 << 20), ("k", 1 << 10),
                          ("b", 1)):
            if s.endswith(suffix):
                s, mult = s[:-len(suffix)], m
                break
        try:
            n = int(float(s) * mult)
        except ValueError:
            raise ValueError(f"cannot parse byte size {value!r} "
                             "(want e.g. 1048576, '64k', '1.5m')") from None
    if n <= 0:
        raise ValueError(f"byte size must be positive, got {value!r}")
    return n


# ---------------------------------------------------------------------------
# Bloom-style id membership, vectorized over numpy int64 ids.  Three mixed
# hashes into a byte-aligned bitset; false positives only cost a wasted
# searchsorted, so ~8 bits/id keeps them rare without mattering if not.
# ---------------------------------------------------------------------------
_BLOOM_BITS_PER_ID = 8
_BLOOM_SEEDS = (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9)


def _bloom_positions(ids: np.ndarray, n_bits: int) -> np.ndarray:
    x = np.asarray(ids, np.int64).astype(np.uint64)
    rows = []
    with np.errstate(over="ignore"):
        for seed in _BLOOM_SEEDS:
            h = (x + np.uint64(seed)) * np.uint64(0xFF51AFD7ED558CCD)
            h ^= h >> np.uint64(33)
            h *= np.uint64(0xC4CEB9FE1A85EC53)
            h ^= h >> np.uint64(33)
            rows.append(h % np.uint64(n_bits))
    return np.stack(rows)


def bloom_build(ids: np.ndarray) -> np.ndarray:
    """uint8 bitset with every id's bloom bits set."""
    n_bits = max(64, 8 * ((len(ids) * _BLOOM_BITS_PER_ID + 7) // 8))
    bits = np.zeros(n_bits // 8, np.uint8)
    pos = _bloom_positions(ids, n_bits).ravel()
    np.bitwise_or.at(bits, (pos >> np.uint64(3)).astype(np.intp),
                     np.left_shift(np.uint8(1), (pos & np.uint64(7)).astype(np.uint8)))
    return bits


def bloom_maybe_contains(bits: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Boolean mask: which of ``ids`` MAY be members (no false negatives)."""
    n_bits = len(bits) * 8
    pos = _bloom_positions(ids, n_bits)
    byte = (pos >> np.uint64(3)).astype(np.intp)
    mask = np.left_shift(np.uint8(1), (pos & np.uint64(7)).astype(np.uint8))
    hit = (bits[byte] & mask) != 0
    return hit.all(axis=0)
