"""Tiered persistent oracle-label store: hot RAM -> warm segments -> oracle.

TASTI's economics price everything in target-DNN invocations, and one index
amortizes labels across *many* queries (paper §5-6) — so the label cache
must outlive the process AND scale past RAM.  A :class:`LabelStore` keeps
``{record id: target-DNN annotation}`` in three places:

* the **hot tier** (:mod:`repro_torch.serve.store.hot`) — an in-memory LRU map
  bounded by *tracked approximate bytes* (``hot_budget``; unbounded when
  None).  Only entries that are also readable from the warm tier are
  evictable, so budget pressure can never lose a paid label;
* the **warm tier** (:mod:`repro_torch.serve.store.segments`) — immutable
  compacted segment files (sorted-id npz + offset-addressed JSONL
  annotations, min/max-id fences + bloom membership, mmap-backed reads);
* the **journal** (:mod:`repro_torch.serve.store.journal`) — the rotating
  write-ahead log every broker flush lands in, fsync'd and O(batch);
  sealed journal segments are folded into warm segments by background
  compaction (or synchronously under budget pressure, or by :meth:`save`).

:meth:`attach` hands the broker a dict-like **tiered cache view** instead
of seeding a plain dict: a broker miss falls through hot -> warm -> oracle,
warm hits are promoted (then the LRU rebalances), and every fresh flush is
journaled write-through.  The **lineage check** is unchanged from v1: the
store records the index's crack ``version`` and an embedding-content
:func:`index_fingerprint`, and :meth:`open` discards (with a logged
warning, never a crash — labels are re-derivable) anything whose lineage
or bytes do not check out.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import threading
from typing import Any, Dict, Iterable, Optional

import numpy as np

from repro_torch.core.index import _decode_annotation, _encode_annotation
from repro_torch.core.persist import atomic_write
from repro_torch.serve.store import format as fmt
from repro_torch.serve.store.hot import CLEAN, DIRTY, PINNED, HotTier
from repro_torch.serve.store.journal import JournalWriter, read_journal
from repro_torch.serve.store.segments import (WarmSegment, WarmTier,
                                              write_segment)


def index_fingerprint(index) -> str:
    """A cheap content identity for the dataset behind ``index``: sha256
    over the embedding array's shape/dtype and a strided byte sample.
    Stable across cracking (cracks add representatives, never touch
    embeddings), different across datasets — the check that stops a reused
    ``--store`` path from serving another workload's labels."""
    emb = np.ascontiguousarray(index.embeddings)
    h = hashlib.sha256()
    h.update(repr((emb.shape, str(emb.dtype))).encode())
    flat = emb.view(np.uint8).ravel()
    h.update(flat[::max(1, len(flat) // 65536)].tobytes())
    return h.hexdigest()[:32]


class _TieredCacheView:
    """The dict-like object :meth:`LabelStore.attach` installs as
    ``broker.cache``: membership and reads fall through hot -> warm (with
    promotion), writes land in the hot tier, and :meth:`record_hit` is the
    broker's counted per-charge probe (tier attribution for the
    ``label_store_hits_total{tier=}`` accounting)."""

    __slots__ = ("_store",)

    def __init__(self, store: "LabelStore"):
        self._store = store

    def __contains__(self, i: int) -> bool:
        return i in self._store

    def __len__(self) -> int:
        return len(self._store)

    def __getitem__(self, i: int) -> Any:
        return self._store.broker_get(i)

    def __setitem__(self, i: int, a: Any) -> None:
        self._store.update({i: a})

    def update(self, labeled) -> None:
        if labeled:
            self._store.update(dict(labeled))

    def record_hit(self, i: int) -> None:
        self._store.record_hit(i)


class LabelStore:
    """Tiered label store with v1-compatible surface.

        store = LabelStore.for_index("/tmp/tasti/ns", index,
                                     hot_budget=64 << 20)
        store.attach(engine.broker, engine)   # tiered cache + write-through
        ... queries run; every flush journals; compaction folds to warm ...
        store.save()                          # full compact (shutdown does)
    """

    FORMAT_VERSION = fmt.FORMAT_VERSION

    def __init__(self, path: str, index_version: int = 0,
                 fingerprint: Optional[str] = None,
                 labels: Optional[Dict[int, Any]] = None,
                 hot_budget: Optional[int] = None,
                 journal_rotate_bytes: Optional[int] = None,
                 compact_after: int = fmt.DEFAULT_COMPACT_AFTER,
                 max_segments: int = fmt.DEFAULT_MAX_SEGMENTS,
                 auto_compact: bool = True):
        self.path = pathlib.Path(path)
        self.index_version = int(index_version)
        self.fingerprint = fingerprint
        hot_budget = fmt.parse_bytes(hot_budget)
        if journal_rotate_bytes is None:
            # with a budget, keep the journal backlog (pinned, unevictable)
            # a fraction of it so compaction — not pinning — absorbs pressure
            journal_rotate_bytes = fmt.DEFAULT_JOURNAL_ROTATE_BYTES
            if hot_budget is not None:
                journal_rotate_bytes = min(journal_rotate_bytes,
                                           max(4096, hot_budget // 4))
        self._hot = HotTier(budget=hot_budget)
        self._warm = WarmTier(self.path)
        self._journal = JournalWriter(self.path, self._lineage,
                                      rotate_bytes=journal_rotate_bytes)
        self._compact_after = int(compact_after)
        self._max_segments = int(max_segments)
        self._auto_compact = bool(auto_compact)
        self._compacting = False
        self._next_seg_seq = 1
        self._n = 0                 # distinct ids across hot + warm
        self._lock = threading.RLock()
        self.stats: Dict[str, int] = {
            "journal_appends": 0,    # write-through batches journaled
            "journal_records": 0,    # labels across those batches
            "journal_rotations": 0,  # active-journal seals
            "compactions": 0,        # journal/segment folds (incl. save())
            "evictions": 0,          # hot entries dropped to budget
            "hits_hot": 0,           # tier-attributed broker cache hits
            "hits_warm": 0,
        }
        # does the on-disk state carry THIS store's lineage in v2 form?
        # attach() compacts first when it does not (fresh stem, stale
        # lineage, or a v1 snapshot awaiting migration)
        self._disk_valid = False
        if labels:
            self.update(labels)

    # -- paths (v1-compatible names) -----------------------------------------
    @property
    def json_path(self) -> pathlib.Path:
        """The manifest (v2) / snapshot (v1) file."""
        return fmt.manifest_path(self.path)

    @property
    def npz_path(self) -> pathlib.Path:
        """The global sorted-id index over every warm segment."""
        return fmt.ids_path(self.path)

    @property
    def journal_path(self) -> pathlib.Path:
        """The ACTIVE journal; sealed rotations live at
        ``<stem>.labels.jnl-N.jsonl`` until compaction folds them."""
        return fmt.journal_path(self.path)

    def __len__(self) -> int:
        return self._n

    def __contains__(self, i) -> bool:
        i = int(i)
        with self._lock:
            return i in self._hot or self._warm.contains(i)

    @property
    def labels(self) -> Dict[int, Any]:
        """Every label, materialized across tiers (warm overlaid by hot).
        A full-store read — tests and small tools, not the serving path."""
        with self._lock:
            out = self._warm.load_all()
            out.update(self._hot.items())
            return out

    def _lineage(self) -> Dict[str, Any]:
        return {"format_version": self.FORMAT_VERSION,
                "index_version": self.index_version,
                "fingerprint": self.fingerprint}

    def _lineage_matches(self, meta: Dict[str, Any]) -> bool:
        if int(meta.get("index_version", -1)) != self.index_version:
            return False
        stored = meta.get("fingerprint")
        if self.fingerprint is not None and stored != self.fingerprint:
            return False
        return True

    # -- open ----------------------------------------------------------------
    @classmethod
    def for_index(cls, path: str, index, **config) -> "LabelStore":
        """The store next to ``path``, validated against ``index``'s full
        lineage (crack version + embedding fingerprint)."""
        return cls.open(path, index.version,
                        fingerprint=index_fingerprint(index), **config)

    @classmethod
    def open(cls, path: str, index_version: int,
             fingerprint: Optional[str] = None, **config) -> "LabelStore":
        """The store at ``path`` if present *and* cached against the given
        index lineage; otherwise a fresh empty store.

        A lineage mismatch (the index was cracked and re-saved after the
        store was written, rolled back, or the stem was reused for another
        dataset) invalidates the store: it comes back empty and the stale
        files are overwritten on the next save.  Corrupt or torn files
        (half-written v1 snapshot, missing segment) **degrade** the same
        way with a logged warning instead of failing startup — labels are
        re-derivable; a crashed server is not.  After the manifest, sealed
        journal segments replay in sequence order, then the active journal
        (a torn final line — crash mid-append — stops that file's replay
        there)."""
        store = cls(path, index_version=index_version,
                    fingerprint=fingerprint, **config)
        store._load_disk()
        store._replay_journals()
        with store._lock:
            store._enforce_budget(allow_compact=False)
        return store

    def _load_disk(self) -> None:
        if not self.json_path.exists():
            return
        try:
            with open(self.json_path) as f:
                meta = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            fmt.log(f"{self.json_path} is unreadable ({e}); opening empty — "
                    "labels will be re-derived")
            return
        fv = int(meta.get("format_version", -1))
        if fv > self.FORMAT_VERSION:
            raise ValueError(
                f"{self.json_path} has format_version {fv}; this build "
                f"reads <= {self.FORMAT_VERSION}")
        if not self._lineage_matches(meta):
            fmt.log(f"{self.json_path}: index lineage changed (stored "
                    f"index_version={meta.get('index_version')} "
                    f"fingerprint={str(meta.get('fingerprint'))[:12]}…, "
                    f"expected index_version={self.index_version} "
                    f"fingerprint={str(self.fingerprint)[:12]}…); opening "
                    "empty — cached labels belong to another index "
                    "generation and will be re-derived")
            return
        if fv >= 2:
            self._load_v2(meta)
        else:
            self._load_v1(meta)

    def _load_v2(self, meta: Dict[str, Any]) -> None:
        segments = []
        degraded = False
        for m in meta.get("segments", []):
            seg = WarmSegment(self.path, int(m["seq"]), m)
            if not (seg.ids_path.exists() and seg.ann_path.exists()):
                fmt.log(f"segment {seg.seq} of {self.path} is missing; "
                        "skipping it — its labels will be re-derived")
                degraded = True
                continue
            segments.append(seg)
        ids = None
        if not degraded and self.npz_path.exists():
            try:
                with np.load(self.npz_path) as z:
                    ids = np.asarray(z["ids"], np.int64)
            except Exception:
                ids = None  # stale/corrupt global index: rebuild by union
        try:
            self._warm.adopt(segments, ids=ids)
        except Exception as e:
            fmt.log(f"warm tier of {self.path} is unreadable ({e}); opening "
                    "empty — labels will be re-derived")
            self._warm.adopt([])
            degraded = True
        self._n = self._warm.n
        self._next_seg_seq = 1 + max((s.seq for s in self._warm.segments),
                                     default=0)
        # a degraded open must rewrite the manifest before journaling again
        self._disk_valid = not degraded

    def _load_v1(self, meta: Dict[str, Any]) -> None:
        """Read a version-1 snapshot (inline annotations + ids npz) into the
        hot tier, pinned; the next compaction migrates it to the tiered v2
        layout.  Torn snapshots degrade to empty instead of raising."""
        anns = meta.get("annotations", [])
        try:
            with np.load(self.npz_path) as z:
                ids = np.asarray(z["ids"], np.int64)
        except Exception as e:
            fmt.log(f"{self.npz_path} is unreadable ({e}); opening empty — "
                    "labels will be re-derived")
            return
        if len(ids) != len(anns):
            fmt.log(f"label store {self.path} is torn: {len(ids)} ids vs "
                    f"{len(anns)} annotations; opening empty — labels will "
                    "be re-derived")
            return
        for i, a in zip(ids, anns):
            self._insert(int(i), _decode_annotation(a), PINNED)
        if len(ids):
            fmt.log(f"{self.json_path}: v1 snapshot ({len(ids)} labels) "
                    "loads pinned-hot; the next compaction migrates it to "
                    f"the tiered v{self.FORMAT_VERSION} layout")

    def _replay_journals(self) -> int:
        replayed = 0
        with self._lock:
            for p in [*self._journal.sealed, self.journal_path]:
                encoded, n = read_journal(p, self._lineage_matches)
                for i, enc in encoded.items():
                    state = CLEAN if self._warm.contains(i) else PINNED
                    self._insert(i, _decode_annotation(enc), state)
                replayed += n
        return replayed

    # -- memory tier plumbing (all under self._lock) -------------------------
    def _insert(self, i: int, a: Any, state: int) -> bool:
        novel = i not in self._hot and not self._warm.contains(i)
        self._hot.put(i, a, state)
        if novel:
            self._n += 1
        return novel

    def _evict(self) -> None:
        self.stats["evictions"] += self._hot.evict()

    def _enforce_budget(self, allow_compact: bool = True) -> None:
        budget = self._hot.budget
        if budget is None:
            return
        self._evict()
        if self._hot.bytes > budget and allow_compact \
                and self._hot.pinned_count():
            # budget pressure has outrun background compaction: the LRU
            # can only shed CLEAN entries, so fold journals -> warm NOW
            # (pins become clean) and sweep again.  This is the mechanism
            # behind "tracked hot bytes never exceed the budget".
            self._save_locked()
            self._evict()

    # -- reads ---------------------------------------------------------------
    def broker_get(self, i: int) -> Any:
        """Uncounted tiered read with promotion (``broker.cache[i]``).
        Tier-hit attribution happens in :meth:`record_hit` at the broker's
        charge points, not here — a future's result pass re-reads fresh ids
        and must not inflate hit counters."""
        i = int(i)
        with self._lock:
            a, ok = self._hot.get(i)
            if ok:
                return a
            a, ok = self._warm.get_one(i)
            if not ok:
                raise KeyError(i)
            hot = self._hot
            hot.put(i, a, CLEAN)
            if hot.budget is not None and hot.bytes > hot.budget:
                self._enforce_budget()
            return a

    def record_hit(self, i: int) -> None:
        """Attribute one broker cache charge to the tier that answered it
        (and promote a warm answer while at it).  Called by the broker
        exactly once per ``cached``-charged id, so per workload
        ``hits_hot + hits_warm + dedup_inflight == broker cached``."""
        i = int(i)
        with self._lock:
            hot = self._hot
            _, ok = hot.get(i)  # LRU-touching probe
            if ok:
                self.stats["hits_hot"] += 1
                return
            a, ok = self._warm.get_one(i)
            if ok:
                self.stats["hits_warm"] += 1
                hot.put(i, a, CLEAN)
                if hot.budget is not None and hot.bytes > hot.budget:
                    self._enforce_budget()

    def get_many(self, ids: Iterable[int],
                 promote: bool = True) -> Dict[int, Any]:
        """Tier-aware bulk read: hot hits, then one batched warm lookup for
        the rest (fence/bloom-gated per segment).  ``promote=False`` reads
        the warm tier without disturbing the hot LRU (benchmarks measure
        the tiers separately with it)."""
        with self._lock:
            out, missing = self._hot.get_many(
                (int(i) for i in ids), touch=promote)
            self.stats["hits_hot"] += len(out)
            if missing:
                found = self._warm.get_many(missing)
                self.stats["hits_warm"] += len(found)
                out.update(found)
                if promote:
                    for i, a in found.items():
                        self._hot.put(i, a, CLEAN)
                    self._enforce_budget()
            return out

    # -- writes --------------------------------------------------------------
    def update(self, labeled: Dict[int, Any]) -> int:
        """Merge freshly labeled records (memory only; returns how many were
        new).  Persistence happens via the attached write-through journal
        or an explicit :meth:`save`."""
        with self._lock:
            new = 0
            for i, a in labeled.items():
                if self._insert(int(i), a, DIRTY):
                    new += 1
            self._evict()
            return new

    def _write_through(self, labeled: Dict[int, Any]) -> None:
        """The broker ``on_fresh`` listener: merge, journal (fsync'd,
        O(batch)), mark journal-durable, then rebalance the budget and
        maybe kick compaction.  Runs under the broker lock — everything
        here is O(batch) except a rare budget-pressure synchronous fold."""
        with self._lock:
            ids = [int(i) for i in labeled]
            # encode FIRST: a non-serializable annotation must abort before
            # any state or file is touched
            encoded = [_encode_annotation(labeled[i]) for i in labeled]
            for i in ids:
                self._insert(i, labeled[i], DIRTY)
            rotated = self._journal.append(ids, encoded)
            self._hot.mark(ids, PINNED)
            self.stats["journal_appends"] += 1
            self.stats["journal_records"] += len(ids)
            if rotated:
                self.stats["journal_rotations"] += 1
            self._enforce_budget()
            if self._auto_compact and not self._compacting \
                    and len(self._journal.sealed) >= self._compact_after:
                self._kick_compaction()

    # -- compaction ----------------------------------------------------------
    def _kick_compaction(self) -> None:
        """Fold sealed journals into a warm segment off the serving
        threads (single-flight; the fold itself holds the store lock)."""
        self._compacting = True
        t = threading.Thread(target=self._background_compact,
                             name="label-store-compact", daemon=True)
        t.start()

    def _background_compact(self) -> None:
        try:
            with self._lock:
                self._compact_sealed_locked()
        except Exception as e:  # never kill the process from a helper thread
            fmt.log(f"background compaction of {self.path} failed: {e}")
        finally:
            self._compacting = False

    def _compact_sealed_locked(self) -> int:
        """Fold every sealed journal segment into one new warm segment.
        Publish order is crash-safe: segment files, global id index, then
        the manifest (the commit point), and only then are the sealed
        journals unlinked — a crash anywhere replays to the same state."""
        sealed = list(self._journal.sealed)
        if not sealed:
            return 0
        merged: Dict[int, Any] = {}
        for p in sealed:
            encoded, _ = read_journal(p, self._lineage_matches)
            merged.update(encoded)
        if merged:
            seg = write_segment(self.path, self._next_seg_seq, merged)
            self._next_seg_seq += 1
            self._warm.add_segment(seg)
            if len(self._warm.segments) > self._max_segments:
                self._merge_segments_locked()
            self._publish_manifest()
            self._hot.mark(merged.keys(), CLEAN)
        self._journal.drop(sealed)
        self.stats["compactions"] += 1
        self._evict()
        return len(merged)

    def _merge_segments_locked(self) -> None:
        """Fold every warm segment into one (bounds segment count, dedups
        ids duplicated across crash-window segments)."""
        old = list(self._warm.segments)
        everything = {i: _encode_annotation(a)
                      for i, a in self._warm.load_all().items()}
        seg = write_segment(self.path, self._next_seg_seq, everything)
        self._next_seg_seq += 1
        self._warm.adopt([seg])
        self._publish_manifest()
        for s in old:
            s.ids_path.unlink(missing_ok=True)
            s.ann_path.unlink(missing_ok=True)

    def _publish_manifest(self) -> None:
        meta = {**self._lineage(),
                "segments": [s.meta() for s in self._warm.segments],
                "n_warm": self._warm.n}
        body = json.dumps(meta)  # encode before touching any file
        with atomic_write(self.npz_path, "wb") as f:
            np.savez(f, ids=self._warm.all_ids())
        with atomic_write(self.json_path, "w") as f:
            f.write(body)
        self._disk_valid = True

    def _cleanup_orphans(self) -> None:
        keep = {self.json_path, self.npz_path, self.journal_path}
        keep.update(self._journal.sealed)
        for s in self._warm.segments:
            keep.add(s.ids_path)
            keep.add(s.ann_path)
        for p in fmt.store_files(self.path):
            if p not in keep:
                p.unlink(missing_ok=True)

    def save(self) -> None:
        """Full compaction: persist every not-yet-warm label as a new warm
        segment, publish the manifest atomically, then drop the journals it
        subsumes (and any orphaned files from older generations).  A
        failing save (non-serializable annotation) aborts before any file
        or state is touched."""
        with self._lock:
            self._save_locked()

    def _save_locked(self) -> None:
        pending = self._hot.non_clean()
        encoded = {i: _encode_annotation(a) for i, a in pending.items()}
        if encoded:
            seg = write_segment(self.path, self._next_seg_seq, encoded)
            self._next_seg_seq += 1
            self._warm.add_segment(seg)
        if len(self._warm.segments) > self._max_segments:
            self._merge_segments_locked()
        else:
            self._publish_manifest()
        self._journal.clear()
        self._hot.mark(pending.keys(), CLEAN)
        self._cleanup_orphans()
        self.stats["compactions"] += 1
        self._evict()

    # -- broker integration --------------------------------------------------
    def attach(self, broker, engine=None) -> int:
        """Install this store as the broker's (tier-aware) label cache and
        journal every flush.  With ``engine`` given, a mid-serving crack
        re-stamps the lineage the store is cached against (and compacts),
        so its labels stay loadable against the re-saved index.  Returns
        the number of labels the broker can now serve without the oracle
        (i.e. ``len(self)`` after adopting anything already in the
        broker's previous cache)."""
        with self._lock:
            if not self._disk_valid:
                # fresh stem, stale files from another index generation, or
                # a v1 snapshot: compact now so the on-disk lineage (and any
                # journal header written later) is unambiguously this
                # store's, in v2 form
                self._save_locked()
        broker.adopt_cache(_TieredCacheView(self))
        broker.on_fresh(self._write_through)
        if engine is not None:
            def _restamp(_added: int) -> None:
                with self._lock:
                    self.index_version = engine.index.version
                    self._save_locked()

            engine.on_crack(_restamp)
        return len(self)

    # -- observability -------------------------------------------------------
    def observe(self) -> Dict[str, Any]:
        """One consistent snapshot of tier sizes, hit/eviction/compaction
        counters, and journal segment count/age — the source for the
        ``label_store_*`` metric families and the ``/stats`` store
        section."""
        with self._lock:
            active = 1 if self.journal_path.exists() else 0
            return {
                "n_labels": self._n,
                "hot": {"entries": len(self._hot),
                        "bytes": self._hot.bytes,
                        "budget": self._hot.budget,
                        "pinned": self._hot.pinned_count()},
                "warm": {"entries": self._warm.n,
                         "bytes": self._warm.nbytes(),
                         "segments": len(self._warm.segments)},
                "journal": {"bytes": self._journal.nbytes(),
                            "segments": len(self._journal.sealed) + active,
                            "sealed": len(self._journal.sealed),
                            "oldest_age_s": self._journal.oldest_age_s()},
                "hits": {"hot": self.stats["hits_hot"],
                         "warm": self.stats["hits_warm"]},
                "counters": dict(self.stats),
            }

    def close(self) -> None:
        """Release warm-tier file handles (mmaps); the store stays usable
        (segments reopen lazily)."""
        with self._lock:
            self._warm.close()
