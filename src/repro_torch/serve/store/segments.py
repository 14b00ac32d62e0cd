"""Warm tier: immutable, compacted segment files read lazily off disk.

One segment = two sibling files written atomically by a compaction:

* ``<stem>.labels.seg-N.npz`` — sorted int64 ``ids``, int64 ``offsets``
  (length ``n+1``, byte ranges into the annotation file), a bloom bitset
  over the ids, and the packed **blob sidecar** (``blob``/``blob_offsets``):
  every ndarray/Scene payload's raw bytes, concatenated;
* ``<stem>.labels.seg-N.ann.jsonl`` — one JSON-encoded annotation per
  line, addressed by ``offsets`` so a lookup reads exactly its lines via
  the mmap, never parsing the file.  Array payloads are hoisted out of the
  JSON into the sidecar and replaced by ``{"__kind__": "blob", "k": i}``
  references, so a warm read is a tiny skeleton parse plus an O(size)
  buffer slice — not a float-by-float JSON decode (this is what keeps warm
  lookups within a small factor of a hot dict hit).

Lookups fall through newest segment first (a later compaction shadows an
older one for duplicated ids), and each segment gates the binary search
behind a min/max-id fence and the bloom filter, so a miss usually costs
two array compares and three bit probes.  Hits batch: one ``json.loads``
over all requested lines, then per-id blob resolution.  Segment index
arrays load lazily on first probe; annotation bytes are mmap-backed and
never held.
"""
from __future__ import annotations

import bisect
import json
import mmap
import pathlib
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core import schema as schema_lib
from repro_torch.core.index import _decode_annotation
from repro_torch.core.persist import atomic_write
from repro_torch.serve.store import format as fmt

_KIND_SCENE = 1  # columnar fast-path code: row decodes without JSON


def _hoist_blobs(node: Any, blobs: List[bytes]) -> Any:
    """Rewrite an ENCODED annotation so ndarray/Scene float payloads move
    into the packed sidecar, leaving a cheap-to-parse JSON skeleton."""
    if not isinstance(node, dict):
        return node
    kind = node.get("__kind__")
    if kind == "ndarray":
        a = np.asarray(node["data"], dtype=np.dtype(node["dtype"]))
        blobs.append(a.tobytes())
        return {"__kind__": "blob", "dtype": node["dtype"],
                "shape": node["shape"], "k": len(blobs) - 1}
    if kind == "scene":
        blobs.append(np.asarray(node["boxes"], np.float64).tobytes())
        return {"__kind__": "sceneblob", "n": int(node["n"]),
                "k": len(blobs) - 1}
    if kind == "list":
        return {"__kind__": "list",
                "items": [_hoist_blobs(x, blobs) for x in node["items"]]}
    if kind == "dict":
        return {"__kind__": "dict",
                "items": {key: _hoist_blobs(v, blobs)
                          for key, v in node["items"].items()}}
    return node


def _resolve_blobs(node: Any, blob: np.ndarray, off: np.ndarray) -> Any:
    """Decode a skeleton back to the annotation object, slicing array
    payloads out of the sidecar (the inverse of :func:`_hoist_blobs`).
    Array payloads are zero-copy views into the segment's loaded sidecar —
    repeat reads of one id share a buffer, exactly like the v1 store
    handing out its one cached object per id."""
    if not isinstance(node, dict):
        return node
    kind = node.get("__kind__")
    if kind == "blob":
        k = node["k"]
        return blob[off[k]:off[k + 1]].view(
            np.dtype(node["dtype"])).reshape(node["shape"])
    if kind == "sceneblob":
        k = node["k"]
        return schema_lib.Scene(boxes=blob[off[k]:off[k + 1]].view(
            np.float64).reshape(int(node["n"]), 2))
    if kind == "list":
        return [_resolve_blobs(x, blob, off) for x in node["items"]]
    if kind == "dict":
        return {key: _resolve_blobs(v, blob, off)
                for key, v in node["items"].items()}
    return _decode_annotation(node)  # blob-less kinds (text_record, ...)


class WarmSegment:
    """One immutable on-disk segment; cheap until first probed."""

    def __init__(self, stem: pathlib.Path, seq: int,
                 meta: Optional[Dict[str, Any]] = None):
        self.stem = stem
        self.seq = int(seq)
        meta = meta or {}
        self.n = int(meta.get("n", 0))
        self.min_id = meta.get("min_id")
        self.max_id = meta.get("max_id")
        self.ann_bytes = int(meta.get("ann_bytes", 0))
        self._ids: Optional[np.ndarray] = None
        self._offsets: Optional[np.ndarray] = None
        self._bloom: Optional[np.ndarray] = None
        self._blob: Optional[np.ndarray] = None
        self._blob_offsets: Optional[np.ndarray] = None
        self._kinds: Optional[np.ndarray] = None
        self._blob_k: Optional[np.ndarray] = None
        self._aux: Optional[np.ndarray] = None
        # plain-list shadows of the index arrays, built lazily on the first
        # per-hit probe: list indexing beats numpy scalar extraction at
        # single-id granularity
        self._ids_list: Optional[List[int]] = None
        self._off_list: Optional[List[int]] = None
        self._boff_list: Optional[List[int]] = None
        self._kind_list: Optional[List[int]] = None
        self._bk_list: Optional[List[int]] = None
        self._aux_list: Optional[List[int]] = None
        self._mmap: Optional[mmap.mmap] = None
        self._file = None

    @property
    def ids_path(self) -> pathlib.Path:
        return fmt.segment_ids_path(self.stem, self.seq)

    @property
    def ann_path(self) -> pathlib.Path:
        return fmt.segment_ann_path(self.stem, self.seq)

    def meta(self) -> Dict[str, Any]:
        return {"seq": self.seq, "n": self.n, "min_id": self.min_id,
                "max_id": self.max_id, "ann_bytes": self.ann_bytes}

    def _load_index(self) -> None:
        if self._ids is None:
            with np.load(self.ids_path) as z:
                self._ids = z["ids"]
                self._offsets = z["offsets"]
                self._bloom = z["bloom"]
                self._blob = z["blob"]
                self._blob_offsets = z["blob_offsets"]
                self._kinds = z["kinds"]
                self._blob_k = z["blob_k"]
                self._aux = z["aux"]

    def _ann(self) -> mmap.mmap:
        if self._mmap is None:
            self._file = open(self.ann_path, "rb")
            self._mmap = mmap.mmap(self._file.fileno(), 0,
                                   access=mmap.ACCESS_READ)
        return self._mmap

    def close(self) -> None:
        if self._mmap is not None:
            self._mmap.close()
            self._file.close()
            self._mmap = self._file = None

    def ids(self) -> np.ndarray:
        self._load_index()
        return self._ids

    def index_nbytes(self) -> int:
        if self._ids is None:
            return 0
        return int(self._ids.nbytes + self._offsets.nbytes +
                   self._bloom.nbytes + self._blob.nbytes +
                   self._blob_offsets.nbytes + self._kinds.nbytes +
                   self._blob_k.nbytes + self._aux.nbytes)

    def get_one(self, i: int):
        """``(annotation, True)`` or ``(None, False)`` for one id — the
        broker's per-hit path.  A plain bisect over a cached id list plus
        one line parse: no numpy batch machinery, so a single warm hit
        costs microseconds, not a vectorized-lookup setup."""
        if self.n == 0 or self.min_id is None \
                or not (self.min_id <= i <= self.max_id):
            return None, False
        if self._ids_list is None:
            self._load_index()
            self._ids_list = self._ids.tolist()
            self._off_list = self._offsets.tolist()
            self._boff_list = self._blob_offsets.tolist()
            self._kind_list = self._kinds.tolist()
            self._bk_list = self._blob_k.tolist()
            self._aux_list = self._aux.tolist()
        j = bisect.bisect_left(self._ids_list, i)
        if j >= self.n or self._ids_list[j] != i:
            return None, False
        if self._kind_list[j] == _KIND_SCENE:
            # columnar fast path: the Scene's blob range is precomputed in
            # the index, so the hit is a buffer slice — no JSON touched
            k = self._bk_list[j]
            boff = self._boff_list
            return schema_lib.Scene(boxes=self._blob[boff[k]:boff[k + 1]]
                                    .view(np.float64)
                                    .reshape(self._aux_list[j], 2)), True
        ann = self._ann()
        off = self._off_list
        raw = ann[off[j]:off[j + 1]]
        # decode to str explicitly: json.loads on bytes pays an encoding
        # sniff per call, noticeable at per-hit granularity
        return _resolve_blobs(json.loads(raw.decode()), self._blob,
                              self._blob_offsets), True

    def lookup_many(self, ids: np.ndarray) -> Dict[int, Any]:
        """Decoded annotations for the subset of ``ids`` in this segment.
        Fence and bloom run before the index is even loaded from disk."""
        if not len(ids) or self.n == 0:
            return {}
        if self.min_id is not None:
            fenced = ids[(ids >= self.min_id) & (ids <= self.max_id)]
            if not len(fenced):
                return {}
        else:
            fenced = ids
        self._load_index()
        maybe = fenced[fmt.bloom_maybe_contains(self._bloom, fenced)]
        if not len(maybe):
            return {}
        pos = np.searchsorted(self._ids, maybe)
        valid = pos < len(self._ids)
        pos, maybe = pos[valid], maybe[valid]
        hit = self._ids[pos] == maybe
        pos, found = pos[hit], maybe[hit]
        if not len(found):
            return {}
        blob, boff = self._blob, self._blob_offsets.tolist()
        out: Dict[int, Any] = {}
        scene, f64 = schema_lib.Scene, np.float64
        # columnar fast path first: Scene rows decode straight off the
        # precomputed kind/blob_k/aux columns, no JSON touched
        kinds = self._kinds[pos].tolist()
        bks = self._blob_k[pos].tolist()
        auxs = self._aux[pos].tolist()
        generic: List[int] = []   # segment rows still needing a JSON parse
        generic_ids: List[int] = []
        for i, j, kd, k, n in zip(found.tolist(), pos.tolist(), kinds,
                                  bks, auxs):
            if kd == _KIND_SCENE:
                out[i] = scene(boxes=blob[boff[k]:boff[k + 1]].view(
                    f64).reshape(n, 2))
            else:
                generic.append(j)
                generic_ids.append(i)
        if generic:
            ann = self._ann()
            off = self._offsets.tolist()
            raws = [ann[off[j]:off[j + 1]] for j in generic]
            # one C-level parse for the whole remainder: the trailing
            # newline each line carries is legal JSON whitespace
            skeletons = json.loads(b"[" + b",".join(raws) + b"]")
            for i, skel in zip(generic_ids, skeletons):
                kind = skel.get("__kind__") if type(skel) is dict else None
                if kind == "blob":
                    k = skel["k"]
                    out[i] = blob[boff[k]:boff[k + 1]].view(
                        np.dtype(skel["dtype"])).reshape(skel["shape"])
                else:
                    out[i] = _resolve_blobs(skel, blob,
                                            self._blob_offsets)
        return out


def write_segment(stem: pathlib.Path, seq: int,
                  encoded: Dict[int, Any]) -> WarmSegment:
    """Persist ``{id: ENCODED annotation}`` as segment ``seq`` (both files
    via :func:`atomic_write`) and return its handle.  Callers encode first
    so a non-serializable annotation aborts before any file is touched."""
    ids = np.asarray(sorted(encoded), np.int64)
    blobs: List[bytes] = []
    skeletons = [_hoist_blobs(encoded[int(i)], blobs) for i in ids]
    lines = [json.dumps(s).encode() + b"\n" for s in skeletons]
    offsets = np.zeros(len(ids) + 1, np.int64)
    np.cumsum([len(b) for b in lines], out=offsets[1:])
    blob_offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=blob_offsets[1:])
    blob = np.frombuffer(b"".join(blobs), np.uint8)
    # columnar fast path: Scene rows (the dominant video annotation) carry
    # their blob index + box count here, so a per-hit read never parses
    # JSON at all — kind 0 rows take the generic skeleton path
    kinds = np.zeros(len(ids), np.uint8)
    blob_k = np.zeros(len(ids), np.int64)
    aux = np.zeros(len(ids), np.int64)
    for row, s in enumerate(skeletons):
        if type(s) is dict and s.get("__kind__") == "sceneblob":
            kinds[row] = _KIND_SCENE
            blob_k[row] = s["k"]
            aux[row] = s["n"]
    with atomic_write(fmt.segment_ann_path(stem, seq), "wb") as f:
        for b in lines:
            f.write(b)
    with atomic_write(fmt.segment_ids_path(stem, seq), "wb") as f:
        np.savez(f, ids=ids, offsets=offsets, bloom=fmt.bloom_build(ids),
                 blob=blob, blob_offsets=blob_offsets,
                 kinds=kinds, blob_k=blob_k, aux=aux)
    meta = {"seq": int(seq), "n": int(len(ids)),
            "min_id": int(ids[0]) if len(ids) else None,
            "max_id": int(ids[-1]) if len(ids) else None,
            "ann_bytes": int(offsets[-1])}
    return WarmSegment(stem, seq, meta)


class WarmTier:
    """All live segments plus the global sorted id union (exact membership
    and an O(1) ``len`` without touching segment files)."""

    def __init__(self, stem: pathlib.Path):
        self.stem = stem
        self.segments: List[WarmSegment] = []
        self._ids = np.empty(0, np.int64)
        self._ids_list: Optional[List[int]] = None  # lazy, for per-id bisect

    @property
    def n(self) -> int:
        return len(self._ids)

    def all_ids(self) -> np.ndarray:
        return self._ids

    def set_ids(self, ids: np.ndarray) -> None:
        self._ids = np.asarray(ids, np.int64)
        self._ids_list = None

    def add_segment(self, seg: WarmSegment) -> None:
        self.segments.append(seg)
        self.segments.sort(key=lambda s: s.seq)
        self._ids = np.union1d(self._ids, seg.ids())
        self._ids_list = None

    def adopt(self, segments: List[WarmSegment],
              ids: Optional[np.ndarray] = None) -> None:
        """Swap in a new segment list (closing the old one).  ``ids`` is the
        trusted precomputed global union (the ``.labels.npz`` fast path);
        when absent it is rebuilt by unioning every segment's ids."""
        for seg in self.segments:
            seg.close()
        self.segments = sorted(segments, key=lambda s: s.seq)
        if ids is None:
            ids = np.empty(0, np.int64)
            for seg in self.segments:
                ids = np.union1d(ids, seg.ids())
        self._ids = np.asarray(ids, np.int64)
        self._ids_list = None

    def contains(self, i: int) -> bool:
        # per-id membership is serving-path hot: C bisect over a plain list
        # beats a numpy searchsorted call at single-id granularity
        lst = self._ids_list
        if lst is None:
            lst = self._ids_list = self._ids.tolist()
        j = bisect.bisect_left(lst, i)
        return j < len(lst) and lst[j] == i

    def get_one(self, i: int):
        """``(annotation, True)`` or ``(None, False)``, newest segment
        first — the per-hit serving path."""
        for seg in reversed(self.segments):
            a, ok = seg.get_one(i)
            if ok:
                return a, True
        return None, False

    def get_many(self, ids) -> Dict[int, Any]:
        """Decoded annotations for every requested id present in any
        segment, newest segment winning duplicates."""
        want = np.unique(np.asarray(list(ids), np.int64))
        out: Dict[int, Any] = {}
        for seg in reversed(self.segments):
            if not len(want):
                break
            found = seg.lookup_many(want)
            if found:
                out.update(found)
                want = want[~np.isin(want, np.asarray(list(found), np.int64))]
        return out

    def load_all(self) -> Dict[int, Any]:
        """The whole tier as one dict (oldest first, so newer wins)."""
        out: Dict[int, Any] = {}
        for seg in self.segments:
            out.update(seg.lookup_many(seg.ids()))
        return out

    def nbytes(self) -> int:
        return sum(s.ann_bytes + s.index_nbytes() for s in self.segments)

    def close(self) -> None:
        for seg in self.segments:
            seg.close()
