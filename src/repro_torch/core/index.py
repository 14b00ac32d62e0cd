"""The TASTI index (paper §3): embeddings + annotated cluster representatives
+ cached top-k distances, with cracking (§3.3) and a construction cost model
(§3.4: O(C*c_T + L*c_E + N*c_E + N*C*D*c_D)).

The host fields (numpy) and the on-disk format are those of the JAX package,
so an index saved by either package loads in the other.  On top of them the
index keeps its embeddings resident on ``device`` once, and its top-k
structures there per version: cracking computes against the resident copy
and merges on the device.
"""
from __future__ import annotations

import dataclasses
import pathlib
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import schema as schema_lib
from repro_torch.core.fpf import fpf_select
from repro_torch.device import DeviceLike, as_device_tensor, resolve_device
from repro_torch.kernels.distance_topk.ops import distance_topk
from repro_torch.obs import trace


@dataclass
class IndexCost:
    target_invocations: int = 0
    embed_records: int = 0
    training_steps: int = 0
    distance_pairs: int = 0

    def wall_clock_s(self) -> float:
        return (self.target_invocations * schema_lib.TARGET_DNN_COST_S
                + self.embed_records * schema_lib.EMBED_DNN_COST_S
                + self.training_steps * 256 * schema_lib.EMBED_DNN_COST_S * 3
                + self.distance_pairs * schema_lib.DIST_COST_S)

    def breakdown(self) -> Dict[str, float]:
        return {
            "target_dnn_s": self.target_invocations * schema_lib.TARGET_DNN_COST_S,
            "embedding_s": self.embed_records * schema_lib.EMBED_DNN_COST_S,
            "training_s": self.training_steps * 256 * schema_lib.EMBED_DNN_COST_S * 3,
            "distance_s": self.distance_pairs * schema_lib.DIST_COST_S,
        }


@dataclass
class TastiIndex:
    embeddings: np.ndarray            # (N, d)
    rep_ids: np.ndarray               # (C,) record indices of representatives
    annotations: list                 # len C target-DNN outputs for reps
    topk_d2: np.ndarray               # (N, k) squared distances (ascending)
    topk_ids: np.ndarray              # (N, k) indices INTO rep_ids
    k: int
    cost: IndexCost = field(default_factory=IndexCost)
    version: int = 0                  # bumped on every crack that mutates;
                                      # caches keyed on it self-invalidate
    device: Optional[torch.device] = None   # None -> resolve_device()
    _emb_dev: Optional[torch.Tensor] = field(default=None, repr=False,
                                             compare=False)
    _topk_dev: Optional[tuple] = field(default=None, repr=False,
                                       compare=False)  # (version, ids, d2)
    _dev_lock: Any = field(default_factory=threading.Lock, repr=False,
                           compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def n_records(self) -> int:
        return len(self.embeddings)

    @property
    def n_reps(self) -> int:
        return len(self.rep_ids)

    # ------------------------------------------------------------------
    @staticmethod
    def build(embeddings: np.ndarray, n_reps: int, annotate: Callable,
              k: int = 8, random_fraction: float = 0.1, seed: int = 0,
              cost: Optional[IndexCost] = None,
              rep_selection: str = "fpf",
              device: DeviceLike = None) -> "TastiIndex":
        """annotate(ids) -> list of target-DNN outputs (counted in the cost)."""
        dev = resolve_device(device)
        n = len(embeddings)
        cost = cost or IndexCost()
        emb = as_device_tensor(embeddings, dev)
        trace.count("h2d_bytes", emb.nbytes)
        if rep_selection == "fpf":
            rep_ids = fpf_select(emb, n_reps,
                                 random_fraction=random_fraction, seed=seed)
        else:
            rng = np.random.default_rng(seed)
            rep_ids = rng.choice(n, size=min(n_reps, n), replace=False)
        with trace.span("tasti.annotate", n=len(rep_ids)):
            annotations = annotate(rep_ids)
        cost.target_invocations += len(rep_ids)
        with trace.span("tasti.topk", pairs=n * len(rep_ids)):
            rep_dev = torch.as_tensor(np.asarray(rep_ids, np.int64),
                                      device=dev)
            trace.count("h2d_bytes", rep_dev.nbytes)
            reps = emb.index_select(0, rep_dev)
            d2, ids = distance_topk(emb, reps, min(k, len(rep_ids)))
            topk_d2, topk_ids = d2.cpu().numpy(), ids.cpu().numpy()
            trace.count("d2h_bytes", topk_d2.nbytes + topk_ids.nbytes)
        cost.distance_pairs += n * len(rep_ids)
        index = TastiIndex(embeddings=embeddings,
                           rep_ids=np.asarray(rep_ids),
                           annotations=list(annotations),
                           topk_d2=topk_d2, topk_ids=topk_ids,
                           k=k, cost=cost, device=dev)
        index._emb_dev = emb
        index._topk_dev = (index.version, ids, d2)
        return index

    # ------------------------------------------------------------------
    def embeddings_device(self) -> torch.Tensor:
        """The (N, d) embeddings on the index's device, uploaded once
        (embeddings never change across cracks)."""
        with self._dev_lock:
            if self._emb_dev is None:
                self._emb_dev = as_device_tensor(self.embeddings, self.device)
            return self._emb_dev

    def topk_device(self):
        """``(version, topk_ids int32, topk_d2 float32)`` on the index's
        device, uploaded from the host fields when stale."""
        with self._dev_lock:
            if self._topk_dev is None or self._topk_dev[0] != self.version:
                self._topk_dev = (
                    self.version,
                    torch.as_tensor(np.asarray(self.topk_ids, np.int32),
                                    device=self.device),
                    torch.as_tensor(np.asarray(self.topk_d2, np.float32),
                                    device=self.device))
            return self._topk_dev

    # ------------------------------------------------------------------
    def crack(self, new_ids: Sequence[int], new_annotations: list) -> None:
        """Fold query-time target-DNN results back in as new representatives
        (paper §3.3).  Incremental: distances only to the new reps, merged
        with the cached top-k (no full rebuild)."""
        new_ids = np.asarray([i for i in new_ids], np.int64)
        if len(new_ids) == 0:
            return
        # dedupe against existing reps
        existing = set(self.rep_ids.tolist())
        keep = [t for t, i in enumerate(new_ids) if int(i) not in existing]
        if not keep:
            return
        new_ids = new_ids[keep]
        new_annotations = [new_annotations[t] for t in keep]
        base_c = self.n_reps
        emb = self.embeddings_device()
        _, topk_ids, topk_d2 = self.topk_device()
        reps = emb.index_select(0, torch.as_tensor(new_ids, device=emb.device))
        d2_new, loc = distance_topk(emb, reps, min(self.k, len(new_ids)))
        self.cost.distance_pairs += self.n_records * len(new_ids)
        # merge (N, k_old + k_new) and keep the k smallest; the stable sort
        # keeps the cached column ahead on equal distances
        cand_d = torch.cat([topk_d2, d2_new], dim=1)
        cand_i = torch.cat([topk_ids, loc + base_c], dim=1)
        order = torch.sort(cand_d, dim=1, stable=True).indices[:, :self.k]
        merged_d = torch.gather(cand_d, 1, order)
        merged_i = torch.gather(cand_i, 1, order)
        self.topk_d2 = merged_d.cpu().numpy()
        self.topk_ids = merged_i.cpu().numpy()
        self.rep_ids = np.concatenate([self.rep_ids, new_ids])
        self.annotations = self.annotations + list(new_annotations)
        self.version += 1
        with self._dev_lock:
            self._topk_dev = (self.version, merged_i, merged_d)

    # ------------------------------------------------------------------
    def rep_scores(self, score_fn: Callable[[Any], float]) -> np.ndarray:
        return np.asarray([score_fn(a) for a in self.annotations], np.float64)

    def max_intra_cluster(self) -> float:
        return float(np.sqrt(np.max(self.topk_d2[:, 0])))

    # ------------------------------------------------------------------
    # Persistence: arrays in ``<path>.npz``, everything else in a versioned
    # ``<path>.meta.json`` — portable and safe to load (no pickle).  Both
    # files are written atomically (temp file + rename), so a crash mid-save
    # cannot leave a torn pair on disk.
    FORMAT_VERSION = 1

    def save(self, path: str) -> None:
        import json
        from repro_torch.core.persist import atomic_write
        p = pathlib.Path(path)
        # serialize the meta FIRST: an unencodable annotation must fail
        # before any file is touched, not orphan a fresh .npz
        meta = {"format_version": self.FORMAT_VERSION,
                "k": self.k,
                "index_version": self.version,
                "n_reps": int(self.n_reps),
                "cost": dataclasses.asdict(self.cost),
                "annotations": [_encode_annotation(a)
                                for a in self.annotations]}
        meta_body = json.dumps(meta)
        with atomic_write(p.with_suffix(".npz"), "wb") as f:
            np.savez(f, embeddings=self.embeddings,
                     rep_ids=self.rep_ids, topk_d2=self.topk_d2,
                     topk_ids=self.topk_ids, k=np.int64(self.k))
        with atomic_write(p.with_suffix(".meta.json"), "w") as f:
            f.write(meta_body)
        # re-saving over a legacy index drops its stale (now unreadable)
        # pickle so the saved artifact is unambiguous
        p.with_suffix(".ann.pkl").unlink(missing_ok=True)

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "TastiIndex":
        import json
        device = resolve_device(device)
        p = pathlib.Path(path)
        z = np.load(p.with_suffix(".npz"))
        meta_json = p.with_suffix(".meta.json")
        if not meta_json.exists():
            pkl = p.with_suffix(".ann.pkl")
            if pkl.exists():
                raise ValueError(
                    f"{pkl} is a legacy pickle-format index; pickle support "
                    "has been removed — load and re-save it with a release "
                    "that still reads .ann.pkl to migrate to the versioned "
                    "JSON+npz format")
            raise FileNotFoundError(f"no {meta_json.name} next to {p}")
        with open(meta_json) as f:
            meta = json.load(f)
        fv = int(meta.get("format_version", -1))
        if fv > TastiIndex.FORMAT_VERSION:
            raise ValueError(
                f"{meta_json} has format_version {fv}; this build reads "
                f"<= {TastiIndex.FORMAT_VERSION}")
        annotations = [_decode_annotation(a) for a in meta["annotations"]]
        index_version = int(meta.get("index_version", 0))
        # each file is written atomically but the pair is not one
        # transaction: a crash between the two renames can mix an old meta
        # with a new npz (or vice versa) — detect, don't mis-serve
        if len(annotations) != len(z["rep_ids"]):
            raise ValueError(
                f"{p} is torn: {meta_json.name} lists {len(annotations)} "
                f"annotations but the npz holds {len(z['rep_ids'])} "
                "representatives (crash between the two file writes?); "
                "re-save the index")
        return TastiIndex(embeddings=z["embeddings"], rep_ids=z["rep_ids"],
                          annotations=annotations,
                          topk_d2=z["topk_d2"], topk_ids=z["topk_ids"],
                          k=int(z["k"]), cost=IndexCost(**meta["cost"]),
                          version=index_version, device=device)


# ---------------------------------------------------------------------------
# JSON codec for representative annotations.  Target-DNN outputs are schema
# records (Scene / TextRecord), plain numbers, or nested lists/dicts thereof;
# anything else must be made serializable by the caller (no pickle).
# ---------------------------------------------------------------------------
def _encode_annotation(a):
    if a is None or isinstance(a, (bool, int, float, str)):
        return a
    if isinstance(a, np.integer):
        return int(a)
    if isinstance(a, np.floating):
        return float(a)
    if isinstance(a, np.ndarray):
        return {"__kind__": "ndarray", "dtype": str(a.dtype),
                "shape": list(a.shape), "data": a.ravel().tolist()}
    if isinstance(a, schema_lib.Scene):
        return {"__kind__": "scene",
                "boxes": np.asarray(a.boxes, np.float64).reshape(-1).tolist(),
                "n": int(a.count)}
    if isinstance(a, schema_lib.TextRecord):
        return {"__kind__": "text_record", "op": int(a.op),
                "n_predicates": int(a.n_predicates)}
    if isinstance(a, (list, tuple)):
        return {"__kind__": "list", "items": [_encode_annotation(x) for x in a]}
    if isinstance(a, dict):
        return {"__kind__": "dict",
                "items": {str(k): _encode_annotation(v) for k, v in a.items()}}
    raise TypeError(
        f"cannot JSON-encode annotation of type {type(a).__name__}; "
        "supported: numbers, str, ndarray, Scene, TextRecord, list, dict")


def _decode_annotation(a):
    if not isinstance(a, dict):
        return a
    kind = a.get("__kind__")
    if kind == "ndarray":
        return np.asarray(a["data"], dtype=np.dtype(a["dtype"])).reshape(
            a["shape"])
    if kind == "scene":
        boxes = np.asarray(a["boxes"], np.float64).reshape(int(a["n"]), 2)
        return schema_lib.Scene(boxes=boxes)
    if kind == "text_record":
        return schema_lib.TextRecord(op=int(a["op"]),
                                     n_predicates=int(a["n_predicates"]))
    if kind == "list":
        return [_decode_annotation(x) for x in a["items"]]
    if kind == "dict":
        return {k: _decode_annotation(v) for k, v in a["items"].items()}
    raise ValueError(f"unknown annotation encoding {kind!r}")
