"""Workload registry: many (index, engine, store) stacks behind one server.

TASTI's economics amortize one cheap index across many queries; a production
deployment amortizes further by hosting many *workloads* — video, text,
speech — behind one endpoint.  The registry is that mounting table:

* a :class:`WorkloadSpec` declares one workload (dataset + index to load or
  build + label store + oracle knobs) without constructing anything;
* :class:`WorkloadRegistry` maps workload names to entries, loads each
  lazily on first lookup (a server binds its port immediately and pays each
  workload's index build/load only when the first spec routes to it), and
  owns the shutdown sweep (close every loaded engine's replica pool, save
  every store);
* :meth:`WorkloadRegistry.from_manifest` mounts a whole fleet from one JSON
  file (the ``--manifest`` flag of ``repro_torch.launch.serve_queries``)::

      {"default": "video",
       "workloads": {
         "video": {"dataset": "night-street", "n_frames": 3000,
                   "index": "/data/video-idx", "store": "/data/video-idx",
                   "oracle_replicas": 2},
         "text": {"dataset": "wikisql", "n_records": 2000, "quick": true}}}

Each entry names the ``device`` its index lives on and its kernels run on
(CUDA unless it says ``"cpu"``).  A lazy mount loads from an HTTP worker
thread, so the device comes from the spec, never from thread state; a
mount whose device is unavailable fails at load and its error is memoized
like any other.

Every entry is a full serving stack of its own — ``TastiIndex``,
``QueryEngine`` (with per-workload ``oracle_replicas``/``oracle_batch``/
``crack``), optional ``LabelStore`` attached with write-through — so
workloads never share caches, accounts, or label stores; they share only
the server's worker pool and HTTP front end.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.core.engine import QueryEngine
from repro_torch.core.index import TastiIndex
from repro_torch.core.schema import WORKLOAD_NAMES, make_workload
from repro_torch.device import resolve_device
from repro_torch.obs import Observability
from repro_torch.serve.store import LabelStore
from repro_torch.serve.store.format import parse_bytes

#: Name the single-engine (legacy) server wraps its one workload under.
DEFAULT_WORKLOAD = "default"


@dataclass
class WorkloadSpec:
    """Declarative description of one mountable workload (JSON-friendly).

    ``index`` is the stem of a saved :class:`~repro_torch.core.index.TastiIndex`
    to load; without it an index is built in-process on first use (with the
    tiny ``quick`` budgets when set).  ``store`` defaults to the ``index``
    stem, mirroring the serving CLI; leave both unset to serve without
    persistence.
    """

    name: str
    dataset: str                     # make_workload name (night-street, ...)
    n_records: int = 8000            # workload size (n_frames for video)
    index: Optional[str] = None      # saved index stem to load
    store: Optional[str] = None      # label-store stem (default: index stem)
    #: Hot-tier byte budget for this workload's label store (int bytes or a
    #: "64m"-style string); None = unbounded.  Labels past the budget spill
    #: to warm segment files instead of growing the server's heap.
    store_budget: Optional[Any] = None
    quick: bool = False              # tiny build budgets (smoke tests / CI)
    variant: str = "T"
    n_train: int = 400
    n_reps: int = 800
    k: int = 8
    triplet_steps: int = 400
    oracle_batch: int = 64
    oracle_replicas: int = 1
    oracle_backend: str = "thread"   # replica kind: "thread" | "process"
    crack: bool = False
    device: Optional[str] = None     # index + kernels; None = CUDA

    def __post_init__(self):
        if self.dataset not in WORKLOAD_NAMES:
            raise ValueError(f"unknown dataset {self.dataset!r} for workload "
                             f"{self.name!r}; known: {list(WORKLOAD_NAMES)}")
        try:
            # normalize "64m"-style budgets to int bytes at declaration time
            # so a bad manifest fails at mount, not at first lazy load
            self.store_budget = parse_bytes(self.store_budget)
        except ValueError as e:
            raise ValueError(f"workload {self.name!r}: bad store_budget: "
                             f"{e}") from None

    _ALIASES = {"n_frames": "n_records"}

    @classmethod
    def from_dict(cls, name: str, d: Dict[str, Any]) -> "WorkloadSpec":
        if "n_frames" in d and "n_records" in d:
            raise ValueError(f"workload {name!r}: pass n_frames or "
                             "n_records, not both")
        fields = {f.name for f in dataclasses.fields(cls)} - {"name"}
        kw = {}
        for key, value in d.items():
            key = cls._ALIASES.get(key, key)
            if key not in fields:
                raise ValueError(
                    f"unknown key {key!r} in workload {name!r}; allowed: "
                    f"{sorted(fields | set(cls._ALIASES))}")
            kw[key] = value
        if "dataset" not in kw:
            raise ValueError(f"workload {name!r} needs a 'dataset'")
        return cls(name=name, **kw)


class WorkloadEntry:
    """One mounted workload: its spec and, once loaded, its serving stack."""

    def __init__(self, name: str, spec: Optional[WorkloadSpec] = None,
                 engine: Optional[QueryEngine] = None,
                 store: Optional[LabelStore] = None,
                 obs: Optional[Observability] = None):
        self.name = name
        self.spec = spec
        self.engine = engine
        self.store = store
        self.seeded = 0                      # labels seeded from the store
        self._lock = threading.Lock()        # serializes this entry's load
        self._load_error: Optional[Exception] = None
        self._obs: Optional[Observability] = None
        if obs is not None:
            self.adopt_obs(obs)

    def adopt_obs(self, obs: Observability) -> None:
        """Point this entry's stack at ``obs`` (metrics + tracing), labeling
        everything with ``workload=<name>``.  Safe before or after load: an
        unloaded entry remembers the scope for :meth:`_load`, a loaded one
        (pre-built engines mounted via ``register``) is re-pointed live."""
        self._obs = obs
        if self.engine is not None:
            self.engine.set_obs(obs.scoped(workload=self.name))

    @property
    def loaded(self) -> bool:
        return self.engine is not None

    @property
    def load_error(self) -> Optional[Exception]:
        """The memoized failure of a broken lazy mount (None when healthy);
        surfaced by ``/healthz`` and ``/workloads`` so a dead mount is
        distinguishable from a not-yet-loaded one without sending a query."""
        return self._load_error

    def describe(self) -> Dict[str, Any]:
        spec = self.spec
        out: Dict[str, Any] = {
            "name": self.name,
            "loaded": self.loaded,
            "dataset": (spec.dataset if spec is not None else
                        getattr(getattr(self.engine, "workload", None),
                                "name", None)),
        }
        if self.loaded:
            index = self.engine.index
            out.update(records=index.n_records, reps=index.n_reps,
                       device=str(index.device),
                       index_version=index.version,
                       oracle_replicas=self.engine.oracle_replicas,
                       oracle_backend=self.engine.oracle_backend,
                       store_labels=(None if self.store is None
                                     else len(self.store)))
        else:
            out.update(records=spec.n_records,
                       device=spec.device or "cuda",
                       oracle_replicas=spec.oracle_replicas,
                       oracle_backend=spec.oracle_backend,
                       store_labels=None)
        if self._load_error is not None:
            out["error"] = str(self._load_error)
        return out

    def ensure_loaded(self) -> "WorkloadEntry":
        with self._lock:
            if self.engine is None:
                # a failed load is memoized: manifest mistakes (wrong
                # n_records, missing index files) are deterministic, and
                # re-running a multi-minute build per routed request would
                # tie up the worker pool just to fail the same way
                if self._load_error is not None:
                    raise RuntimeError(
                        f"workload {self.name!r} failed to load previously "
                        f"(fix the manifest and restart): "
                        f"{self._load_error}") from self._load_error
                try:
                    self._load()
                except Exception as e:
                    self._load_error = e
                    raise
        return self

    def _load(self) -> None:
        spec = self.spec
        device = resolve_device(spec.device)   # raises before any work
        wl = make_workload(spec.dataset, n_records=spec.n_records)
        if spec.index:
            index = TastiIndex.load(spec.index, device=device)
            if index.n_records != len(wl.features):
                raise ValueError(
                    f"workload {self.name!r}: index {spec.index} covers "
                    f"{index.n_records} records but dataset {spec.dataset} "
                    f"has {len(wl.features)}; fix n_records in the manifest")
        else:
            # build in-process: heavy imports stay off the serve fast path
            from repro_torch.core.pipeline import build_tasti, cli_tasti_config
            cfg = cli_tasti_config(spec.quick, n_train=spec.n_train,
                                   n_reps=spec.n_reps, k=spec.k,
                                   triplet_steps=spec.triplet_steps)
            index = build_tasti(wl, cfg, variant=spec.variant,
                                device=device).index
        scope = (self._obs.scoped(workload=self.name)
                 if self._obs is not None else None)
        engine = QueryEngine(index, wl, crack=spec.crack,
                             max_oracle_batch=spec.oracle_batch,
                             oracle_replicas=spec.oracle_replicas,
                             oracle_backend=spec.oracle_backend,
                             obs=scope)
        store = None
        store_stem = spec.store or spec.index
        if store_stem:
            store = LabelStore.for_index(store_stem, index,
                                         hot_budget=spec.store_budget)
            self.seeded = store.attach(engine.broker, engine)
            print(f"[serve] workload {self.name}: label store "
                  f"{store.json_path}: {len(store)} labels, "
                  f"{self.seeded} seeded into the broker", file=sys.stderr)
        # store first: `engine` is the lock-free loaded flag that describe()
        # and /stats read, so everything else must be published before it
        self.store = store
        self.engine = engine

    def close(self) -> None:
        """Stop the engine's replica pool and persist the store (idempotent;
        a never-loaded entry has nothing to do).  A load still in flight is
        skipped rather than awaited: it has published nothing durable yet
        (write-through only starts once queries run), its threads are
        daemons, and blocking a shutdown on a multi-minute index build
        would defeat the server's otherwise-bounded drain."""
        if not self._lock.acquire(timeout=1.0):
            return
        try:
            if self.engine is not None:
                self.engine.close()
            if self.store is not None:
                self.store.save()
        finally:
            self._lock.release()


class WorkloadRegistry:
    """Name -> :class:`WorkloadEntry`, with lazy loading and a default.

        registry = WorkloadRegistry()
        registry.register("video", engine, store=store)   # pre-built
        registry.declare(WorkloadSpec("text", "wikisql", n_records=2000))
        entry = registry.get("text")        # loads on first lookup
        registry.close()                    # stop pools, save stores

    The default workload (explicit, else the first mounted) is what specs
    without a ``workload`` field route to — a single-workload server keeps
    today's API unchanged.
    """

    def __init__(self, default: Optional[str] = None):
        self._entries: Dict[str, WorkloadEntry] = {}
        self._default = default
        self._lock = threading.Lock()
        self._obs: Optional[Observability] = None

    def set_obs(self, obs: Observability) -> None:
        """Adopt every mounted entry (and all future mounts) into ``obs``."""
        with self._lock:
            self._obs = obs
            entries = list(self._entries.values())
        for entry in entries:
            entry.adopt_obs(obs)

    # -- mounting ------------------------------------------------------------
    def _add(self, entry: WorkloadEntry) -> WorkloadEntry:
        with self._lock:
            if entry.name in self._entries:
                raise ValueError(f"workload {entry.name!r} already mounted")
            self._entries[entry.name] = entry
            obs = self._obs
        if obs is not None:
            entry.adopt_obs(obs)
        return entry

    def register(self, name: str, engine: QueryEngine,
                 store: Optional[LabelStore] = None) -> WorkloadEntry:
        """Mount an already-constructed engine (tests, in-process callers).
        A ``store`` passed here is assumed already attached to the engine's
        broker; the registry only tracks it for stats and shutdown save."""
        return self._add(WorkloadEntry(name, engine=engine, store=store))

    def declare(self, spec: WorkloadSpec) -> WorkloadEntry:
        """Mount a workload lazily: nothing is built until first lookup."""
        return self._add(WorkloadEntry(spec.name, spec=spec))

    @classmethod
    def from_manifest(cls, path: str) -> "WorkloadRegistry":
        """Mount every workload declared in a JSON manifest file."""
        with open(path) as f:
            manifest = json.load(f)
        workloads = manifest.get("workloads")
        if not isinstance(workloads, dict) or not workloads:
            raise ValueError(f"manifest {path} needs a non-empty "
                             "'workloads' object")
        default = manifest.get("default")
        if default is not None and default not in workloads:
            raise ValueError(f"manifest default {default!r} is not one of "
                             f"its workloads {sorted(workloads)}")
        registry = cls(default=default)
        for name, entry in workloads.items():
            registry.declare(WorkloadSpec.from_dict(name, entry))
        return registry

    # -- lookup --------------------------------------------------------------
    @property
    def default(self) -> Optional[str]:
        with self._lock:
            if self._default is not None:
                return self._default
            return next(iter(self._entries), None)

    def set_default(self, name: str) -> None:
        with self._lock:
            if name not in self._entries:
                raise KeyError(f"unknown workload {name!r}; mounted: "
                               f"{sorted(self._entries)}")
            self._default = name

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def names(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def entries(self) -> List[WorkloadEntry]:
        """Snapshot of the mounted entries (never triggers a load)."""
        with self._lock:
            return list(self._entries.values())

    def get(self, name: Optional[str] = None) -> WorkloadEntry:
        """The loaded entry for ``name`` (default when None); builds/loads
        its index, engine, and store on first use.  Loading holds only the
        entry's own lock, so a slow build never blocks other workloads."""
        key = name if name is not None else self.default
        with self._lock:
            entry = self._entries.get(key)
        if entry is None:
            raise KeyError(f"unknown workload {key!r}; mounted: "
                           f"{sorted(self.names())}")
        return entry.ensure_loaded()

    def describe(self) -> List[Dict[str, Any]]:
        """Per-workload summaries for the ``/workloads`` endpoint."""
        default = self.default
        rows = []
        for entry in self.entries():
            row = entry.describe()
            row["default"] = entry.name == default
            rows.append(row)
        return rows

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Close every loaded workload: stop engine-owned replica pools and
        save the stores.  Idempotent; entries stay mounted and usable."""
        for entry in self.entries():
            entry.close()
