"""Oracle replica pool: N target-DNN workers behind one flush.

TASTI prices queries in target-DNN invocations, and once the index makes
proxy scores cheap the wall-clock bottleneck is how fast those invocations
can be *driven* (BlazeIt/learned-index lesson: scale out the expensive
model, not the cheap index).  :class:`OraclePool` is the scale-out seam the
:class:`~repro_torch.core.broker.OracleBroker` dispatches microbatches to:

* **two backends** — ``backend="thread"`` (the default) runs each replica as
  an in-process worker thread: right when the target DNN releases the GIL
  (device dispatch, real inference, anything I/O-bound).
  ``backend="process"`` forks each replica into its own worker process fed
  over a pipe, so a *compute-bound* oracle that holds the GIL (pure-Python
  or numpy-scalar hot loops) still scales near-linearly — the
  ``compute_bound`` leg of ``benchmarks/oracle_scaling.py`` is the gate the
  thread backend cannot pass.  Id arrays cross as raw dtype/shape/bytes (or
  spooled ``.npy`` files with ``handoff="npz"``), never element pickles;
  labels come back the same way when they are plain ints/floats and as exact
  pickles otherwise, so annotations round-trip type-identically;
* **latency-aware sub-batch sizing** — sub-batches are carved from the flush
  *at dispatch time*, sized per replica by its EWMA labels/s: a replica
  measuring half the best rate gets half-size slices, so heterogeneous or
  degraded replicas stop straggling the flush instead of being handed the
  same fixed ``ceil(n / (replicas * oversub))`` share.  ``max_batches``
  additionally caps each replica's slice individually (heterogeneous
  replicas with different memory/batch limits);
* **work sharing** — every replica's feeder pulls the next slice from the
  same flush cursor, so fast replicas naturally work more of the flush (the
  work-stealing behavior of the fixed-chunk design, without a chunk queue);
* **retry on a surviving replica** — a slice whose replica raised is
  re-queued for the others; a replica whose *process died* (crash, kill) is
  marked dead and its slice retried on survivors; only when every live
  replica has failed a slice does the flush fail (and the broker's
  reservation scheme then restores the ids to pending, leaving all
  accounting untouched);
* **in-order reassembly is the caller's** — :meth:`run` returns a plain
  ``{id: annotation}`` dict; the broker publishes results in its own pending
  order, so label streams (and a label store's
  journal) are identical to the single-oracle path at any replica count and
  on either backend.

The process backend forks (``mp_context="fork"``), so replica callables and
workload state are inherited without pickling; use it for CPU-bound oracles
only — replicas that wrap device handles or threads should stay on the
thread backend (see docs/runbook.md for the decision table).
"""
from __future__ import annotations

import os
import queue
import shutil
import tempfile
import threading
import time
import uuid
from collections import deque
from math import ceil
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.obs import NULL_SCOPE
from repro_torch.obs.trace import add_timed_span

_STOP = object()
_BLOCKED = object()

BACKENDS = ("thread", "process")
HANDOFFS = ("pipe", "npz")

# weight of the newest sub-batch in the per-replica EWMAs; ~0.2 averages
# over the last ~5 sub-batches — reactive enough for latency-aware sizing,
# stable enough to ignore one-off stalls
_EWMA_ALPHA = 0.2


class OraclePoolError(RuntimeError):
    """A sub-batch failed on every live replica (the flush could not
    complete)."""


class OraclePoolClosed(RuntimeError):
    """:meth:`OraclePool.run` was called on a closed pool (e.g. a concurrent
    replica-count resize swapped it out); the caller should retry against
    its current pool or label inline."""


class _ReplicaDead(RuntimeError):
    """A process replica's worker died mid-call (crash/kill); internal —
    the feeder converts it into retry-on-survivors."""


# ---------------------------------------------------------------------------
# array / label handoff (process backend)
# ---------------------------------------------------------------------------
def _encode_array(arr: np.ndarray, handoff: str, spool: str):
    """An ndarray as pipe payload: raw dtype/shape/bytes, or a spooled
    ``.npy`` file handed off by path (``handoff="npz"``)."""
    if handoff == "npz":
        path = os.path.join(spool, f"{uuid.uuid4().hex}.npy")
        np.save(path, arr, allow_pickle=False)
        return ("npy", path)
    return ("raw", arr.dtype.str, arr.shape, arr.tobytes())


def _decode_array(payload) -> np.ndarray:
    if payload[0] == "npy":
        arr = np.load(payload[1], allow_pickle=False)
        try:
            os.unlink(payload[1])
        except OSError:
            pass
        return arr
    _, dtype, shape, buf = payload
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def _encode_labels(anns: List[Any], handoff: str, spool: str):
    """Labels as pipe payload.  Plain int/float labels travel as a raw
    array (reconstructed exactly via ``tolist``); anything else — schema
    dataclasses, dicts, numpy scalars — travels as an exact pickle, so the
    parent-side label values are indistinguishable from an in-process
    call."""
    if anns and all(type(a) is int for a in anns):
        arr = np.asarray(anns, np.int64)
        if arr.shape == (len(anns),) and [int(v) for v in arr] == anns:
            return ("i64", _encode_array(arr, handoff, spool))
    if anns and all(type(a) is float for a in anns):
        return ("f64", _encode_array(np.asarray(anns, np.float64),
                                     handoff, spool))
    return ("obj", anns)


def _decode_labels(payload) -> List[Any]:
    kind = payload[0]
    if kind == "obj":
        return payload[1]
    return _decode_array(payload[1]).tolist()


def _process_worker(conn, annotate: Callable, handoff: str,
                    spool: str) -> None:
    """One replica child: label sub-batches off the pipe until told to
    stop.  Every exception crosses back as data (the fault barrier lives
    here, like the thread backend's try/except around ``annotate``)."""
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        if msg[0] != "task":
            conn.close()
            return
        try:
            ids = _decode_array(msg[1])
            anns = list(annotate(ids))
            if len(anns) != len(ids):
                raise OraclePoolError(
                    f"replica returned {len(anns)} annotations "
                    f"for {len(ids)} ids")
            out = ("ok", _encode_labels(anns, handoff, spool))
        except BaseException as e:  # noqa: BLE001 - replica fault barrier
            out = ("err", f"{type(e).__name__}: {e}")
        try:
            conn.send(out)
        except (EOFError, OSError, BrokenPipeError):
            return


# ---------------------------------------------------------------------------
# replica channels
# ---------------------------------------------------------------------------
class _ThreadReplica:
    """In-process replica: invoke == call the target DNN on this thread."""

    def __init__(self, fn: Callable):
        self._fn = fn

    def invoke(self, ids: np.ndarray) -> List[Any]:
        return self._fn(ids)

    def stop(self, timeout: float) -> None:
        pass

    def is_alive(self) -> bool:
        return True


class _ProcessReplica:
    """Forked replica: one worker process behind a duplex pipe, driven by
    exactly one parent-side feeder thread (so the pipe is never shared)."""

    def __init__(self, fn: Callable, name: str, handoff: str, spool: str,
                 ctx) -> None:
        self._conn, child = ctx.Pipe(duplex=True)
        self._handoff = handoff
        self._spool = spool
        self.proc = ctx.Process(target=_process_worker,
                                args=(child, fn, handoff, spool),
                                name=name, daemon=True)
        self.proc.start()
        child.close()  # parent keeps only its end

    def invoke(self, ids: np.ndarray) -> List[Any]:
        try:
            self._conn.send(("task",
                             _encode_array(ids, self._handoff, self._spool)))
            msg = self._conn.recv()
        except (EOFError, OSError, BrokenPipeError) as e:
            raise _ReplicaDead(
                f"replica process {self.proc.pid} died mid-call "
                f"({type(e).__name__})") from e
        if msg[0] == "ok":
            return _decode_labels(msg[1])
        # replica-side exception: the worker survived, the call failed
        raise RuntimeError(msg[1])

    def stop(self, timeout: float) -> None:
        try:
            self._conn.send(("stop",))
        except (OSError, BrokenPipeError, ValueError):
            pass
        self.proc.join(timeout)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(0.5)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(0.5)
        try:
            self._conn.close()
        except OSError:
            pass

    def is_alive(self) -> bool:
        return self.proc.is_alive()


# ---------------------------------------------------------------------------
# one flush
# ---------------------------------------------------------------------------
class _FlushJob:
    """One :meth:`OraclePool.run` call: a cursor over its id array that
    feeders carve latency-sized slices from, a retry queue for failed
    slices, and the condition its caller blocks on.  Drivers of several
    concurrent jobs share the pool's ticket queue; each job completes
    independently."""

    __slots__ = ("ids", "max_batch", "cursor", "retry", "results", "batches",
                 "outstanding", "error", "cond", "timings")

    def __init__(self, ids: np.ndarray, max_batch: int):
        self.ids = ids
        self.max_batch = max_batch
        self.cursor = 0                       # next uncarved offset
        # failed slices awaiting a survivor: (chunk, {replica indices tried})
        self.retry: "deque[Tuple[np.ndarray, Set[int]]]" = deque()
        self.results: Dict[int, Any] = {}
        self.batches = 0                      # successful annotate() calls
        self.outstanding = len(ids)           # ids not yet labeled
        self.error: Optional[BaseException] = None
        self.cond = threading.Condition()
        # (replica, t0, t1, n_ids) per completed sub-batch — the caller
        # turns these into trace spans after the job finishes
        self.timings: List[Tuple[int, float, float, int]] = []


class OraclePool:
    """A pool of target-DNN replica workers.

        pool = OraclePool(workload.target_dnn_batch, n_replicas=4,
                          backend="process")
        labels, batches = pool.run(ids, max_batch=64)   # {id: annotation}
        pool.close()

    ``oversub`` controls sharding granularity: the *base* slice for a flush
    of ``n`` ids is ``min(max_batch, ceil(n / (n_replicas * oversub)))``,
    so small flushes still fan out across every replica and large ones keep
    well-shaped microbatches.  Once a replica has an EWMA labels/s rate its
    slices scale by ``rate / best_rate`` (a slow replica gets smaller
    slices); ``max_batches=[...]`` caps each replica's slice individually.
    """

    def __init__(self, annotate: Optional[Callable] = None,
                 n_replicas: int = 2, *,
                 replicas: Optional[Sequence[Callable]] = None,
                 backend: str = "thread",
                 oversub: int = 2,
                 max_batches: Optional[Sequence[int]] = None,
                 handoff: str = "pipe",
                 mp_context: Optional[str] = None,
                 name: str = "oracle-replica",
                 obs=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"expected one of {BACKENDS}")
        if handoff not in HANDOFFS:
            raise ValueError(f"unknown handoff {handoff!r}; "
                             f"expected one of {HANDOFFS}")
        if replicas is None:
            if annotate is None:
                raise ValueError("OraclePool needs `annotate` or `replicas`")
            if n_replicas <= 0:
                raise ValueError(
                    f"n_replicas must be positive, got {n_replicas}")
            replicas = [annotate] * int(n_replicas)
        replicas = list(replicas)
        if not replicas:
            raise ValueError("OraclePool needs at least one replica")
        self.backend = backend
        self.handoff = handoff
        self.n_replicas = len(replicas)
        self.oversub = max(1, int(oversub))
        if max_batches is not None:
            max_batches = [int(b) for b in max_batches]
            if len(max_batches) != self.n_replicas:
                raise ValueError(
                    f"max_batches has {len(max_batches)} entries for "
                    f"{self.n_replicas} replicas")
            if any(b < 1 for b in max_batches):
                raise ValueError(f"max_batches must be >= 1, got "
                                 f"{max_batches}")
        self._max_batches = max_batches
        self._tasks: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)  # signals _active == 0
        self._active = 0                              # run() calls in flight
        self._jobs: Set[_FlushJob] = set()            # jobs awaiting labels
        self._alive = [True] * self.n_replicas        # process replicas die
        self._closed = False
        self.stats: Dict[str, Any] = {
            "flushes": 0,        # run() calls
            "dispatched": 0,     # sub-batches carved and handed to a replica
            "batches": 0,        # successful annotate() calls
            "retries": 0,        # sub-batches re-queued after a failure
            "failures": 0,       # annotate() calls that raised (or died)
            "per_replica": [0] * self.n_replicas,          # completed batches
            "per_replica_failures": [0] * self.n_replicas,
            "per_replica_ids": [0] * self.n_replicas,      # labels produced
            "per_replica_max_slice": [0] * self.n_replicas,
            # ids a replica labeled beyond its fair 1/n share of a flush
            # (it worked a slower sibling's share)
            "steals": 0,
            # per-sub-batch EWMAs: wall seconds and labels/s — the labels/s
            # signal drives latency-aware slice sizing
            "per_replica_latency_ewma_s": [0.0] * self.n_replicas,
            "per_replica_rate_ewma": [0.0] * self.n_replicas,
        }
        self.set_obs(obs)
        self._spool: Optional[str] = None
        if backend == "process":
            import multiprocessing as mp
            start = mp_context or os.environ.get(
                "REPRO_ORACLE_MP_CONTEXT", "fork")
            ctx = mp.get_context(start)
            self._spool = tempfile.mkdtemp(prefix="oracle-pool-")
            self._replicas = [
                _ProcessReplica(fn, name=f"{name}-{ridx}", handoff=handoff,
                                spool=self._spool, ctx=ctx)
                for ridx, fn in enumerate(replicas)]
        else:
            self._replicas = [_ThreadReplica(fn) for fn in replicas]
        self._threads = [
            threading.Thread(target=self._drive, args=(ridx,),
                             name=f"{name}-feeder-{ridx}", daemon=True)
            for ridx in range(self.n_replicas)]
        for t in self._threads:
            t.start()

    def set_obs(self, obs) -> None:
        """Attach an :class:`~repro_torch.obs.ObsScope`; resolves the sub-batch
        latency histogram once (feeders observe it lock-free on the
        registry side)."""
        self._obs = obs if obs is not None else NULL_SCOPE
        self._h_sub = self._obs.histogram(
            "oracle_subbatch_latency_seconds",
            "wall time of one replica sub-batch (annotate call)")

    # -- sharding ------------------------------------------------------------
    def chunk_size(self, n: int, max_batch: int) -> int:
        """Base sub-batch size for a flush of ``n`` ids: small enough that
        every replica gets ~``oversub`` batches, never larger than
        ``max_batch``.  Per-replica EWMA rates then scale this down for
        slow replicas at dispatch time (:meth:`_slice_for`)."""
        per = ceil(n / (self.n_replicas * self.oversub))
        return max(1, min(int(max_batch), per))

    def _alive_set(self) -> Set[int]:
        with self._lock:
            return {i for i, a in enumerate(self._alive) if a}

    def _slice_for(self, ridx: int, job: _FlushJob) -> int:
        """Latency-aware slice size for ``ridx``: the base size scaled by
        this replica's EWMA labels/s relative to the best live replica,
        capped by the flush ``max_batch`` and the replica's own
        ``max_batches`` entry."""
        base = self.chunk_size(len(job.ids), job.max_batch)
        cap = job.max_batch
        if self._max_batches is not None:
            cap = min(cap, self._max_batches[ridx])
        with self._lock:
            rates = self.stats["per_replica_rate_ewma"]
            mine = rates[ridx]
            best = max((rates[i] for i, a in enumerate(self._alive) if a),
                       default=0.0)
        if mine > 0.0 and best > 0.0 and mine < best:
            base = max(1, int(round(base * (mine / best))))
        return max(1, min(base, cap))

    # -- the one entry point -------------------------------------------------
    def run(self, ids, max_batch: int) -> Tuple[Dict[int, Any], int]:
        """Label ``ids`` across the replicas; blocks until every slice
        completed (or failed on every live replica).  Returns
        ``({id: annotation}, n_batches)``.  Raises :class:`OraclePoolError`
        if any slice failed everywhere — the caller's ids are then untouched
        (no partial publish)."""
        with self._lock:
            if self._closed:
                raise OraclePoolClosed("OraclePool is closed")
            if not any(self._alive):
                raise OraclePoolError(
                    f"all {self.n_replicas} replica workers are dead; "
                    "the flush failed on all replicas")
            self.stats["flushes"] += 1
            self._active += 1
        try:
            ids = np.asarray(ids, np.int64).ravel()
            if len(ids) == 0:
                return {}, 0
            job = _FlushJob(ids, int(max_batch))
            with self._lock:
                self._jobs.add(job)
            try:
                for _ in range(self.n_replicas):
                    self._tasks.put(job)
                with job.cond:
                    while job.outstanding and job.error is None:
                        job.cond.wait()
                    if job.error is not None:
                        raise job.error
                    timings = list(job.timings)
                    results, batches = dict(job.results), job.batches
            finally:
                with self._lock:
                    self._jobs.discard(job)
            # post-completion bookkeeping: replica sub-batch spans on the
            # caller's trace, and steal counting (ids a replica labeled
            # beyond its fair 1/n share of this flush)
            per_ids = [0] * self.n_replicas
            for ridx, t0, t1, n in timings:
                per_ids[ridx] += n
                add_timed_span("oracle.subbatch", t0, t1,
                               replica=ridx, n=n)
            fair = ceil(len(ids) / self.n_replicas)
            stolen = sum(max(0, c - fair) for c in per_ids)
            if stolen:
                with self._lock:
                    self.stats["steals"] += stolen
            return results, batches
        finally:
            with self._lock:
                self._active -= 1
                if self._active == 0:
                    self._idle.notify_all()

    # -- feeders (one per replica, parent side) ------------------------------
    def _drive(self, ridx: int) -> None:
        replica = self._replicas[ridx]
        while True:
            task = self._tasks.get()
            if task is _STOP:
                return
            if not self._work_job(ridx, replica, task):
                return  # replica died; this feeder retires

    def _claim(self, ridx: int, job: _FlushJob):
        """Next slice for replica ``ridx``: a failed slice it has not tried,
        else a fresh latency-sized slice off the cursor.  Returns
        ``(chunk, tried)``, ``(_BLOCKED, None)`` when only slices this
        replica already failed remain, or ``(None, None)`` when the job has
        nothing left to hand out."""
        alive = self._alive_set()
        with job.cond:
            if job.error is not None or job.outstanding == 0:
                return None, None
            for k in range(len(job.retry)):
                chunk, tried = job.retry[k]
                if not (alive - tried):
                    # no live replica is left to retry this slice
                    job.error = OraclePoolError(
                        f"sub-batch of {len(chunk)} ids failed on all "
                        f"{self.n_replicas} replicas")
                    job.cond.notify_all()
                    return None, None
                if ridx not in tried:
                    del job.retry[k]
                    return chunk, tried
            if job.cursor < len(job.ids):
                take = self._slice_for(ridx, job)
                chunk = job.ids[job.cursor:job.cursor + take]
                job.cursor += take
                return chunk, set()
            if job.retry:
                return _BLOCKED, None
            return None, None

    def _work_job(self, ridx: int, replica, job: _FlushJob) -> bool:
        """Work one job ticket; returns False when this replica died."""
        while True:
            chunk, tried = self._claim(ridx, job)
            if chunk is None:
                return True
            if chunk is _BLOCKED:
                # only slices this replica already failed remain: hand the
                # ticket back for a survivor and back off so one can pick
                # it up (10ms bounds the spin without delaying the handoff)
                self._tasks.put(job)
                time.sleep(0.01)
                return True
            with self._lock:
                self.stats["dispatched"] += 1
            t0 = time.perf_counter()
            try:
                anns = replica.invoke(chunk)
                if len(anns) != len(chunk):
                    raise OraclePoolError(
                        f"replica {ridx} returned {len(anns)} annotations "
                        f"for {len(chunk)} ids")
            except _ReplicaDead as e:
                self._record_failure(ridx)
                self._retire_replica(ridx, job, chunk, tried, e)
                return False
            except Exception as e:  # noqa: BLE001 - replica fault barrier
                self._record_failure(ridx)
                self._requeue(job, chunk, tried, ridx, e)
                continue
            t1 = time.perf_counter()
            n = len(chunk)
            with job.cond:
                for i, a in zip(chunk, anns):
                    job.results[int(i)] = a
                job.batches += 1
                job.outstanding -= n
                job.timings.append((ridx, t0, t1, n))
                if job.outstanding == 0:
                    job.cond.notify_all()
            dt = max(t1 - t0, 1e-9)
            with self._lock:
                self.stats["batches"] += 1
                self.stats["per_replica"][ridx] += 1
                self.stats["per_replica_ids"][ridx] += n
                self.stats["per_replica_max_slice"][ridx] = max(
                    self.stats["per_replica_max_slice"][ridx], n)
                lat = self.stats["per_replica_latency_ewma_s"]
                lat[ridx] = dt if lat[ridx] == 0.0 else \
                    lat[ridx] + _EWMA_ALPHA * (dt - lat[ridx])
                rate = self.stats["per_replica_rate_ewma"]
                r = n / dt
                rate[ridx] = r if rate[ridx] == 0.0 else \
                    rate[ridx] + _EWMA_ALPHA * (r - rate[ridx])
            self._h_sub.observe(dt)

    def _record_failure(self, ridx: int) -> None:
        with self._lock:
            self.stats["failures"] += 1
            self.stats["per_replica_failures"][ridx] += 1

    def _requeue(self, job: _FlushJob, chunk: np.ndarray, tried: Set[int],
                 ridx: int, exc: BaseException) -> None:
        """Hand a failed slice to the survivors (or fail the job when none
        remain)."""
        tried = set(tried)
        tried.add(ridx)
        alive = self._alive_set()
        with job.cond:
            if not (alive - tried):
                job.error = OraclePoolError(
                    f"sub-batch of {len(chunk)} ids failed on all "
                    f"{self.n_replicas} replicas "
                    f"(last: {type(exc).__name__}: {exc})")
                job.cond.notify_all()
                return
            job.retry.append((chunk, tried))
        with self._lock:
            self.stats["retries"] += 1
        self._tasks.put(job)  # wake an idle survivor for the retry

    def _retire_replica(self, ridx: int, job: _FlushJob, chunk: np.ndarray,
                        tried: Set[int], exc: BaseException) -> None:
        """A process replica died mid-call: mark it dead, push its slice to
        the survivors, and fail every waiting job if it was the last one."""
        with self._lock:
            self._alive[ridx] = False
            any_alive = any(self._alive)
            jobs = list(self._jobs)
        if not any_alive:
            err = OraclePoolError(
                f"all {self.n_replicas} replica workers died; the flush "
                f"failed on all replicas (last: {exc})")
            for j in jobs:
                with j.cond:
                    if j.error is None and j.outstanding:
                        j.error = err
                        j.cond.notify_all()
            return
        self._requeue(job, chunk, tried, ridx, exc)

    # -- lifecycle -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """A consistent copy of ``stats`` (lists copied too)."""
        with self._lock:
            out = dict(self.stats)
            for key in ("per_replica", "per_replica_failures",
                        "per_replica_ids", "per_replica_max_slice"):
                out[key] = list(out[key])
            for key in ("per_replica_latency_ewma_s",
                        "per_replica_rate_ewma"):
                out[key] = [round(v, 6) for v in out[key]]
            out["n_replicas"] = self.n_replicas
            out["backend"] = self.backend
            out["per_replica_alive"] = list(self._alive)
            return out

    def close(self, timeout: float = 10.0) -> None:
        """Stop the feeders and replica workers (idempotent).  Drain-safe:
        waits for in-flight :meth:`run` calls to finish before the stop
        sentinels are enqueued, so a retry re-queued by a concurrent flush
        can never land behind a sentinel and strand the flush.  Process
        replicas are asked to exit, then joined, then terminated/killed —
        :meth:`close` never leaves children behind.  New :meth:`run` calls
        fail fast (the broker falls back to its current pool / inline
        labeling)."""
        deadline = time.monotonic() + timeout
        with self._idle:
            if self._closed:
                return
            self._closed = True
            while self._active:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._idle.wait(timeout=remaining):
                    break
        for _ in self._threads:
            self._tasks.put(_STOP)
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        for rep in self._replicas:
            rep.stop(timeout=max(0.1, deadline - time.monotonic()))
        if self._spool is not None:
            shutil.rmtree(self._spool, ignore_errors=True)

    def __enter__(self) -> "OraclePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
