"""Oracle broker: batched, deduplicating access to the target DNN.

TASTI's cost metric is target-DNN invocations (paper §5-6), so the system
layer between executors and the workload should never label a record twice
and should hand the (expensive, batch-friendly) target DNN work in
well-shaped microbatches.  :class:`OracleBroker` owns exactly that seam:

* **microbatching** — label requests accumulate in an ordered pending queue
  and are flushed to ``target_dnn_batch`` in chunks of ``max_batch``
  (flush-on-demand: a blocking read drains the queue);
* **dedup** — ids already cached, or already in flight for another consumer,
  are never re-labeled; the second requester rides along for free;
* **two consumption styles** — a blocking :meth:`fetch` for executors that
  need labels now, and a futures-style :meth:`request`/:class:`LabelFuture`
  pair plus :meth:`prefetch` so several query specs can enqueue their samples
  first and amortize one combined flush (how
  :class:`~repro_torch.core.session.QuerySession` shares batches across specs);
* **per-consumer accounting** — each :class:`OracleAccount` (one per query
  spec) tracks exactly the fresh labels it caused and the cache hits it was
  served, so per-spec invocation counts stay honest under cross-spec dedup:
  a record labeled for spec A is *fresh* for A and *cached* for B;
* **thread safety via reservation** — one reentrant lock protects the
  pending queue, cache, stats, and account registry, so concurrent
  :class:`~repro_torch.core.session.QuerySession` s (the serving layer's worker
  pool) share one broker.  The lock is *not* held across
  ``target_dnn_batch``: a flush **reserves** its pending ids (marks them
  in-flight under the lock), labels them outside it, and **publishes** the
  results under the lock again.  In-flight dedup stays exact — a request for
  a reserved id rides along without re-labeling, and a demand-read blocks on
  the broker's condition until the reservation publishes.  On failure the
  reservation is rolled back into the pending queue with no counts charged;
* **sharded labeling** — with an :class:`~repro_torch.core.oracle_pool.OraclePool`
  attached, each flush's microbatches are dispatched to N target-DNN replica
  workers concurrently (work sharing, per-sub-batch retry, thread *or*
  forked-process replicas — the backend is invisible here) and the results
  are published in pending order, so labels, accounting, and the write-
  through stream are byte-identical to the single-oracle path on either
  backend.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.oracle_pool import OraclePool, OraclePoolClosed
from repro_torch.obs import NULL_SCOPE, SIZE_BUCKETS
from repro_torch.obs.trace import span, start_span


@dataclass
class OracleAccount:
    """Per-consumer (per query spec) oracle accounting.

    ``fresh`` counts records the target DNN labeled *because of this
    consumer*; ``cached`` counts requests served from the shared cache (or
    from another consumer's in-flight batch).  ``labeled`` lists the fresh
    ids in labeling order — the cracking feedback loop folds exactly these
    back into the index.
    """
    name: str = ""
    fresh: int = 0
    cached: int = 0
    labeled: List[int] = field(default_factory=list)
    # ids this account pre-paid via prefetch(); the first demand-read of each
    # is free (the fresh charge already happened at flush time)
    _credit: Set[int] = field(default_factory=set)


class LabelFuture:
    """Handle to labels that may not have been computed yet.

    ``result()`` drains the broker's pending queue if needed (flush-on-
    demand) and returns the annotations in request order.
    """

    def __init__(self, broker: "OracleBroker", ids: np.ndarray):
        self._broker = broker
        self._ids = [int(i) for i in ids]

    def done(self) -> bool:
        with self._broker._lock:
            return all(i in self._broker.cache for i in self._ids)

    def result(self) -> List[Any]:
        b = self._broker
        while True:
            with b._cond:
                if all(i in b.cache for i in self._ids):
                    return [b.cache[i] for i in self._ids]
                if not any(i in b._pending for i in self._ids):
                    # everything still missing is reserved by another
                    # thread's in-flight flush: wait for its publish
                    # (timeout is lost-wakeup insurance; the loop re-checks)
                    b._cond.wait(timeout=0.25)
                    continue
            b.flush()  # outside the lock: flush reserves/labels/publishes


class OracleBroker:
    """Batches, dedups, and accounts for target-DNN label requests.

    ``annotate(ids) -> list`` is the raw oracle (``workload.
    target_dnn_batch``); every call to it goes through :meth:`flush` in
    chunks of at most ``max_batch`` ids.  With ``pool`` set (an
    :class:`~repro_torch.core.oracle_pool.OraclePool`), flushes are sharded across
    the pool's replica workers instead of calling ``annotate`` inline;
    ``pool`` may be swapped at any time between flushes (the engine's
    ``oracle_replicas`` knob does exactly that).
    """

    def __init__(self, annotate: Callable[[np.ndarray], Sequence[Any]],
                 max_batch: int = 64,
                 cache: Optional[Dict[int, Any]] = None,
                 pool: Optional[OraclePool] = None,
                 obs=None):
        if max_batch <= 0:
            raise ValueError(f"max_batch must be positive, got {max_batch}")
        self.annotate = annotate
        self.max_batch = int(max_batch)
        self.pool = pool
        self.set_obs(obs)
        self.cache: Dict[int, Any] = {} if cache is None else cache
        # tier-aware caches (the LabelStore's view) expose record_hit so
        # cache-hit charges can be attributed to the tier that answered
        self._record_hit = getattr(self.cache, "record_hit", None)
        self._pending: Dict[int, Optional[OracleAccount]] = {}  # id -> owner
        # ids reserved by an in-flight flush (labeled outside the lock);
        # requests for them ride along, demand-reads wait on _cond
        self._inflight: Dict[int, Optional[OracleAccount]] = {}
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        # bounded: a long-lived server issues one account per served spec,
        # so retaining them all would grow without bound; global totals live
        # in self.stats, this ring only feeds the /stats "recent" view
        self._accounts: "deque[OracleAccount]" = deque(maxlen=256)
        self._on_fresh: List[Callable[[Dict[int, Any]], None]] = []
        self.stats: Dict[str, int] = {
            "requests": 0,        # ids seen by request()/fetch()
            "fresh": 0,           # records actually labeled
            "cached": 0,          # requests served without labeling
            "dedup_inflight": 0,  # requests that rode an in-flight id
            "batches": 0,         # target_dnn_batch calls issued
            "flushes": 0,         # flush() calls that did work
            "max_pending": 0,     # high-water mark of the pending queue
            "prefetched": 0,      # ids enqueued via prefetch()
        }

    def set_obs(self, obs) -> None:
        """Attach an :class:`~repro_torch.obs.ObsScope` (the server wires one per
        workload).  Resolves the flush histograms once so the hot path
        never touches the registry; counters stay derived at scrape time
        from :meth:`observe`."""
        self._obs = obs if obs is not None else NULL_SCOPE
        self._h_flush_latency = self._obs.histogram(
            "oracle_flush_latency_seconds",
            "wall time of one broker flush (label + publish)")
        self._h_flush_size = self._obs.histogram(
            "oracle_flush_size_labels",
            "fresh labels reserved per flush", buckets=SIZE_BUCKETS)

    def account(self, name: str = "") -> OracleAccount:
        acct = OracleAccount(name=name)
        with self._lock:
            self._accounts.append(acct)
        return acct

    def account_stats(self) -> List[Dict[str, Any]]:
        """Per-account fresh/cached counters for the most recently issued
        accounts (bounded ring; the serving layer's ``/stats`` payload —
        all-time totals are ``stats["fresh"]``/``stats["cached"]``)."""
        with self._lock:
            return [{"name": a.name, "fresh": a.fresh, "cached": a.cached}
                    for a in self._accounts]

    def snapshot(self) -> Dict[str, int]:
        """A consistent copy of ``stats`` (plus cache/pending sizes)."""
        with self._lock:
            return {**self.stats, "cache_size": len(self.cache),
                    "n_pending": len(self._pending),
                    "n_inflight": len(self._inflight)}

    def observe(self, recent_accounts: int = 32) -> Dict[str, Any]:
        """Stats *and* the recent per-account counters under ONE lock
        acquisition, so a scrape racing a flush can't pair totals and
        account rows from different instants (the publish phase bumps
        both atomically).  This is what ``/stats`` and the ``/metrics``
        collector read."""
        with self._lock:
            accounts = list(self._accounts)
            if recent_accounts and len(accounts) > recent_accounts:
                accounts = accounts[-recent_accounts:]
            return {
                "stats": {**self.stats, "cache_size": len(self.cache),
                          "n_pending": len(self._pending),
                          "n_inflight": len(self._inflight)},
                "accounts": [{"name": a.name, "fresh": a.fresh,
                              "cached": a.cached} for a in accounts],
            }

    # -- persistence hooks ---------------------------------------------------
    def seed(self, labels: Dict[int, Any]) -> int:
        """Preload the cache (e.g. from a persistent
        label store).  Already-cached ids keep
        their current label.  Returns the number of labels added."""
        added = 0
        with self._lock:
            for i, a in labels.items():
                i = int(i)
                if i not in self.cache:
                    self.cache[i] = a
                    added += 1
        return added

    def adopt_cache(self, cache) -> int:
        """Swap in a replacement label cache (typically a
        label store's tiered view).  Anything in
        the current cache that the replacement does not already hold is
        carried over, so labels paid for before the swap stay paid for.
        Returns the number of labels the new cache serves."""
        with self._lock:
            old = self.cache
            if old is not None and len(old) > 0 and old is not cache:
                cache.update(old)
            self.cache = cache
            self._record_hit = getattr(cache, "record_hit", None)
            return len(cache)

    def on_fresh(self, callback: Callable[[Dict[int, Any]], None]) -> None:
        """Register a write-through listener: called with ``{id: annotation}``
        after every batch of fresh labels (flush or cache-bypassing fetch),
        while the broker lock is held — keep callbacks quick."""
        with self._lock:
            self._on_fresh.append(callback)

    def _notify_fresh(self, labeled: Dict[int, Any]) -> None:
        if labeled:
            for cb in self._on_fresh:
                cb(labeled)

    # -- enqueue -------------------------------------------------------------
    def request(self, ids, account: Optional[OracleAccount] = None
                ) -> LabelFuture:
        """Enqueue ``ids`` (dedup against cache and in-flight) and return a
        future.  Charges ``account.cached`` for every id somebody else
        already paid for; fresh charges land at flush time on the consumer
        that caused the labeling."""
        ids = np.asarray(ids, np.int64).ravel()
        with self._lock:
            self.stats["requests"] += len(ids)
            for raw in ids:
                i = int(raw)
                if i in self.cache:
                    if account is not None and i in account._credit:
                        account._credit.discard(i)  # pre-paid by prefetch
                    else:
                        self.stats["cached"] += 1
                        if self._record_hit is not None:
                            self._record_hit(i)  # tier attribution
                        if account is not None:
                            account.cached += 1
                elif i in self._pending or i in self._inflight:
                    if account is not None and i in account._credit:
                        # own unflushed (or mid-flush) prefetch: this demand-
                        # read consumes the credit; the fresh charge lands at
                        # flush publish
                        account._credit.discard(i)
                    else:
                        self.stats["cached"] += 1
                        self.stats["dedup_inflight"] += 1
                        if account is not None:
                            account.cached += 1
                else:
                    self._pending[i] = account
            self.stats["max_pending"] = max(self.stats["max_pending"],
                                            len(self._pending))
        return LabelFuture(self, ids)

    def prefetch(self, ids, account: Optional[OracleAccount] = None) -> int:
        """Enqueue ``ids`` without charging anything yet.  Ids already cached
        or in flight are skipped (cross-spec dedup); newly enqueued ids are
        credited to ``account`` so its later demand-read is free.  Returns
        the number of ids actually enqueued."""
        ids = np.asarray(ids, np.int64).ravel()
        enqueued = 0
        with self._lock:
            for raw in ids:
                i = int(raw)
                if i in self.cache or i in self._pending \
                        or i in self._inflight:
                    continue
                self._pending[i] = account
                if account is not None:
                    account._credit.add(i)
                enqueued += 1
            self.stats["prefetched"] += enqueued
            self.stats["max_pending"] = max(self.stats["max_pending"],
                                            len(self._pending))
        return enqueued

    # -- consume -------------------------------------------------------------
    def fetch(self, ids, account: Optional[OracleAccount] = None,
              reuse: bool = True) -> List[Any]:
        """Blocking read: labels for ``ids`` in order.

        ``reuse=False`` bypasses the cache *reads* entirely — every id is
        re-labeled and charged fresh (method-vs-method benchmarks count every
        invocation) — but results still land in the cache for later
        consumers.
        """
        ids = np.asarray(ids, np.int64).ravel()
        if reuse:
            return self.request(ids, account=account).result()
        with self._lock:
            self.stats["requests"] += len(ids)
        # cache-bypassing reads label OUTSIDE the lock too (same reservation
        # discipline as flush, minus the dedup: every id is re-labeled)
        sp = start_span("broker.fetch_nocache", n=len(ids))
        try:
            labeled, batches = self._label(ids)
        except BaseException as e:
            sp.set(error=f"{type(e).__name__}: {e}").end()
            raise
        sp.set(fresh=len(ids), batches=batches).end()
        with self._lock:
            self.cache.update(labeled)
            self.stats["batches"] += batches
            self.stats["fresh"] += len(ids)
            if account is not None:
                account.fresh += len(ids)
                account.labeled.extend(int(i) for i in ids)
            if len(ids):
                self.stats["flushes"] += 1
            self._notify_fresh(labeled)
            self._cond.notify_all()
            return [self.cache[int(i)] for i in ids]

    def _label(self, ids: np.ndarray) -> Tuple[Dict[int, Any], int]:
        """Label ``ids`` — sharded across the replica pool when one is
        attached, inline microbatches otherwise.  Called WITHOUT the broker
        lock; returns ``({id: annotation}, n_batches)``."""
        pool = self.pool
        if pool is not None and len(ids):
            try:
                return pool.run(ids, self.max_batch)
            except OraclePoolClosed:
                # the pool was closed under us (a concurrent replica-count
                # resize): retry once with the current pool, else inline
                current = self.pool
                if current is not None and current is not pool:
                    return current.run(ids, self.max_batch)
        labeled: Dict[int, Any] = {}
        batches = 0
        for start in range(0, len(ids), self.max_batch):
            chunk = ids[start:start + self.max_batch]
            anns = self.annotate(chunk)
            batches += 1
            for i, a in zip(chunk, anns):
                labeled[int(i)] = a
        return labeled, batches

    # -- drain ---------------------------------------------------------------
    @property
    def n_pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def flush(self, limit: Optional[int] = None) -> int:
        """Label everything pending, in microbatches of ``max_batch``.
        Fresh charges land on the account that enqueued each id.  Returns
        the number of records labeled.

        ``limit`` reserves only the first ``limit`` pending ids (insertion
        order) instead of draining the queue — the scheduler's preemption
        slices flush a long prefetch in bounded steps so a higher-priority
        session can run between them.  Charging is per id, so a limited
        flush sequence is byte-identical in accounting to one full drain.

        Three phases (the reservation scheme): **reserve** — pending ids move
        to the in-flight map under the lock, so concurrent requests dedup
        against them exactly; **label** — outside the lock, inline or sharded
        across the replica pool, so other threads keep enqueueing (and other
        flushes keep labeling) meanwhile; **publish** — results land in the
        cache in pending order under the lock, owners are charged fresh, the
        write-through listeners see one ordered batch, and waiters wake.  If
        labeling fails, the reservation rolls back into the pending queue
        with nothing charged.
        """
        with self._lock:
            if not self._pending:
                return 0
            queued = list(self._pending.items())  # insertion order
            if limit is not None and 0 < limit < len(queued):
                queued = queued[:limit]
                for i, _ in queued:
                    del self._pending[i]
            else:
                self._pending.clear()
            reserved: List[Tuple[int, Optional[OracleAccount]]] = []
            for i, owner in queued:
                # a forced fetch() may have labeled a pending id meanwhile:
                # the enqueuer is served from cache, not charged fresh
                if i in self.cache:
                    if owner is not None and i in owner._credit:
                        owner._credit.discard(i)  # demand read charges cached
                    else:
                        self.stats["cached"] += 1
                        if self._record_hit is not None:
                            self._record_hit(i)  # tier attribution
                        if owner is not None:
                            owner.cached += 1
                else:
                    self._inflight[i] = owner
                    reserved.append((i, owner))
            if not reserved:
                return 0
            ids = np.asarray([i for i, _ in reserved], np.int64)
        # span + histogram cover label->publish; reserve was under the lock.
        # The span is stack-pushed so the pool's oracle.subbatch spans
        # parent under THIS flush — one chain per fresh label.
        t0 = time.perf_counter()
        with span("broker.flush", reserved=len(reserved),
                  limit=limit if limit is not None else 0) as sp:
            try:
                results, batches = self._label(ids)
                missing = [i for i, _ in reserved if i not in results]
                if missing:
                    raise RuntimeError(
                        f"oracle returned no label for {len(missing)} of "
                        f"{len(reserved)} flushed ids")
            except BaseException as e:
                sp.set(error=f"{type(e).__name__}: {e}", fresh=0)
                with self._lock:
                    # roll the reservation back: nothing was published,
                    # nothing is charged, and the ids are pending again for
                    # a retry
                    for i, owner in reserved:
                        self._inflight.pop(i, None)
                        if i not in self.cache and i not in self._pending:
                            self._pending[i] = owner
                    self._cond.notify_all()
                raise
            with self._lock:
                labeled: Dict[int, Any] = {}
                for i, owner in reserved:  # publish in pending order
                    self._inflight.pop(i, None)
                    a = results[i]
                    self.cache[i] = a
                    labeled[i] = a
                    self.stats["fresh"] += 1
                    if owner is not None:
                        owner.fresh += 1
                        owner.labeled.append(i)
                self.stats["batches"] += batches
                self.stats["flushes"] += 1
                self._notify_fresh(labeled)
                self._cond.notify_all()
            sp.set(fresh=len(reserved), batches=batches)
        self._h_flush_latency.observe(time.perf_counter() - t0)
        self._h_flush_size.observe(len(reserved))
        return len(reserved)
