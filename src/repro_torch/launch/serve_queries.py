"""Query server CLI: serve declarative ``QuerySpec`` s over HTTP.

Mounts one or more workloads into a
:class:`~repro_torch.serve.registry.WorkloadRegistry` and starts a
:class:`~repro_torch.serve.server.QueryServer`.  Single-workload (today's form,
unchanged):

    PYTHONPATH=src python -m repro_torch.launch.serve_queries \\
        --workload night-street --n-frames 3000 --quick \\
        --port 8123 --admission-window 0.05 --store /tmp/tasti/ns

Multi-workload: repeat ``--workload NAME=DATASET[:INDEX_STEM]`` (or point
``--manifest`` at a workloads.json, see
:meth:`~repro_torch.serve.registry.WorkloadRegistry.from_manifest`) and route
requests with the client's ``--workload``:

    PYTHONPATH=src python -m repro_torch.launch.serve_queries \\
        --workload video=night-street --workload text=wikisql \\
        --n-frames 600 --quick --port 8123 --store-dir /tmp/tasti/multi

    PYTHONPATH=src python -m repro_torch.serve.client --url http://127.0.0.1:8123 \\
        --workload text \\
        --spec '{"kind": "aggregation", "score": "score_is_select", "err": 0.1}'

Multi-workload mounts load *lazily*: the port binds immediately and each
workload pays its index build/load when the first spec routes to it
(``--preload`` forces everything up front).  With a store stem per workload
(``--store-dir`` names them ``DIR/<name>``), every oracle flush writes
labels through to ``<stem>.labels.json``/``.labels.npz`` — a restarted
server answers repeat queries on every workload with zero fresh target-DNN
invocations.  ``--device`` picks where every mounted index lives and the
kernels run (CUDA by default; ``cpu`` runs the plain PyTorch versions);
without CUDA and without ``--device cpu`` a mount fails.  The process
prints one ``{"serving": ...}`` JSON line when the
port is bound, then blocks until SIGINT or a client POSTs ``/shutdown``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.core.schema import WORKLOAD_NAMES
from repro_torch.obs import Observability
from repro_torch.serve.registry import WorkloadRegistry, WorkloadSpec
from repro_torch.serve.server import QueryServer
from repro_torch.serve.store.format import parse_bytes


def _parse_mounts(args):
    """``--workload`` values -> ``(registry, multi)``.  Each value is either
    a bare dataset name (legacy single-workload; also the mount name) or
    ``NAME=DATASET[:INDEX_STEM]``.  ``multi`` — any named mount or more than
    one — is the one definition both flag validation and the lazy/eager
    startup decision share."""
    values = args.workload or ["night-street"]
    multi = len(values) > 1 or any("=" in v for v in values)
    if args.store and args.store_dir:
        raise SystemExit("--store and --store-dir are exclusive: one stem "
                         "vs one per-workload directory")
    try:
        parse_bytes(args.store_budget)
    except ValueError as e:
        raise SystemExit(f"--store-budget: {e}") from None
    if multi and args.store:
        raise SystemExit("--store is the single-workload form; use "
                         "--store-dir (or a manifest) for per-workload "
                         "stores")
    if multi and args.index:
        raise SystemExit("--index is the single-workload form; use "
                         "NAME=DATASET:INDEX (or a manifest) per workload")
    registry = WorkloadRegistry()
    for value in values:
        name, _, rest = value.partition("=")
        if rest:
            dataset, _, index = rest.partition(":")
        else:
            dataset, index = name, None
        if dataset not in WORKLOAD_NAMES:
            raise SystemExit(
                f"unknown dataset {dataset!r} in --workload {value!r}; "
                f"known: {list(WORKLOAD_NAMES)}")
        if name in registry:
            raise SystemExit(f"workload {name!r} mounted twice")
        if not multi:
            index = index or args.index
        store = args.store if not multi else None
        if args.store_dir:
            store = os.path.join(args.store_dir, name)
        registry.declare(WorkloadSpec(
            name=name, dataset=dataset, n_records=args.n_frames,
            index=index or None, store=store,
            store_budget=args.store_budget, quick=args.quick,
            variant=args.variant, n_train=args.n_train, n_reps=args.n_reps,
            k=args.k, triplet_steps=args.triplet_steps,
            oracle_batch=args.oracle_batch,
            oracle_replicas=args.oracle_replicas,
            oracle_backend=args.oracle_backend, crack=args.crack,
            device=args.device))
    return registry, multi


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="serve declarative QuerySpecs over HTTP, one workload "
                    "or many")
    ap.add_argument("--workload", action="append", default=None,
                    metavar="NAME[=DATASET[:INDEX]]",
                    help="workload to mount (repeatable).  A bare dataset "
                         f"name ({'/'.join(WORKLOAD_NAMES)}) serves one "
                         "workload exactly as before; NAME=DATASET mounts it "
                         "under NAME, with an optional saved-index stem "
                         "after a colon")
    ap.add_argument("--manifest", default=None,
                    help="JSON manifest of workloads to mount (exclusive "
                         "with --workload; see docs/api/serving.md)")
    ap.add_argument("--default-workload", default=None,
                    help="workload unrouted specs execute against "
                         "(default: the first mounted)")
    ap.add_argument("--n-frames", type=int, default=8000)
    ap.add_argument("--index", default=None,
                    help="path stem of a saved index to load (single-"
                         "workload form; use NAME=DATASET:INDEX or the "
                         "manifest otherwise)")
    ap.add_argument("--variant", default="T", choices=["T", "PT"])
    ap.add_argument("--n-train", type=int, default=400)
    ap.add_argument("--n-reps", type=int, default=800)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--triplet-steps", type=int, default=400)
    ap.add_argument("--quick", action="store_true",
                    help="tiny build budgets (smoke tests / CI)")
    ap.add_argument("--preload", action="store_true",
                    help="load every mounted workload before binding the "
                         "port (default: lazy, on first routed spec)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8123,
                    help="0 picks an ephemeral port (printed at startup)")
    ap.add_argument("--admission-window", type=float, default=0.05,
                    help="seconds the first request of a batch waits for "
                         "co-travelers on the same workload to coalesce "
                         "into one session")
    ap.add_argument("--max-workers", type=int, default=4,
                    help="concurrently executing sessions (all workloads)")
    ap.add_argument("--share", action="append", default=None,
                    metavar="NAME=WEIGHT",
                    help="weighted fair share for a mounted workload "
                         "(repeatable; default 1.0 each): among equally "
                         "urgent waiting work the workload with the lowest "
                         "active/share ratio runs next")
    ap.add_argument("--workload-cap", action="append", default=None,
                    metavar="NAME=N",
                    help="hard cap on a workload's concurrently executing "
                         "sessions (repeatable); a capped workload cannot "
                         "monopolize the worker pool")
    ap.add_argument("--no-preempt", action="store_true",
                    help="never pause a running scan for higher-priority "
                         "arrivals (default: preempt at oracle-slice "
                         "boundaries)")
    ap.add_argument("--preempt-slice", type=int, default=None,
                    help="ids per preemption slice (default: each "
                         "workload's oracle microbatch size)")
    ap.add_argument("--oracle-batch", type=int, default=64)
    ap.add_argument("--oracle-replicas", type=int, default=1,
                    help="target-DNN replica workers behind each workload's "
                         "broker microbatcher (one pool per workload, shared "
                         "by its sessions); results are identical at any "
                         "count, flushes overlap across replicas")
    ap.add_argument("--oracle-backend", default="thread",
                    choices=["thread", "process"],
                    help="replica worker kind: threads (default; right when "
                         "the target DNN releases the GIL) or forked worker "
                         "processes (compute-bound pure-Python/numpy "
                         "oracles; see docs/runbook.md)")
    ap.add_argument("--crack", action="store_true",
                    help="engine-level default for the cracking feedback loop")
    ap.add_argument("--device", default="cuda",
                    help="device of every mounted index and of the kernels "
                         "(cuda, or cpu for the plain PyTorch versions)")
    ap.add_argument("--store", default=None,
                    help="path stem for the persistent label store (single-"
                         "workload form; default: the --index stem)")
    ap.add_argument("--store-dir", default=None,
                    help="directory for per-workload label stores, one "
                         "<dir>/<name> stem each (multi-workload form)")
    ap.add_argument("--store-budget", default=None, metavar="BYTES",
                    help="hot-tier byte budget per label store (e.g. "
                         "67108864 or '64m'); labels past it spill to warm "
                         "segment files on disk instead of growing the heap "
                         "(default: unbounded)")
    ap.add_argument("--no-obs", action="store_true",
                    help="disable observability (tracing, /metrics, the "
                         "flight recorder); default: enabled — overhead is "
                         "bounded by the obs_overhead benchmark gate")
    ap.add_argument("--trace-buffer", type=int, default=256,
                    help="completed request traces the flight recorder "
                         "retains for /debug/traces postmortems")
    args = ap.parse_args(argv)

    if args.manifest:
        if args.workload:
            raise SystemExit("--manifest and --workload are exclusive: the "
                             "manifest declares every mount")
        if args.store or args.store_dir or args.index or args.store_budget:
            raise SystemExit("--store/--store-dir/--store-budget/--index "
                             "are exclusive with --manifest: manifest "
                             "entries carry their own index and store "
                             "configuration")
        # silently ignoring a build/oracle flag would let an operator
        # believe it took effect; manifest entries carry these per workload
        overridden = [
            "--" + attr.replace("_", "-")
            for attr in ("n_frames", "variant", "n_train", "n_reps", "k",
                         "triplet_steps", "quick", "oracle_batch",
                         "oracle_replicas", "oracle_backend", "crack",
                         "device")
            if getattr(args, attr) != ap.get_default(attr)]
        if overridden:
            raise SystemExit(
                f"{'/'.join(overridden)} are exclusive with --manifest: "
                "set them per workload in the manifest entries")
        registry = WorkloadRegistry.from_manifest(args.manifest)
        multi = True
    else:
        registry, multi = _parse_mounts(args)
    if args.default_workload:
        try:
            registry.set_default(args.default_workload)
        except KeyError as e:
            raise SystemExit(f"--default-workload: {e.args[0]}") from None

    def parse_pairs(values, flag, cast):
        out = {}
        for value in values or []:
            name, sep, raw = value.partition("=")
            if not sep or not name:
                raise SystemExit(f"{flag} takes NAME=VALUE, got {value!r}")
            if name not in registry:
                raise SystemExit(f"{flag} {value!r}: workload {name!r} is "
                                 f"not mounted ({sorted(registry.names())})")
            try:
                out[name] = cast(raw)
            except ValueError:
                raise SystemExit(
                    f"{flag} {value!r}: bad value {raw!r}") from None
        return out

    shares = parse_pairs(args.share, "--share", float)
    caps = parse_pairs(args.workload_cap, "--workload-cap", int)

    lazy = multi and not args.preload
    if not lazy:
        # single-workload (and --preload) builds up front, exactly as
        # before: a broken index/store fails here, not on the first request
        for name in registry.names():
            try:
                registry.get(name)
            except (ValueError, OSError, RuntimeError) as e:
                raise SystemExit(
                    f"cannot load workload {name!r}: {e}") from None

    obs = Observability(enabled=not args.no_obs,
                        trace_buffer=args.trace_buffer)
    server = QueryServer(registry, host=args.host, port=args.port,
                         admission_window=args.admission_window,
                         max_workers=args.max_workers,
                         shares=shares, workload_caps=caps,
                         preempt=not args.no_preempt,
                         preempt_slice=args.preempt_slice,
                         obs=obs).start()
    # per-workload oracle_replicas/records/store truth lives in describe()
    print(json.dumps({"serving": server.url,
                      "default_workload": registry.default,
                      "workloads": registry.describe()}),
          flush=True)
    # park until a client POSTs /shutdown (or SIGINT); wait() only returns
    # after shutdown fully finished, including the final store saves
    try:
        server.wait()
    except KeyboardInterrupt:
        print("[serve] shutting down", file=sys.stderr)
        server.shutdown()


if __name__ == "__main__":
    main()
