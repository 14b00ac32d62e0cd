"""Declarative query CLI: run JSON ``QuerySpec`` s against a TASTI index.

Specs are the engine's JSON form — one query each.  By default the whole
list executes as one :class:`~repro_torch.core.session.QuerySession`: specs over
the same score are planned jointly (propagation once per mode, shared
stratified sample for aggregations), their first samples are prefetched
through the oracle broker in combined microbatches, and the output reports
per-spec *and* session-level label accounting.  ``--isolated`` falls back to
executing specs one-by-one (shared label cache only); with ``--crack``,
every fresh annotation is folded back into the index either way:

    PYTHONPATH=src python -m repro_torch.launch.query \\
        --workload night-street --n-frames 3000 --quick \\
        --spec '{"kind": "aggregation", "score": "score_count", "err": 0.05}' \\
        --spec '{"kind": "limit", "score": "score_rare", "k_results": 5}' \\
        --session-budget 2000 --oracle-batch 64 --crack

Point ``--index`` at a saved index (saved by either package's
``launch.build_index``: the format is shared) to skip construction;
otherwise a TASTI index is built in-process first (``--quick``: tiny
budgets).  ``--device`` picks where the index is built and lives and the
kernels run (CUDA by default; ``cpu`` runs the plain PyTorch versions).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.codec import result_row as _result_row
from repro_torch.core.engine import QueryEngine, QuerySpec
from repro_torch.core.index import TastiIndex
from repro_torch.core.pipeline import build_tasti, cli_tasti_config
from repro_torch.core.queries.registry import registered_kinds
from repro_torch.core.schema import WORKLOAD_NAMES, make_workload
from repro_torch.core.session import QuerySession


def _load_specs(args) -> list:
    raw = []
    if args.specs_file:
        with open(args.specs_file) as f:
            body = json.load(f)
        if not isinstance(body, list):
            raise SystemExit(f"--specs-file must hold a JSON list of specs, "
                             f"got {type(body).__name__}")
        raw.extend(body)
    for s in args.spec or []:
        raw.append(json.loads(s))
    if not raw:
        raise SystemExit("no queries: pass --spec JSON (repeatable) and/or "
                         "--specs-file; known kinds: "
                         f"{registered_kinds()}")
    return [QuerySpec.from_dict(d) for d in raw]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="execute declarative QuerySpecs against a TASTI index")
    ap.add_argument("--workload", default="night-street",
                    choices=list(WORKLOAD_NAMES))
    ap.add_argument("--n-frames", type=int, default=8000,
                    help="records in the (synthetic) workload")
    ap.add_argument("--index", default=None,
                    help="path stem of a saved index to load; omit to build")
    ap.add_argument("--variant", default="T", choices=["T", "PT"])
    ap.add_argument("--n-train", type=int, default=400)
    ap.add_argument("--n-reps", type=int, default=800)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--triplet-steps", type=int, default=400)
    ap.add_argument("--quick", action="store_true",
                    help="tiny build budgets (smoke tests / CI)")
    ap.add_argument("--crack", action="store_true",
                    help="fold every query's fresh annotations back into the "
                         "index (cracking feedback loop, paper §3.3)")
    ap.add_argument("--isolated", action="store_true",
                    help="execute specs one-by-one instead of as a jointly-"
                         "planned session (shared label cache only)")
    ap.add_argument("--session-budget", type=int, default=None,
                    help="combined worst-case oracle budget for the session "
                         "(allocated across specs at plan time)")
    ap.add_argument("--oracle-batch", type=int, default=64,
                    help="max ids per target_dnn_batch microbatch issued by "
                         "the oracle broker")
    ap.add_argument("--oracle-replicas", type=int, default=1,
                    help="target-DNN replica workers behind the broker's "
                         "microbatcher; results are identical at any count, "
                         "flushes overlap across replicas")
    ap.add_argument("--oracle-backend", default="thread",
                    choices=["thread", "process"],
                    help="replica worker kind: threads (GIL-releasing "
                         "targets) or forked worker processes (compute-"
                         "bound oracles; see docs/runbook.md)")
    ap.add_argument("--device", default="cuda",
                    help="device of the index and the kernels (cuda, or cpu "
                         "for the plain PyTorch versions)")
    ap.add_argument("--save-index", default=None,
                    help="path stem to persist the (possibly cracked) index")
    ap.add_argument("--spec", action="append",
                    help="QuerySpec as JSON (repeatable, run in order)")
    ap.add_argument("--specs-file", default=None,
                    help="file holding a JSON list of QuerySpecs")
    args = ap.parse_args(argv)
    if args.isolated and args.session_budget is not None:
        ap.error("--session-budget needs session planning; drop --isolated")

    specs = _load_specs(args)
    wl = make_workload(args.workload, n_records=args.n_frames)

    if args.index:
        index = TastiIndex.load(args.index, device=args.device)
        if index.n_records != len(wl.features):
            raise SystemExit(
                f"index covers {index.n_records} records but workload "
                f"{wl.name} has {len(wl.features)}; pass matching --n-frames")
    else:
        cfg = cli_tasti_config(args.quick, n_train=args.n_train,
                               n_reps=args.n_reps, k=args.k,
                               triplet_steps=args.triplet_steps)
        index = build_tasti(wl, cfg, variant=args.variant,
                            device=args.device).index

    engine = QueryEngine(index, wl, crack=args.crack,
                         max_oracle_batch=args.oracle_batch,
                         oracle_replicas=args.oracle_replicas,
                         oracle_backend=args.oracle_backend)
    session_stats = None
    rows = []
    if args.isolated:
        for spec in specs:
            rows.append(_result_row(engine.execute(spec)))
    else:
        out = QuerySession(engine, specs,
                           budget=args.session_budget).execute()
        rows = [_result_row(r) for r in out.results]
        session_stats = {**out.stats, "trace": out.plan.trace}

    if args.save_index:
        index.save(args.save_index)

    print(json.dumps({
        "workload": wl.name,
        "records": index.n_records,
        "reps": index.n_reps,
        "index_version": index.version,
        "engine": engine.stats,
        "broker": engine.broker.stats,
        "session": session_stats,
        "results": rows,
    }, indent=2))


if __name__ == "__main__":
    main()
