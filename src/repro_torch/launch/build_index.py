"""Index-construction CLI: build a TASTI index over a workload and
persist it (versioned JSON + npz; see ``TastiIndex.save``).  The same flags
and JSON as ``repro.launch.build_index``, plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.build_index \\
        --workload night-street --n-frames 8000 --variant T \\
        --out /path/to/index/night_street

The saved index loads in either package's query CLI
(``repro_torch.launch.query``, ``repro.launch.query``).  ``--device`` picks
where training, the embedding passes and the kernels run (CUDA by default;
``cpu`` runs the plain PyTorch versions).  ``--backbone`` is accepted and,
as in the JAX package's CLI, not passed on: the embedder is the MLP.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.core.pipeline import TastiConfig, build_tasti
from repro_torch.core.schema import WORKLOAD_NAMES, make_workload
from repro_torch.core.triplet import TripletConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="night-street",
                    choices=list(WORKLOAD_NAMES))
    ap.add_argument("--n-frames", type=int, default=8000)
    ap.add_argument("--variant", default="T", choices=["T", "PT"])
    ap.add_argument("--n-train", type=int, default=400)
    ap.add_argument("--n-reps", type=int, default=800)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--embed-dim", type=int, default=128)
    ap.add_argument("--triplet-steps", type=int, default=400)
    ap.add_argument("--backbone", default="mlp",
                    help="'mlp' or a config name (e.g. tasti-embedder); "
                         "accepted and not used, as in the JAX package")
    ap.add_argument("--device", default="cuda",
                    help="device of training, embedding and the kernels "
                         "(cuda, or cpu for the plain PyTorch versions)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    wl = make_workload(args.workload, n_records=args.n_frames)
    cfg = TastiConfig(n_train=args.n_train, n_reps=args.n_reps, k=args.k,
                      embed_dim=args.embed_dim,
                      triplet=TripletConfig(steps=args.triplet_steps))
    t0 = time.time()
    system = build_tasti(wl, cfg, variant=args.variant, device=args.device)
    dt = time.time() - t0
    system.index.save(args.out)
    cost = system.index.cost
    print(json.dumps({
        "workload": wl.name,
        "records": len(wl.features),
        "variant": args.variant,
        "reps": system.index.n_reps,
        "k": system.index.k,
        "target_dnn_invocations": cost.target_invocations,
        "modeled_construction_s": round(cost.wall_clock_s(), 1),
        "actual_build_s_cpu": round(dt, 1),
        "out": args.out,
        "format_version": system.index.FORMAT_VERSION,
    }, indent=2))


if __name__ == "__main__":
    main()
