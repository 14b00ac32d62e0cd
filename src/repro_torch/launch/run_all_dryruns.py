"""The port's full dry-run sweep, one subprocess per cell in turn.

A process per cell (a dry run owns its process's default process group,
``launch.dryrun``) makes the sweep resumable: cells with an
existing ``ok`` or ``skipped`` JSON are skipped.  Full cells run on both
meshes; block cells (the per-block cost) run single-pod only.

    PYTHONPATH=src python -m repro_torch.launch.run_all_dryruns [--force] [--only substr]
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[3]
OUT_DIR = REPO / "experiments" / "dryrun_torch"


def cells():
    from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, cell_is_runnable
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            for mesh in ("single", "multi"):
                yield (arch, shape.name, mesh, False)
            if cell_is_runnable(arch, shape):
                yield (arch, shape.name, "single", True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    todo = list(cells())
    t_start = time.time()
    for i, (arch, shape, mesh, block) in enumerate(todo):
        tag = f"{arch}__{shape}__{mesh}" + ("__block" if block else "")
        if args.only and args.only not in tag:
            continue
        out = OUT_DIR / f"{tag}.json"
        if out.exists() and not args.force:
            try:
                if json.loads(out.read_text()).get("status") in ("ok", "skipped"):
                    continue
            except (OSError, ValueError):
                pass
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh]
        if block:
            cmd.append("--block")
        t0 = time.time()
        try:
            subprocess.run(cmd, cwd=REPO, timeout=args.timeout,
                           env={**os.environ, "PYTHONPATH": str(REPO / "src")})
        except subprocess.TimeoutExpired:
            out.write_text(json.dumps({
                "arch": arch, "shape": shape, "mesh": mesh, "block": block,
                "status": "error", "error": f"timeout>{args.timeout}s"}))
        print(f"  [{i+1}/{len(todo)}] {tag} ({time.time()-t0:.0f}s, "
              f"total {(time.time()-t_start)/60:.1f}m)", flush=True)


if __name__ == "__main__":
    main()
