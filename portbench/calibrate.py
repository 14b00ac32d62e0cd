"""The readings that a cell's limits are set from (not run by the
benchmark's own runs):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

For each seed of ``--seeds`` the program runs the cell's traffic for its
``min_units`` units and the check reads its numbers (the lower readings);
for each of ``--control-seeds`` the reference, put in the program's place
at the precision below the configuration's (``refs.precision.BELOW``),
does the same (the upper readings).  One JSON line a seed and side, then
a summary: each number's largest program reading and smallest control
reading, beside the cell's limits.  ``--out`` also writes the lines there.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(cell, seed: int, device: str, control: bool,
             overrides=None) -> dict:
    """The check's numbers after the traffic's ``min_units`` units on
    ``seed``, of the program or of the control."""
    import torch

    from portbench.harness import make_driver
    from portbench.refs.precision import BELOW
    driver, traffic = make_driver(cell, seed, device, overrides)
    driver.setup()
    units = int(traffic.get("min_units", 1))
    if control:
        # the control stands in for the units the check reads, no others
        driver.precision = BELOW[driver.stated_precision()]
        todo = driver.checked_units(units)
    else:
        todo = range(units)
    for i in todo:
        driver.unit(i)
    driver.free()
    t0 = time.perf_counter()
    out = driver.check(units)
    out["check_s"] = time.perf_counter() - t0
    del driver
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


def summary(lines: list, limits: dict) -> dict:
    names = sorted({k for ln in lines for k in ln["readings"]} - {"check_s"})
    out = {}
    for k in names:
        prog = [ln["readings"][k] for ln in lines if ln["side"] == "program"]
        ctrl = [ln["readings"][k] for ln in lines if ln["side"] == "control"]
        out[k] = {"program_max": max(prog, default=None),
                  "control_min": min(ctrl, default=None),
                  "limit": limits.get(k)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from portbench.cells import Cell
    cell = Cell(args.workload)
    lines = []
    plan = ([("program", int(s)) for s in args.seeds.split(",") if s]
            + [("control", int(s)) for s in args.control_seeds.split(",")
               if s])
    for side, seed in plan:
        t0 = time.perf_counter()
        r = readings(cell, seed, args.device, side == "control")
        ln = {"side": side, "seed": seed, "readings": r,
              "seconds": time.perf_counter() - t0}
        lines.append(ln)
        print(json.dumps(ln), flush=True)
    s = summary(lines, cell.limits)
    print(json.dumps({"summary": s}), flush=True)
    if args.out:
        p = pathlib.Path(args.out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("\n".join(json.dumps(x) for x in lines + [s]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
