"""Run one cell of the benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``.  The last line
of standard output is the result (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and ``checks``:
each number compared with its limit); the checks are also the last lines
of standard error.  It prints no result and exits with 2 without a CUDA
device, or with fewer than the cell asks for, or without the program, and
with 1 if the run imported JAX, the JAX package or its benchmarks.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: every build and kernel cache inside the checkout, at fixed paths
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.cells import Cell
    from portbench.harness import forbidden_modules, print_result, run_cell

    cell = Cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), torch "
              f"finds {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no result: no program at {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    outcome = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"no result: the run imported {bad}", file=sys.stderr)
        return 1
    print_result(outcome)
    return 0


if __name__ == "__main__":
    sys.exit(main())
