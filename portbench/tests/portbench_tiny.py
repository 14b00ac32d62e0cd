"""Small sizes of the benchmark's cells for the CPU tests, and a run of a
cell at them."""
from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: each cell's configuration and traffic cut to what a CPU test holds;
#: every width the embedder has is kept, the decoder's shrink
TINY = {
    "index_build.tasti-night-street-1m": {
        "config": {"records": {"n_frames": 1024},
                   "tasti": {"n_reps": 24}}},
    "prefill_long.phi3-medium-14b": {
        "config": {"num_hidden_layers": 2, "hidden_size": 256,
                   "num_attention_heads": 4, "num_key_value_heads": 2,
                   "head_dim": 64, "intermediate_size": 512,
                   "vocab_size": 500},
        "traffic": {"seq_len": 128}},
}


def run(name: str, seed: int = 2 ** 31 + 11, wrap=None, device="cpu",
        trace: bool = False):
    """One run of cell ``name`` at its small size (``harness.Outcome``)."""
    from portbench.cells import Cell
    from portbench.harness import run_cell
    return run_cell(Cell(name), seed, 0.05, trace, device,
                    time.perf_counter(), overrides=TINY[name], wrap=wrap)
