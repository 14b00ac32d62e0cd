"""The benchmark is driven by data: every cell of BENCHMARK.json resolves
to its files by name, and a new cell, traffic mix and metric need only new
files and entries."""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench_tiny import ROOT

from portbench.cells import Cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_to_its_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert w["name"] == f"{w['traffic']}.{w['config']}"
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
    for name in CELLS + names:
        assert NAME.match(name)
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_every_file_by_name(name):
    import importlib
    cell = Cell(name)
    importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    assert cell.traffic["rate_metric"] in {m["name"] for m in cell.end_to_end}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))
    assert cell.limits and all(isinstance(v, (int, float))
                               for v in cell.limits.values())


def _tree_hashes(root):
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A throwaway cell (a small dense configuration, a traffic mix and a
    metric of its own) added to a copy of the benchmark by new files and
    new entries alone runs, and no file of the copy changed."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_hashes(tmp_path / "portbench")
    phi3 = json.loads((ROOT / "portbench/configs/phi3-medium-14b.json")
                      .read_text())
    tiny = dict(phi3, name="tiny-dense", num_hidden_layers=2,
                hidden_size=128, num_attention_heads=2,
                num_key_value_heads=1, head_dim=64, intermediate_size=256,
                vocab_size=300)
    new = {
        "configs/tiny-dense.json": json.dumps(tiny),
        "traffic/prefill_tiny.json": json.dumps(
            {"driver": "prefill", "loop": "closed", "clients": 1,
             "batch": 2, "seq_len": 64, "rate_metric": "tiny_tokens_per_s",
             "min_units": 2}),
        "metrics/units_done.py":
            "def read(r):\n    return float(r.window.units)\n",
        "limits/prefill_tiny.tiny-dense.json": json.dumps(
            {"logits_rel_rms": 0.05, "argmax_gap": 0.2}),
    }
    for rel, text in new.items():
        (tmp_path / "portbench" / rel).write_text(text)
    spec = json.loads(json.dumps(SPEC))
    cell = "prefill_tiny.tiny-dense"
    spec["configs"].append({"name": "tiny-dense", "source": "test",
                            "file": "portbench/configs/tiny-dense.json",
                            "reduced": phi3["reduced"], "why": "test"})
    spec["workloads"].append({"name": cell, "config": "tiny-dense",
                              "traffic": "prefill_tiny", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "tiny_tokens_per_s",
                               "unit": "tokens/s", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": [cell]})
    spec["per_layer"].append({"name": "units_done", "unit": "units",
                              "better": "higher", "source": "host_clock",
                              "layer": "Model step",
                              "moves": "tiny_tokens_per_s",
                              "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _tree_hashes(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / 'src')!r}]\n"
        "from portbench.cells import Cell\n"
        "from portbench.harness import run_cell\n"
        f"c = Cell({cell!r})\n"
        "for trace in (False, True):\n"
        "    out = run_cell(c, 3, 0.01, trace, 'cpu', time.perf_counter())\n"
        "    print(json.dumps(out.result))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    plain, traced = [json.loads(x) for x in proc.stdout.splitlines()[-2:]]
    assert plain["correct"] and traced["correct"], proc.stdout
    assert set(plain["metrics"]) == {"tiny_tokens_per_s", "setup_s"}
    assert traced["metrics"]["units_done"]["value"] >= 2
    assert traced["attempted"] >= 2
