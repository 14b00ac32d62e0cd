"""A run imports neither JAX nor the JAX package, compared by whole
top-level names, and gives no result without a CUDA device."""
from __future__ import annotations

import subprocess
import sys

import pytest

from portbench_tiny import ROOT

from portbench.harness import forbidden_modules


@pytest.mark.parametrize("modules, found", [
    ({"jax", "jax.numpy"}, ["jax"]),
    ({"jaxlib.xla_client"}, ["jaxlib"]),
    ({"flax.linen"}, ["flax"]),
    ({"repro", "repro.core.index"}, ["repro"]),
    ({"benchmarks.common"}, ["benchmarks"]),
    ({"repro_torch", "repro_torch.core.index", "reprox", "jaxtyping"}, []),
    ({"torch", "numpy", "portbench.harness"}, []),
])
def test_forbidden_modules_compares_whole_top_level_names(modules, found):
    assert forbidden_modules(modules) == found


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
         f"{str(ROOT / 'src')!r}]\n{code}\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_the_references_import_neither_the_program_nor_jax():
    mods = _modules_after("import portbench.refs.tasti, "
                          "portbench.refs.dense_lm, portbench.records, "
                          "portbench.weights, portbench.flops")
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_the_harness_and_drivers_load_no_jax():
    mods = _modules_after(
        "import portbench.harness, portbench.cells, portbench.trace, "
        "portbench.drivers.index_build, portbench.drivers.prefill\n"
        "import repro_torch.core.pipeline, repro_torch.train.steps")
    assert not mods & {"repro", "jax", "jaxlib", "flax", "benchmarks"}


def test_a_run_without_cuda_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "index_build.tasti-night-street-1m", "--seed", "1", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def _run_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "portbench_run", ROOT / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("imported, rc", [(None, 0), ("jax", 1),
                                          ("repro", 1), ("repro_torch", 0)])
def test_main_prints_no_result_after_a_forbidden_import(monkeypatch, capsys,
                                                        imported, rc):
    """``main`` checks ``sys.modules`` once the run is over, in the process
    that prints the result (the run itself stood in for)."""
    import types

    import torch

    from portbench import harness
    run = _run_module()
    for var in run.CACHES:
        monkeypatch.setenv(var, "unchanged")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    outcome = harness.Outcome({"correct": True}, [])
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: outcome)
    for name in list(sys.modules):          # what earlier tests loaded
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    if imported:
        monkeypatch.setitem(sys.modules, imported,
                            types.ModuleType(imported))
    assert run.main(["--workload", "index_build.tasti-night-street-1m",
                     "--seed", "1", "--seconds", "1"]) == rc
    out = capsys.readouterr()
    assert (out.out == "") == (rc != 0)
    if rc:
        assert imported in out.err
