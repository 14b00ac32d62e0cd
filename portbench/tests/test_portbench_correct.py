"""What decides ``correct``, at the cells' small sizes on the CPU: the
program passes the cell's limits, the control (the reference in the
program's place at the precision below the configuration's) fails them,
and so does a run whose timed path is broken underneath, once for each
fault the cell can have."""
from __future__ import annotations

import pytest
import torch

from portbench_tiny import TINY, run

from portbench.calibrate import readings
from portbench.cells import Cell

INDEX = "index_build.tasti-night-street-1m"
PREFILL = "prefill_long.phi3-medium-14b"


def _fails(readings_: dict, limits: dict) -> list:
    return [k for k, lim in limits.items() if not readings_[k] <= lim]


@pytest.mark.parametrize("name", [INDEX, PREFILL])
def test_program_passes_and_control_fails(name):
    cell = Cell(name)
    for seed in (5, 2 ** 31 + 3):
        prog = readings(cell, seed, "cpu", False, TINY[name])
        assert not _fails(prog, cell.limits), prog
        ctrl = readings(cell, seed, "cpu", True, TINY[name])
        assert _fails(ctrl, cell.limits), ctrl


def test_a_whole_run_is_correct():
    out = run(INDEX)
    assert out.result["correct"], out.result
    assert list(out.result)[-1] == "checks"
    assert out.result["attempted"] >= 2


# -- faults planted under the index build ----------------------------------

def _index_altered(driver):
    """An answer altered where it is produced: one record's nearest
    representative swapped for another."""
    unit = driver.unit

    def wrapped(i):
        work = unit(i)
        emb, reps, ann, ids, d2 = driver.outputs[i]
        ids = ids.copy()
        ids[3, 0] = (ids[3, 0] + 1) % len(reps)
        if ids[3, 0] in ids[3, 1:]:
            ids[3, 0] = (ids[3, 0] + 1) % len(reps)
        driver.outputs[i] = (emb, reps, ann, ids, d2)
        return work
    driver.unit = wrapped
    return driver


def _index_stale(driver):
    """A unit that returns another's state: each build made with the
    previous build's weights."""
    build = driver._build
    driver._build = lambda unit: build(unit - 1)
    return driver


def test_index_faults_are_not_correct(monkeypatch):
    from repro_torch.core import pipeline
    assert not run(INDEX, wrap=_index_altered).result["correct"]
    assert not run(INDEX, wrap=_index_stale).result["correct"]
    embed_all = pipeline.embed_all

    def half(model, features, batch=4096):
        """Half of the batch left out: the second half of the records
        takes the first half's embeddings."""
        out = embed_all(model, features, batch)
        n = len(out) // 2
        out[n:2 * n] = out[:n]
        return out
    monkeypatch.setattr(pipeline, "embed_all", half)
    assert not run(INDEX).result["correct"]


# -- faults planted under the prefill --------------------------------------

def _prefill_altered(driver):
    """A token's answer altered where it is produced: the logits of one
    position rolled by one token."""
    unit = driver.unit

    def wrapped(i):
        work = unit(i)
        if driver.kept is not None and i == driver.keep_at:
            driver.kept = driver.kept.clone()
            driver.kept[0, 7] = torch.roll(driver.kept[0, 7], 1)
        return work
    driver.unit = wrapped
    return driver


def _prefill_stale(driver):
    """A unit that returns another's state: each step given the previous
    step's prompt."""
    tokens = driver._tokens

    def wrapped(i):
        saved = driver._tokens
        driver._tokens = lambda unit: tokens(unit - 1)
        try:
            return unit(i)
        finally:
            driver._tokens = saved
    unit = driver.unit
    driver.unit = wrapped
    return driver


def test_prefill_faults_are_not_correct(monkeypatch):
    from repro_torch.models import attention
    assert not run(PREFILL, wrap=_prefill_altered).result["correct"]
    assert not run(PREFILL, wrap=_prefill_stale).result["correct"]
    attend = attention._attend

    def half_keys(q, k, v, causal, window, impl):
        """Half of the keys left out: each query sees only the nearest
        half of the prompt."""
        return attend(q, k, v, causal, q.shape[1] // 2, impl)
    monkeypatch.setattr(attention, "_attend", half_keys)
    assert not run(PREFILL).result["correct"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", [INDEX, PREFILL])
def test_cells_run_correct_on_the_card(card, name):
    """Both cells at their small sizes through the kernels, traced."""
    out = run(name, device=card, trace=True)
    assert out.result["correct"], out.result
    assert out.result["device"]["busy_s"] > 0
