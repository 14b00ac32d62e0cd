"""The mixture-of-experts prefill cell at a small size on the CPU: the
program passes the cell's limits, and the control and each planted fault
(the capacity-dropping dispatch in the dropless one's place, one expert's
rows left out, the previous unit's prompts, a routing the reference
cannot replay) fail them; its FLOP count against a hand count; its
readers against planted traces and spans."""
from __future__ import annotations

import dataclasses
import json
import time

import pytest
import torch

from portbench_tiny import ROOT

from portbench.calibrate import readings
from portbench.cells import Cell
from portbench.harness import Reading, Window, run_cell
from portbench.trace import Capture

MOE = "moe_prefill_4k.olmoe-1b-7b-0924"
#: the cell cut to what a CPU test holds: every kind of leaf, 8 experts
#: of which 2 a token, 2 prompts of 64 tokens
TINY = {"config": {"num_hidden_layers": 2, "hidden_size": 128,
                   "num_attention_heads": 4, "num_key_value_heads": 4,
                   "head_dim": 32, "intermediate_size": 64, "num_experts": 8,
                   "num_experts_per_tok": 2, "vocab_size": 300},
        "traffic": {"batch": 2, "seq_len": 64}}
OLMOE = json.loads((ROOT / "portbench/configs/olmoe-1b-7b-0924.json")
                   .read_text())


def _run(wrap=None, seed=2 ** 31 + 11):
    return run_cell(Cell(MOE), seed, 0.05, False, "cpu", time.perf_counter(),
                    overrides=TINY, wrap=wrap)


def _fails(readings_: dict, limits: dict) -> list:
    return [k for k, lim in limits.items() if not readings_[k] <= lim]


def test_program_passes_and_control_fails():
    cell = Cell(MOE)
    for seed in (5, 2 ** 31 + 3):
        prog = readings(cell, seed, "cpu", False, TINY)
        assert not _fails(prog, cell.limits), prog
        ctrl = readings(cell, seed, "cpu", True, TINY)
        assert _fails(ctrl, cell.limits), ctrl


def test_a_whole_run_is_correct():
    out = _run()
    assert out.result["correct"], out.result
    assert out.result["attempted"] >= 4
    assert set(out.result["metrics"]) == {"prefill_tokens_per_s", "setup_s"}


def _capacity_path(driver):
    """The GShard dispatch, which drops the choices past an expert's
    capacity, in the dropless one's place."""
    from repro_torch.train.steps import make_prefill_step
    setup = driver.setup

    def wrapped():
        setup()
        driver.step = make_prefill_step(dataclasses.replace(
            driver.cfg, moe_dropless=False))
    driver.setup = wrapped
    return driver


def _stale(driver):
    """Each step given the previous step's prompts."""
    unit, tokens = driver.unit, driver._tokens

    def wrapped(i):
        driver._tokens = lambda u: tokens(u - 1)
        try:
            return unit(i)
        finally:
            driver._tokens = tokens
    driver.unit = wrapped
    return driver


def test_faults_are_not_correct(monkeypatch):
    from repro_torch.models import moe
    assert not _run(wrap=_capacity_path).result["correct"]
    assert not _run(wrap=_stale).result["correct"]
    grouped = moe._grouped_swiglu

    def first_expert_left_out(params, xs, ends):
        out = grouped(params, xs, ends)
        out[:int(ends[0])] = 0
        return out
    monkeypatch.setattr(moe, "_grouped_swiglu", first_expert_left_out)
    assert not _run().result["correct"]


def _unrecorded(driver):
    """A program that hands over no routing for the kept unit."""
    unit = driver.unit

    def wrapped(i):
        work = unit(i)
        if i == driver.keep_at:
            driver.kept_routing = driver.kept_routing[1:]
        return work
    driver.unit = wrapped
    return driver


def test_a_routing_the_reference_cannot_replay_is_not_correct():
    out = _run(wrap=_unrecorded)
    assert not out.result["correct"]
    assert out.result["checks"]["route_gap"]["value"] == "inf"


def test_configuration_is_the_ports_published_olmoe():
    from portbench.drivers.moe_prefill import model_config
    from portbench.refs.moe_lm import layout
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves_with_names
    cfg = model_config(OLMOE)
    assert cfg == get_config("olmoe-1b-7b-0924")
    specs = dict(tree_leaves_with_names(lm.model_specs(cfg)))
    assert {k: tuple(s.shape) for k, s in specs.items()} == \
        {k: s for k, (s, _) in layout(OLMOE).items()}
    with pytest.raises(ValueError, match="as published"):
        model_config(dict(OLMOE, norm_topk_prob=True))


def test_flops_match_a_hand_count():
    from portbench.drivers.moe_prefill import moe_decoder_flops
    # 1 layer, 1 prompt of 3 tokens, d 8, 2 heads of 4 (kv 2), 4 experts
    # of width 6, 2 a token, vocabulary 10: a token's layer 6*8 (norms,
    # residuals) + 2*(8+8) (q/k norms) + 2*8*8 + 4*8*8 + 2*8*8 (q, k, v,
    # out) + 2*8*4 (router) + 2*(6*8*6 + 4*6 + 2*8) (its 2 rows); the
    # scores and P.V 4*2*8 at 2 keys a query; unembedding 2*8*10
    c = {"hidden_size": 8, "intermediate_size": 6, "num_experts": 4,
         "head_dim": 4, "num_experts_per_tok": 2, "num_attention_heads": 2,
         "num_key_value_heads": 2, "num_hidden_layers": 1}
    token = 48 + 32 + 128 + 256 + 128 + 64 + 2 * (288 + 24 + 16)
    assert moe_decoder_flops(c, 1, 3, 10) == 3 * token + 4 * 3 * 2 * 8 \
        + 3 * 160
    # the published step: 86 TFLOP, the experts' products 53
    full = moe_decoder_flops(OLMOE, 8, 4096, 50304)
    assert 85.5e12 < full < 87e12
    assert 6 * 32768 * 8 * 2048 * 1024 * 16 == pytest.approx(52.8e12,
                                                             rel=1e-3)


class _Driver:
    def __init__(self, shape):
        self._shape = shape

    def shape(self):
        return self._shape

    def probes(self):
        return {}


SHAPE = {"batch": 8, "seq": 4096, "heads": 16, "kv_heads": 16,
         "head_dim": 128, "hidden_size": 2048, "n_experts": 64, "top_k": 8,
         "moe_d_ff": 1024, "layers": 16, "peak_seconds_per_unit": 0.087}
MS = 1_000_000
GROUPED = ("void cutlass::device_kernel<cutlass::gemm::kernel::"
           "GemmUniversal<cutlass::gemm::GroupProblemShape<...>>>")


def _reading(device, units=2, window_ns=(0, 400 * MS)):
    cap = Capture(True)
    cap.device = device
    cap.window_ns = window_ns
    return Reading(cap, Window(units=units, seconds=0.4), _Driver(SHAPE))


def test_readers_against_a_planted_trace():
    cell = Cell(MOE)
    # two steps, each 16 layers of 3 grouped products of 2 ms
    dev = [(GROUPED, i * MS, 2 * MS, "kernel") for i in range(96)]
    dev += [("void at::native::(anonymous namespace)::cunn_SoftMaxForward"
             "<8, float>(...)", 300 * MS, 5 * MS, "kernel"),
            ("void at::native::(anonymous namespace)::indexFuncLargeIndex"
             "<...>(...)", 310 * MS, 3 * MS, "kernel"),
            ("void at::native::vectorized_elementwise_kernel<...>",
             320 * MS, 7 * MS, "kernel")]
    r = _reading(dev)
    flops = 6.0 * 32768 * 8 * 2048 * 1024
    least = max(flops / 989e12,
                2.0 * (3 * 64 * 2048 * 1024 + 2 * 32768 * 2048) / 3.35e12)
    assert cell.reader("moe_experts_roofline")(r) == pytest.approx(
        100 * 2 * 16 * least / 0.192)
    # softmax and the scatter, 8 ms over 2 steps; the elementwise pass is
    # not the dispatch's alone
    assert cell.reader("moe_dispatch_ms.prefill")(r) == pytest.approx(4.0)
    bare = _reading([d for d in dev if "Group" not in d[0]])
    assert cell.reader("moe_experts_roofline")(bare) is None


def _span(name, a_ms, b_ms):
    return {"name": name, "start_ns": int(a_ms * MS), "end_ns": int(b_ms * MS),
            "attrs": {}}


def test_host_time_inside_the_moe_spans():
    read = Cell(MOE).reader("moe_host_ms.prefill")
    r = _reading([(GROUPED, 0, 400 * MS, "kernel")])
    spans = [_span("lm.forward", 10, 110), _span("moe.forward", 20, 23),
             _span("moe.forward", 50, 55), _span("lm.forward", 200, 300),
             _span("moe.forward", 210, 212)]
    assert read(r, spans) == pytest.approx(5.0)
    assert read(r, [s for s in spans if s["name"] == "lm.forward"]) is None
    untraced = _reading([(GROUPED, 0, 400 * MS, "kernel")])
    untraced.capture.enabled = False
    assert read(untraced, spans) is None


@pytest.mark.cuda
def test_the_cell_runs_correct_on_the_card():
    """The cell at its small size through the port's kernels and the
    grouped products, traced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run_cell(Cell(MOE), 7, 0.05, True, "cuda", time.perf_counter(),
                   overrides=TINY)
    assert out.result["correct"], out.result
    assert "moe_experts_roofline" in out.result["metrics"]
