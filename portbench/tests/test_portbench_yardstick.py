"""The yardstick: the frozen FLOP count, the rooflines' counts, the trace's
reductions, the records generator and the weights' layouts."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench_tiny import ROOT

from portbench import weights as W
from portbench.cells import Cell
from portbench.flops import dense_decoder_flops
from portbench.harness import Reading, Window
from portbench.records import Records, ar1
from portbench.trace import Capture

PHI3 = json.loads((ROOT / "portbench/configs/phi3-medium-14b.json")
                  .read_text())
TASTI = json.loads((ROOT / "portbench/configs/tasti-night-street-1m.json")
                   .read_text())


def _analytic(c: dict, batch: int, seq: int) -> float:
    from portbench.drivers.prefill import model_config
    from repro_torch.launch.analytic import forward_cost
    return forward_cost(model_config(c), batch, seq).flops


@pytest.mark.parametrize("batch, seq", [(1, 32768), (64, 512), (2, 7)])
def test_frozen_flops_equal_the_ports_forward_cost(batch, seq):
    padded = W.padded_vocab(PHI3)
    assert padded == 32256
    got = dense_decoder_flops(PHI3, batch, seq, padded)
    assert got == pytest.approx(_analytic(PHI3, batch, seq), rel=1e-12)


def test_mfu_counts_the_published_vocabulary():
    full = dense_decoder_flops(PHI3, 1, 32768, W.padded_vocab(PHI3))
    pub = dense_decoder_flops(PHI3, 1, 32768, 32064)
    assert full - pub == 2.0 * 32768 * 5120 * (32256 - 32064)


def test_phi3_configuration_is_the_ports_but_for_the_vocabulary():
    from portbench.drivers.prefill import model_config
    from repro_torch.configs import get_config
    cfg = model_config(PHI3)
    assert cfg == dataclasses.replace(get_config("phi3-medium-14b"),
                                      vocab_size=32064)
    assert 13.9e9 < cfg.param_count() < 14.0e9


def test_embedder_flops_match_a_hand_count():
    from portbench.flops import embedder_flops
    # 2 tokens of 4 features, d 8, 2 heads of 4 (kv 1), d_ff 16, 1 layer,
    # embedding 3: proj_in 2*2*4*8; a token's layer 6*8 + 2*8*8 + 4*8*4
    # + 2*8*8 + 4*2*8 + 6*8*16 + 4*16; proj_out 2*8*3
    e = {"seq_tokens": 2, "d_model": 8, "d_ff": 16, "n_heads": 2,
         "n_kv_heads": 1, "head_dim": 4, "feature_dim": 8, "n_layers": 1,
         "embed_dim": 3}
    layer = 48 + 128 + 128 + 128 + 64 + 768 + 64
    assert embedder_flops(e) == 128 + 2 * layer + 48


def _reader(name):
    return Cell("index_build.tasti-night-street-1m").reader(name) \
        if name in ("fpf_update_roofline", "distance_topk_roofline",
                    "copy_ms_per_build", "device_idle.build", "mfu.build") \
        else Cell("prefill_long.phi3-medium-14b").reader(name)


def _module(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "m", ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_roofline_counts_match_hand_counts():
    # fpf_update: N 10 records of D 4: 3 N D operations; x, the rep and
    # the old distances read, the new written
    assert _module("fpf_update_roofline").ops_bytes(10, 4) == (
        120.0, 4.0 * (40 + 4 + 10 + 10))
    # distance_topk: N 10, C 3, D 4, k 2
    assert _module("distance_topk_roofline").ops_bytes(10, 3, 4, 2) == (
        2.0 * 10 * 3 * 4, 4.0 * (40 + 12) + 8.0 * 20)
    # flash: B 1, S 4, H 2, Hk 1, hd 8: 10 causal pairs a head
    assert _module("flash_attention_roofline.tc").ops_bytes(1, 4, 2, 1, 8) \
        == (4.0 * 8 * 2 * 10, 2.0 * 8 * (2 * 4 * 2 + 2 * 4 * 1))


class _Driver:
    def __init__(self, shape, probes=None):
        self._shape, self._probes = shape, probes or {}

    def shape(self):
        return self._shape

    def probes(self):
        return self._probes


def _capture(device):
    cap = Capture(True)
    cap.device = device
    return cap


def test_readers_against_a_planted_trace():
    # two fpf launches of 1 ms each (0.8 + 0.2 with the finalizer) on
    # 1e6 x 128: bound 520,016,512 B / 3.35 TB/s each
    cap = _capture([
        ("void fpf_update_kernel<float>(...)", 0, 800_000, "kernel"),
        ("fpf_finalize_kernel(...)", 800_000, 200_000, "kernel"),
        ("void fpf_update_kernel<float>(...)", 2_000_000, 800_000, "kernel"),
        ("fpf_finalize_kernel(...)", 2_800_000, 200_000, "kernel"),
        ("Memcpy HtoD (Pageable -> Device)", 3_000_000, 1_000_000, "copy"),
    ])
    r = Reading(cap, Window(units=2, seconds=0.01),
                _Driver({"records": 1_000_000, "embed_dim": 128,
                         "reps": 7000, "k": 8}))
    bound = 4.0 * (1e6 * 128 + 128 + 2e6) / 3.35e12
    assert _reader("fpf_update_roofline")(r) == pytest.approx(
        100 * 2 * bound / 2e-3)
    assert _reader("copy_ms_per_build")(r) == pytest.approx(0.5)
    # busy 3 ms (0-1, 2-4) of a 10 ms window
    assert _reader("device_idle.build")(r) == pytest.approx(70.0)
    assert _reader("distance_topk_roofline")(r) is None


def test_flash_and_mfu_readers():
    s = {"batch": 1, "seq": 32768, "heads": 40, "kv_heads": 10,
         "head_dim": 128, "peak_seconds_per_unit": 1e15 / 989e12}
    cap = _capture([("void flash_tc_kernel<...>", 0, 20_000_000, "kernel"),
                    ("void flash_tc_kernel<...>", 2e7, 20_000_000, "kernel")])
    r = Reading(cap, Window(units=2, seconds=4.0), _Driver(s))
    flops = 4.0 * 128 * 40 * 32768 * 32769 / 2
    assert _reader("flash_attention_roofline.tc")(r) == pytest.approx(
        100 * flops / 989e12 / 0.02)
    assert _reader("mfu.prefill")(r) == pytest.approx(
        100 * 2e15 / (4.0 * 989e12))
    assert _reader("mfu.build")(r) == _reader("mfu.prefill")(r)


def test_busy_time_is_the_union_of_device_intervals():
    cap = _capture([("a_kernel", 0, 10, "kernel"), ("b_kernel", 5, 10, "kernel"),
                    ("Memcpy", 30, 5, "copy")])
    assert cap.busy_intervals() == [(0, 15), (30, 35)]
    assert cap.busy_s() == pytest.approx(20e-9)


def test_idle_gaps_are_named_by_the_host():
    cap = _capture([("a_kernel", 0, 10_000, "kernel"),
                    ("a_kernel", 50_000, 10_000, "kernel")])
    cap.window_ns = (0, 100_000)
    cap.host = [("aten::nonzero", 12_000, 40_000),
                ("cudaMemcpyAsync", 20_000, 30_000)]
    gaps = dict(cap.breakdown()["idle_gaps"])
    # 10-50 us: middle 30 us, inside both, cudaMemcpyAsync the innermost
    assert gaps["cudaMemcpyAsync"] == pytest.approx(40e-6)
    # 60-100 us: nothing open, after the host op that ended last
    assert gaps["host after aten::nonzero"] == pytest.approx(40e-6)
    ops = dict(cap.breakdown()["device_ops"])
    assert ops == {"a_kernel": pytest.approx(20e-6)}


def test_ar1_solves_the_recurrence():
    g = torch.Generator().manual_seed(0)
    e = torch.randn(2500, 3, generator=g, dtype=torch.float64)
    s = torch.randn(3, generator=g, dtype=torch.float64)
    want, y = [], s
    for t in range(len(e)):
        y = 0.97 * y + e[t]
        want.append(y)
    assert torch.allclose(ar1(e, 0.97, s), torch.stack(want), atol=1e-12)


def test_records_repeat_from_the_seed():
    spec = dict(TASTI["records"], n_frames=3000)
    a, b = Records(spec, 2 ** 33 + 5, "cpu"), Records(spec, 2 ** 33 + 5, "cpu")
    assert np.array_equal(a.features, b.features)
    assert not np.array_equal(a.features,
                              Records(spec, 6, "cpu").features)
    scene = a.target_dnn_batch([17])[0]
    assert scene.count == int(a.counts[17])
    assert np.all((scene.boxes >= 0) & (scene.boxes <= 1))


def test_records_have_the_video_workloads_count_statistics():
    """At 20,000 frames, over four seeds each: the share of empty frames
    within 0.08 of VideoWorkload's (both about half: the stationary share
    of a geometric(1/2) - 1 count is 1/2) and the rare share (>= 6
    objects, 1/64 stationary) within 0.012; the features' spread within
    10%."""
    from repro_torch.core.schema import VideoWorkload
    spec = dict(TASTI["records"], n_frames=20000)
    mine = [Records(spec, s, "cpu") for s in range(4)]
    theirs = [VideoWorkload(n_frames=20000, seed=s) for s in range(4)]
    empty = [np.mean([(np.asarray(w.counts) == 0).mean() for w in ws])
             for ws in (mine, theirs)]
    rare = [np.mean([(np.asarray(w.counts) >= 6).mean() for w in ws])
            for ws in (mine, theirs)]
    assert abs(empty[0] - empty[1]) <= 0.08, empty
    assert abs(rare[0] - rare[1]) <= 0.012, rare
    assert 0.4 <= empty[0] <= 0.6 and rare[0] <= 0.04
    std = [np.mean([w.features.std() for w in ws]) for ws in (mine, theirs)]
    assert abs(std[0] / std[1] - 1) <= 0.1, std


def test_weights_layouts_are_the_ports():
    from repro_torch.core.embedder import Embedder, EmbedderConfig
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves_with_names

    from portbench.drivers.prefill import model_config
    e = TASTI["embedder"]
    port = Embedder(EmbedderConfig(feature_dim=64, embed_dim=128,
                                   backbone="tasti-embedder", seq_tokens=8))
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: s for k, (s, _) in W.embedder_layout(e).items()}
    specs = dict(tree_leaves_with_names(lm.model_specs(model_config(PHI3))))
    assert {k: tuple(s.shape) for k, s in specs.items()} == \
        {k: s for k, (s, _) in W.dense_lm_layout(PHI3).items()}
    n = sum(int(np.prod(s)) for s, _ in W.dense_lm_layout(PHI3).values())
    # param_count leaves out the final norm's scale
    assert n == model_config(PHI3).param_count() + PHI3["hidden_size"]


def test_streams_are_apart_and_take_large_seeds():
    seeds = {W.stream_seed(s, salt, u) for s in (0, 1, 2 ** 31 + 9, 2 ** 40)
             for salt in (1, 2) for u in (-1, 0, 1)}
    assert len(seeds) == 4 * 2 * 3
    assert all(0 <= s < 2 ** 63 for s in seeds)
