"""The dropless MoE's combine's roofline reader (``moe_combine_roofline``)
against planted traces: its value from two steps of 16 layers of the
kernel, nothing without the kernel (as on a program that combines by the
eager scatter-add), and the kernel's name left out of the experts'
products."""
from __future__ import annotations

import pytest

from portbench_tiny import ROOT  # noqa: F401  (puts the repo on sys.path)

from portbench.cells import Cell
from portbench.harness import Reading, Window
from portbench.trace import Capture

MOE = "moe_prefill_4k.olmoe-1b-7b-0924"
SHAPE = {"batch": 8, "seq": 4096, "heads": 16, "kv_heads": 16,
         "head_dim": 128, "hidden_size": 2048, "n_experts": 64, "top_k": 8,
         "moe_d_ff": 1024, "layers": 16, "peak_seconds_per_unit": 0.087}
MS = 1_000_000
COMBINE = ("void (anonymous namespace)::moe_combine_kernel<__nv_bfloat16>"
           "(__nv_bfloat16 const*, int const*, float const*, __nv_bfloat16*, "
           "long, int, int, int)")
POSITIONS = ("(anonymous namespace)::moe_combine_positions_kernel(long "
             "const*, int*, long)")
GROUPED = ("void cutlass::device_kernel<cutlass::gemm::kernel::"
           "GemmUniversal<cutlass::gemm::GroupProblemShape<...>>>")


class _Driver:
    def shape(self):
        return SHAPE

    def probes(self):
        return {}


def _reading(device, units=2, traced=True):
    cap = Capture(traced)
    cap.device = device
    cap.window_ns = (0, 400 * MS)
    return Reading(cap, Window(units=units, seconds=0.4), _Driver())


#: two steps, each 16 layers of a 0.45 ms combine and its 0.005 ms
#: positions, beside 3 grouped products of 2 ms
DEVICE = [(name, i * MS, dur, "kernel") for i in range(32)
          for name, dur in ((COMBINE, 450_000), (POSITIONS, 5_000),
                            (GROUPED, 2 * MS))]


def test_the_combines_share_of_its_roofline():
    read = Cell(MOE).reader("moe_combine_roofline")
    least = (2 * 32768 * 8 * 2048 + 4 * 32768 * 8
             + 2 * 32768 * 2048) / 3.35e12
    assert least == pytest.approx(0.361e-3, rel=1e-3)
    assert read(_reading(DEVICE)) == pytest.approx(
        100 * 2 * 16 * least / (32 * 455e-6))
    assert 0 < read(_reading(DEVICE)) < 100


def test_nothing_without_the_kernel_or_untraced():
    read = Cell(MOE).reader("moe_combine_roofline")
    eager = [("void at::native::(anonymous namespace)::indexFuncLargeIndex"
              "<...>(...)", 0, 4 * MS, "kernel"), (GROUPED, 5 * MS, 2 * MS,
                                                   "kernel")]
    assert read(_reading(eager)) is None
    assert read(_reading(DEVICE, traced=False)) is None
    assert read(_reading(DEVICE, units=0)) is None


def test_the_combine_is_not_counted_among_the_experts_products():
    cell = Cell(MOE)
    experts = cell.reader("moe_experts_roofline")
    alone = [d for d in DEVICE if d[0] == GROUPED]
    assert experts(_reading(DEVICE)) == pytest.approx(
        experts(_reading(alone)))
    assert experts(_reading([d for d in DEVICE if d[0] != GROUPED])) is None
    assert "moe_combine_roofline" in {m["name"] for m in cell.per_layer}
