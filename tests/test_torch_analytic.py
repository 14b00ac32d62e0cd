"""The port's analytic cost model (``repro_torch.launch.analytic``)
against the JAX package's: FLOPs and bytes of every registered config at
every shape, and of the two-tier decode cache, equal to the last bit (the
same arithmetic in the same order)."""
import dataclasses

import pytest

from repro.configs import _REGISTRY as JAX_REGISTRY
from repro.configs import SHAPES as JAX_SHAPES
from repro.launch import analytic as jax_analytic
from repro_torch.configs import SHAPE_BY_NAME, get_config
from repro_torch.launch import analytic

pytestmark = pytest.mark.tier1

CELLS = [(arch, shape.name, 0) for arch in sorted(JAX_REGISTRY)
         for shape in JAX_SHAPES]
# the two-tier decode cache, at repro_torch/launch/roofline.py's default
# ring of 256
RING_CELLS = [("phi3-medium-14b", "decode_32k", 256),
              ("h2o-danube-3-4b", "decode_32k", 256),
              ("h2o-danube-3-4b", "long_500k", 256)]


@pytest.mark.parametrize("arch,shape,ring", CELLS + RING_CELLS)
def test_analytic_cost_matches_jax(arch, shape, ring):
    cfg = dataclasses.replace(get_config(arch), decode_ring=ring)
    cfg_j = dataclasses.replace(JAX_REGISTRY[arch], decode_ring=ring)
    shape_j = next(s for s in JAX_SHAPES if s.name == shape)
    got = analytic.cell_cost(cfg, SHAPE_BY_NAME[shape])
    want = jax_analytic.cell_cost(cfg_j, shape_j)
    assert (got.flops, got.bytes) == (want.flops, want.bytes)
    assert got.flops > 0 and got.bytes > 0
    if ring:
        masked = analytic.cell_cost(get_config(arch), SHAPE_BY_NAME[shape])
        assert got.flops == masked.flops and got.bytes < masked.bytes
