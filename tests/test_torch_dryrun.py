"""The port's dry-run and roofline tooling (``repro_torch.launch.mesh``,
``wire``, ``specs``, ``dryrun``, ``roofline``) against the JAX package's.

One run serves the process-level cases: a JAX child with 512 forced host
devices builds every cell's specs on the production meshes, a JAX child
with 8 compiles 12 smoke cells on a (2, 4) mesh, a port child traces the
same cells on a fake group (and the per-block cases on the (1, 1) host
mesh), and 8 gloo ranks of the port run two of them on real tensors,
counting their collectives.  They start together; the first to fail, or
a 600 s deadline, kills the rest.

* (a) ``make_production_mesh``: the shape and dim names of the JAX
  package's, single and multi.
* (b) every arch x shape x mesh: the full and block cells' argument leaves
  (paths, global shapes, dtypes, PartitionSpecs) equal the JAX package's,
  and each rank-0 local shape equals JAX's ``shard_shape``; the same cells
  are skipped.
* (c) ``model_flops`` and the roofline rows equal the JAX package's on the
  same synthetic dry-run JSONs with its hardware constants (1e-12), but
  for the block scaling, which the port does not apply.
* (d) the ring formulas and the collective counts: ``wire_bytes`` equals
  ``hlo_analysis._wire_bytes``; a synthetic HLO text with a ``while`` of T
  trips around an all-reduce and an all-gather counts as T times the same
  records.
* (e) argument bytes equal XLA's ``argument_size_in_bytes`` exactly; the
  flops, peak and wire bytes are printed beside XLA's (``-s``).
* (f) the fake group's collectives equal what 8 gloo ranks record on real
  tensors, rank 0's, exactly.
* (g) a full cell's flops are affine in the depth: each layer adds the
  block's flops (prefill) or the block's and its weights' gradients'
  (train), exactly.
* (h) prefill on weights placed by the serving rule: at the shipped
  budget, ``qwen3-moe-30b-a3b`` x ``prefill_32k`` on the (2, 4) mesh
  (where ``serve_needs_fsdp`` holds: the weights' width over ``data``)
  builds with the argument leaves of the JAX package's cell on its own
  8-device mesh (specs only); and the smoke prefill cells of
  ``SERVE_FSDP_ARCHS`` with ``HBM_BYTES_BUDGET`` lowered to
  ``SERVE_BUDGET`` in both packages join (e) and (f).
* The kernel's traced path: ``flash_attention`` on fake CUDA tensors.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ASSIGNED_ARCHS, SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.launch import roofline as jax_roofline  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import analytic, roofline, wire  # noqa: E402

pytestmark = pytest.mark.tier1

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
WORLD = 8
#: the (2, 4) cells: smoke configs at 4 x 64 tokens
SMOKE_ARCHS = ("llama3.2-1b", "olmoe-1b-7b", "jamba-1.5-large-398b",
               "seamless-m4t-large-v2")
KINDS = (("train", "train_4k"), ("prefill", "prefill_32k"),
         ("decode", "decode_32k"))
#: the cells the gloo ranks run on real tensors
GLOO_CELLS = (("llama3.2-1b", "prefill"), ("jamba-1.5-large-398b", "train"))
#: the smoke prefill cells built with the serving budget lowered to
#: SERVE_BUDGET (fsdp over data, as serve_needs_fsdp asks), in (e) and (f)
SERVE_FSDP_ARCHS = ("llama3.2-1b", "olmoe-1b-7b")
SERVE_BUDGET = 1024
#: the full-size cell whose specs are held against the JAX package's on
#: the (2, 4) mesh at the shipped budget
SERVE_FULL = ("qwen3-moe-30b-a3b", "prefill_32k")
#: the same cells run by the gloo ranks on real tensors
SERVE_GLOO_CELLS = tuple((a, "prefill_serve_fsdp")
                         for a in SERVE_FSDP_ARCHS)
#: the (1, 1) cells of the per-block identity, at 2 and 3 layers
DEPTHS = (2, 3)
MESHES = ("single", "multi")

_JAX_SPECS = """
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs import ASSIGNED_ARCHS, SHAPES, cell_is_runnable, get_config
from repro.launch import specs as S
from repro.launch.mesh import make_production_mesh

def key(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))

def norm(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

out = {"meshes": {}, "cells": {}, "skipped": []}
for kind in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=kind == "multi")
    out["meshes"][kind] = {"shape": list(mesh.devices.shape),
                           "names": list(mesh.axis_names)}
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            tag = f"{arch}__{shape.name}__{kind}"
            if not cell_is_runnable(arch, shape):
                out["skipped"].append(tag)
                continue
            for block in (False, True):
                build = S.build_block_cell if block else S.build_cell
                cell = build(cfg, shape, mesh)
                leaves = {}
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                        cell.args)[0]:
                    sh = leaf.sharding
                    leaves["/".join(key(k) for k in path)] = [
                        list(leaf.shape), str(leaf.dtype), norm(sh.spec),
                        list(sh.shard_shape(leaf.shape))]
                out["cells"][tag + ("__block" if block else "")] = leaves
json.dump(out, open(sys.argv[1], "w"))
"""

_PORT_SPECS = """
import json, sys
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, cell_is_runnable, get_config
from repro_torch.launch import dryrun, specs as S
from repro_torch.launch.mesh import make_production_mesh

def norm(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def walk(x, path, out):
    if isinstance(x, S.ArgSpec):
        out[path] = [list(x.shape), str(x.dtype).replace("torch.", ""),
                     norm(x.sharding.spec), list(x.local_shape)]
    elif isinstance(x, dict):
        for k in sorted(x):
            walk(x[k], f"{path}/{k}" if path else str(k), out)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            walk(v, f"{path}/{i}" if path else str(i), out)

out = {"meshes": {}, "cells": {}, "skipped": []}
for kind, n in (("single", 256), ("multi", 512)):
    with dryrun.fake_world(n):
        mesh = make_production_mesh(multi_pod=kind == "multi",
                                    device_type="cpu")
        out["meshes"][kind] = {
            "shape": list(mesh.mesh.shape),
            "names": list(mesh.mesh_dim_names),
            "row_major": mesh.mesh.flatten().tolist() == list(range(n))}
        for arch in ASSIGNED_ARCHS:
            cfg = get_config(arch)
            for shape in SHAPES:
                tag = f"{arch}__{shape.name}__{kind}"
                if not cell_is_runnable(arch, shape):
                    out["skipped"].append(tag)
                    continue
                for block in (False, True):
                    build = S.build_block_cell if block else S.build_cell
                    leaves = {}
                    walk(build(cfg, shape, mesh).specs, "", leaves)
                    out["cells"][tag + ("__block" if block else "")] = leaves
json.dump(out, open(sys.argv[1], "w"))
"""

_XLA_CELLS = """
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch import hlo_analysis, specs as S
from repro.configs import SHAPES
from repro.launch.mesh import _make_mesh
from repro.parallel import sharding as shd
archs, kinds = json.loads(sys.argv[2]), json.loads(sys.argv[3])
serve_archs, budget, full = (json.loads(a) for a in sys.argv[4:7])
mesh = _make_mesh((2, 4), ("data", "model"))
jax.set_mesh(mesh)
out = {}

def compile_cell(cfg, kind, name):
    cell = S.build_cell(cfg, ShapeConfig(name, 64, 4, kind), mesh)
    compiled = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                       out_shardings=cell.out_shardings).lower(
        *cell.args).compile()
    ma = compiled.memory_analysis()
    ca = compiled.cost_analysis() or {}
    coll = hlo_analysis.analyze_collectives(compiled.as_text(), 8)
    return {"argument_bytes": ma.argument_size_in_bytes,
            "peak_memory_bytes": ma.peak_memory_in_bytes,
            "flops_per_device": float(ca.get("flops", -1.0)),
            "wire_bytes_per_device": coll["wire_bytes_per_device"],
            "collective_op_counts": coll["op_counts"]}

for arch in archs:
    cfg = get_config(arch).smoke()
    for kind, name in kinds:
        out[f"{arch}/{kind}"] = compile_cell(cfg, kind, name)
shipped = shd.HBM_BYTES_BUDGET
shd.HBM_BYTES_BUDGET = budget
for arch in serve_archs:
    cfg = get_config(arch).smoke()
    assert shd.serve_needs_fsdp(cfg, mesh), arch
    out[f"{arch}/prefill_serve_fsdp"] = compile_cell(cfg, "prefill",
                                                     "prefill_32k")
shd.HBM_BYTES_BUDGET = shipped

def key(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))

def norm(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

arch, shape_name = full
cfg = get_config(arch)
cell = S.build_cell(cfg, next(s for s in SHAPES if s.name == shape_name),
                    mesh)
leaves = {}
for path, leaf in jax.tree_util.tree_flatten_with_path(cell.args)[0]:
    sh = leaf.sharding
    leaves["/".join(key(k) for k in path)] = [
        list(leaf.shape), str(leaf.dtype), norm(sh.spec),
        list(sh.shard_shape(leaf.shape))]
out["serve_full"] = {"leaves": leaves,
                     "serve_needs_fsdp": shd.serve_needs_fsdp(cfg, mesh)}
json.dump(out, open(sys.argv[1], "w"))
"""

_PORT_CELLS = """
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, specs as S
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.configs import SHAPE_BY_NAME
from repro_torch.parallel import sharding as shd
archs, kinds, depths = (json.loads(a) for a in sys.argv[2:5])
serve_archs, budget, full = (json.loads(a) for a in sys.argv[5:8])
out = {"cells": {}, "depth": {}}

def norm(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def walk(x, path, leaves):
    if isinstance(x, S.ArgSpec):
        leaves[path] = [list(x.shape), str(x.dtype).replace("torch.", ""),
                        norm(x.sharding.spec), list(x.local_shape)]
    elif isinstance(x, dict):
        for k in sorted(x):
            walk(x[k], f"{path}/{k}" if path else str(k), leaves)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            walk(v, f"{path}/{i}" if path else str(i), leaves)

with dryrun.fake_world(8):
    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    for arch in archs:
        cfg = get_config(arch).smoke()
        for kind, name in kinds:
            cell = S.build_cell(cfg, ShapeConfig(name, 64, 4, kind), mesh)
            out["cells"][f"{arch}/{kind}"] = dryrun.trace(cell)
    shipped = shd.HBM_BYTES_BUDGET
    shd.HBM_BYTES_BUDGET = budget
    for arch in serve_archs:
        cfg = get_config(arch).smoke()
        assert shd.serve_needs_fsdp(cfg, mesh), arch
        cell = S.build_cell(cfg, ShapeConfig("prefill_32k", 64, 4,
                                             "prefill"), mesh)
        out["cells"][f"{arch}/prefill_serve_fsdp"] = dryrun.trace(cell)
    shd.HBM_BYTES_BUDGET = shipped
    arch, shape_name = full
    cfg = get_config(arch)
    leaves = {}
    walk(S.build_cell(cfg, SHAPE_BY_NAME[shape_name], mesh).specs, "",
         leaves)
    out["serve_full"] = {"leaves": leaves,
                         "serve_needs_fsdp": shd.serve_needs_fsdp(cfg, mesh)}
with dryrun.fake_world(1):
    mesh = make_host_mesh(device_type="cpu")
    for kind, name in kinds[:2]:
        shape = ShapeConfig(name, 64, 4, kind)
        for n in depths:
            cfg = dataclasses.replace(get_config("llama3.2-1b").smoke(),
                                      n_layers=n)
            full = dryrun.trace(S.build_cell(cfg, shape, mesh))
            block = dryrun.trace(S.build_block_cell(cfg, shape, mesh))
            out["depth"][f"{kind}/{n}"] = [full["flops_per_device"],
                                           block["flops_per_device"]]
    # the (1, 1) mesh's step against the same step without a mesh
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train import steps
    cfg = get_config("llama3.2-1b").smoke()
    plain = {"prefill": steps.make_prefill_step(cfg),
             "train": steps.make_train_step(cfg, OptimizerConfig())}
    out["host"] = {}
    for kind, name in kinds[:2]:
        shape = ShapeConfig(name, 64, 4, kind)
        cell = S.build_cell(cfg, shape, mesh)
        got = dryrun.trace(cell)
        cell = S.build_cell(cfg, shape, mesh)
        cell.fn = plain[kind]
        want = dryrun.trace(cell)
        out["host"][kind] = [{k: r[k] for k in (
            "peak_memory_bytes", "flops_per_device", "argument_bytes")}
            for r in (got, want)]
json.dump(out, open(sys.argv[1], "w"))
"""

_GLOO_RANK = """
import datetime, json, sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, path, cells, budget = sys.argv[1:7]
rank, world, budget = int(rank), int(world), int(budget)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import specs as S, wire
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import sharding as shd
mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
names = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k",
         "prefill_serve_fsdp": "prefill_32k"}
shipped = shd.HBM_BYTES_BUDGET
g = torch.Generator().manual_seed(rank)

def real(spec):
    if spec.dtype.is_floating_point:
        return (0.02 * torch.randn(spec.local_shape, generator=g)).to(spec.dtype)
    return torch.zeros(spec.local_shape, dtype=spec.dtype)

out = {}
for arch, kind in json.loads(cells):
    cfg = get_config(arch).smoke()
    shd.HBM_BYTES_BUDGET = budget if kind == "prefill_serve_fsdp" else shipped
    cell = S.build_cell(cfg, ShapeConfig(names[kind], 64, 4,
                                         kind.split("_")[0]), mesh, make=real)
    with wire.count_collectives() as count:
        cell.fn(*cell.args)
    out[f"{arch}/{kind}"] = count.summary()
if rank == 0:
    json.dump(out, open(path, "w"))
dist.destroy_process_group()
"""


def _run_all(tmp, deadline_s=600.0):
    """Starts every child and the gloo ranks together; the first process
    to fail, or the deadline, kills the rest.  Returns {name: (returncode,
    the tail of its stderr)}."""
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    archs, kinds = json.dumps(SMOKE_ARCHS), json.dumps(KINDS)
    serve = [json.dumps(SERVE_FSDP_ARCHS), json.dumps(SERVE_BUDGET),
             json.dumps(SERVE_FULL)]
    commands = {
        "jax_specs": [sys.executable, "-c", textwrap.dedent(_JAX_SPECS),
                      str(tmp / "jax_specs.json")],
        "port_specs": [sys.executable, "-c", textwrap.dedent(_PORT_SPECS),
                       str(tmp / "port_specs.json")],
        "xla_cells": [sys.executable, "-c", textwrap.dedent(_XLA_CELLS),
                      str(tmp / "xla_cells.json"), archs, kinds] + serve,
        "port_cells": [sys.executable, "-c", textwrap.dedent(_PORT_CELLS),
                       str(tmp / "port_cells.json"), archs, kinds,
                       json.dumps(DEPTHS)] + serve}
    for r in range(WORLD):
        commands[f"rank{r}"] = [
            sys.executable, "-c", textwrap.dedent(_GLOO_RANK), str(r),
            str(WORLD), str(tmp / "store"), str(tmp / "gloo.json"),
            json.dumps(GLOO_CELLS + SERVE_GLOO_CELLS), str(SERVE_BUDGET)]
    procs = {}
    for name, cmd in commands.items():
        with open(tmp / f"{name}.err", "w") as err:
            procs[name] = subprocess.Popen(cmd, env=env, stderr=err,
                                           stdout=subprocess.DEVNULL)
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        codes = [p.poll() for p in procs.values()]
        if all(c is not None for c in codes) or any(c for c in codes):
            break
        time.sleep(0.1)
    late = [name for name, p in procs.items() if p.poll() is None]
    for p in procs.values():
        if p.poll() is None:
            p.kill()
    return {name: (p.wait(), ("killed\n" if name in late else "")
                   + (tmp / f"{name}.err").read_text()[-3000:])
            for name, p in procs.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    status = _run_all(tmp)
    failed = {k: v for k, v in status.items() if v[0] != 0}
    assert not failed, failed
    return {name: json.loads((tmp / f"{name}.json").read_text())
            for name in ("jax_specs", "port_specs", "xla_cells",
                         "port_cells", "gloo")}


# ---------------------------------------------------------------------------
# (a), (b): meshes and cell specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
def test_production_mesh_matches_jax(runs, mesh):
    want = runs["jax_specs"]["meshes"][mesh]
    got = runs["port_specs"]["meshes"][mesh]
    assert got["shape"] == want["shape"]
    assert got["names"] == want["names"]
    assert got["row_major"]


def test_skipped_cells_match_jax(runs):
    assert runs["port_specs"]["skipped"] == runs["jax_specs"]["skipped"]


def _runnable_tags():
    from repro.configs import cell_is_runnable
    return [f"{a}__{s.name}__{m}" for a in ASSIGNED_ARCHS for s in SHAPES
            for m in MESHES if cell_is_runnable(a, s)]


@pytest.mark.parametrize("tag", _runnable_tags())
def test_cell_specs_match_jax(runs, tag):
    """Leaf paths, global shapes, dtypes and PartitionSpecs of the full and
    the block cell, and rank 0's local shape against ``shard_shape``."""
    for name in (tag, tag + "__block"):
        want = runs["jax_specs"]["cells"][name]
        got = runs["port_specs"]["cells"][name]
        assert sorted(got) == sorted(want), name
        for path, entry in want.items():
            assert got[path] == entry, (name, path)


# ---------------------------------------------------------------------------
# (c): model flops and the roofline
# ---------------------------------------------------------------------------

JAX_HW = roofline.Hardware(197e12, 819e9, 50e9)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_match_jax(arch):
    from repro_torch.configs import SHAPE_BY_NAME
    for shape in SHAPES:
        assert roofline.model_flops(arch, SHAPE_BY_NAME[shape.name]) == \
            jax_roofline.model_flops(arch, shape)


def _synthetic(tmp, arch, shape, mesh, rng, variant="", overrides=None,
               block=False):
    cfg = jax_get_config(arch)
    d = {"status": "ok", "arch": arch, "shape": shape.name, "mesh": mesh,
         "n_devices": 256 if mesh == "single" else 512,
         "n_repeats": cfg.n_repeats, "overrides": overrides or {},
         "flops_per_device": float(rng.uniform(1e12, 1e15)),
         "bytes_accessed_per_device": float(rng.uniform(1e9, 1e12)),
         "wire_bytes_per_device": float(rng.uniform(1e6, 1e10)),
         "peak_memory_bytes": int(rng.integers(1 << 30, 1 << 36))}
    suffix = ("__block" if block else "") + (f"__{variant}" if variant
                                             else "")
    (tmp / f"{arch}__{shape.name}__{mesh}{suffix}.json").write_text(
        json.dumps(d))
    return d


def _same_row(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-12, abs=0.0), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_roofline_rows_match_jax(tmp_path, monkeypatch, arch, mesh):
    """Every shape, with and without config overrides (a variant): the
    port's row under the JAX package's constants equals the JAX
    package's, key by key."""
    from repro_torch.configs import SHAPE_BY_NAME
    monkeypatch.setattr(jax_roofline, "DRYRUN_DIR", tmp_path)
    monkeypatch.setattr(roofline, "DRYRUN_DIR", tmp_path)
    rng = np.random.default_rng(hash((arch, mesh)) % 2 ** 32)
    for shape in SHAPES:
        _synthetic(tmp_path, arch, shape, mesh, rng)
        _synthetic(tmp_path, arch, shape, mesh, rng, variant="ov",
                   overrides={"remat": "none", "decode_ring": "128"})
        for variant in ("", "ov"):
            want = jax_roofline.analyze_cell(arch, shape, mesh, variant)
            got = roofline.analyze_cell(arch, SHAPE_BY_NAME[shape.name],
                                        mesh, variant, hw=JAX_HW)
            _same_row(got, want)
    want = jax_roofline.full_table(mesh)
    got = roofline.full_table(mesh, hw=JAX_HW)
    for g, w in zip(got, want):
        _same_row(g, w)
    assert len(got) == len(want)


def test_roofline_takes_full_traces_without_block_scaling(tmp_path,
                                                          monkeypatch):
    """With a block JSON the JAX package scales flops, bytes and wire by
    (R - 1) x block; the port's traces hold every layer already, so its row
    takes the full cell's numbers and reports the block's beside them."""
    from repro_torch.configs import SHAPE_BY_NAME
    monkeypatch.setattr(jax_roofline, "DRYRUN_DIR", tmp_path)
    monkeypatch.setattr(roofline, "DRYRUN_DIR", tmp_path)
    rng = np.random.default_rng(0)
    arch, shape = "llama3.2-1b", SHAPES[0]
    full = _synthetic(tmp_path, arch, shape, "single", rng)
    block = _synthetic(tmp_path, arch, shape, "single", rng, block=True)
    want = jax_roofline.analyze_cell(arch, shape, "single")
    got = roofline.analyze_cell(arch, SHAPE_BY_NAME[shape.name], "single",
                                hw=JAX_HW)
    r, chips = full["n_repeats"], full["n_devices"]
    assert want["block_scaled"] and not got["block_scaled"]
    assert want["hlo_flops_global"] == pytest.approx(
        (full["flops_per_device"] + (r - 1) * block["flops_per_device"])
        * chips, rel=1e-12)
    assert got["hlo_flops_global"] == full["flops_per_device"] * chips
    assert got["hlo_bytes_global"] == \
        full["bytes_accessed_per_device"] * chips
    assert got["collective_s"] == \
        full["wire_bytes_per_device"] / JAX_HW.link_bw
    assert got["block_flops_per_device"] == block["flops_per_device"]
    assert got["block_wire_bytes_per_device"] == \
        block["wire_bytes_per_device"]
    scaled = {"block_scaled", "hlo_flops_global", "hlo_bytes_global",
              "hlo_vs_analytic_flops", "collective_s", "dominant",
              "roofline_fraction"}
    _same_row({k: v for k, v in got.items() if k in want and
               k not in scaled},
              {k: v for k, v in want.items() if k not in scaled})


def test_roofline_constants_are_the_h100s():
    assert roofline.H100 == (989.4e12, 3.35e12, 50e9)


# ---------------------------------------------------------------------------
# (d): wire bytes and collective counts
# ---------------------------------------------------------------------------

_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute")


@pytest.mark.parametrize("op", _OPS)
def test_wire_bytes_match_hlo_analysis(op):
    for g in (1, 2, 4, 16, 256):
        for nbytes in (0, 4, 1000, 123456789):
            assert wire.wire_bytes(op, nbytes, g) == \
                hlo_analysis._wire_bytes(op, nbytes, g), (op, g, nbytes)


def test_broadcast_counts_its_result_bytes():
    assert wire.wire_bytes("broadcast", 1000, 1) == 0.0
    assert wire.wire_bytes("broadcast", 1000, 16) == 1000.0


_HLO = """HloModule m

%cond (p: s32[]) -> pred[] {
  %i = s32[] parameter(0)
  %c = s32[] constant(TRIPS)
  ROOT %lt = pred[] compare(%i, %c), direction=LT
}

%body (p: s32[]) -> s32[] {
  %x = f32[1024]{0} parameter(0)
  %ar = f32[1024]{0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%sum
  %ag = bf16[4,256]{1,0} all-gather(%y), replica_groups=[2,4]<=[8], dimensions={0}
  ROOT %n = s32[] add(%i, %one)
}

ENTRY %main (a: s32[]) -> s32[] {
  %t = s32[] parameter(0)
  ROOT %w = s32[] while(%t), condition=%cond, body=%body
}
"""


@pytest.mark.parametrize("trips", [1, 7])
def test_collective_counts_match_hlo_analysis(trips):
    hlo = _HLO.replace("TRIPS", str(trips))
    want = hlo_analysis.analyze_collectives(hlo, default_group=8)
    records = [("all-reduce", 1024 * 4, 4), ("all-gather", 4 * 256 * 2, 4)]
    got = wire.summarize(records * trips)
    assert want["loops"] == {"body": trips}
    assert got["wire_bytes_per_device"] == want["wire_bytes_per_device"]
    assert got["op_counts"] == want["op_counts"]
    assert got["loops"] == {}


# ---------------------------------------------------------------------------
# (e), (f), (g): traced cells against XLA and against real runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [
    (a, k) for a in SMOKE_ARCHS for k, _ in KINDS] + [
    (a, "prefill_serve_fsdp") for a in SERVE_FSDP_ARCHS])
def test_argument_bytes_match_xla(runs, arch, kind):
    """No split of these cells fails to divide a dim, so no argument is
    padded on either side.  ``prefill_serve_fsdp``: the prefill cell with
    the serving budget lowered, its weights' width over ``data`` too."""
    got = runs["port_cells"]["cells"][f"{arch}/{kind}"]
    want = runs["xla_cells"][f"{arch}/{kind}"]
    print(f"{arch} {kind}: flops {got['flops_per_device']:.4g} (XLA "
          f"{want['flops_per_device']:.4g}), peak "
          f"{got['peak_memory_bytes']} (XLA {want['peak_memory_bytes']}), "
          f"wire {got['wire_bytes_per_device']:.0f} (XLA "
          f"{want['wire_bytes_per_device']:.0f}), ops "
          f"{got['collective_op_counts']} (XLA "
          f"{want['collective_op_counts']})")
    assert got["argument_bytes"] == want["argument_bytes"]
    assert got["loop_trip_counts"] == {}


@pytest.mark.parametrize("arch,kind", GLOO_CELLS + SERVE_GLOO_CELLS)
def test_fake_group_collectives_match_gloo_run(runs, arch, kind):
    got = runs["port_cells"]["cells"][f"{arch}/{kind}"]
    want = runs["gloo"][f"{arch}/{kind}"]
    assert want["op_counts"], "the real run recorded no collective"
    assert got["collective_op_counts"] == want["op_counts"]
    assert got["wire_bytes_per_device"] == want["wire_bytes_per_device"]


def _weight_grad_flops(n_tokens: int) -> int:
    """2 x tokens x the elements of one llama layer's matrices: the
    weights' gradients' matmuls (x^T dy), which a train block taken with
    respect to the activations alone does not run."""
    from repro_torch.models import blocks
    cfg = get_config("llama3.2-1b").smoke()
    total = 0
    for tree in blocks.block_specs(cfg):
        stack = [tree]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            elif len(node.shape) >= 2:
                total += int(np.prod(node.shape))
    return 2 * n_tokens * total


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_full_cell_flops_are_n_repeats_blocks_and_the_rest(runs, kind):
    """Every layer is traced: from 2 to 3 layers a prefill grows by its
    block's flops exactly, and the part outside the blocks,
    full - n_repeats x block, is the same at both depths; a train step
    grows by its block's (forward, rematerialised forward, gradient of the
    activations) and its weights' gradients."""
    (f2, b2), (f3, b3) = (runs["port_cells"]["depth"][f"{kind}/{n}"]
                          for n in DEPTHS)
    assert b2 == b3 > 0
    extra = 0 if kind == "prefill" else _weight_grad_flops(4 * 64)
    assert f3 - f2 == b2 + extra
    assert f2 - 2 * (b2 + extra) == f3 - 3 * (b3 + extra)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_host_mesh_step_costs_what_the_step_without_a_mesh_costs(runs,
                                                                  kind):
    """On the (1, 1) mesh the step's peak, flops and argument bytes are
    those of the same step without a mesh, which the card's phases run:
    placing the results as DTensors allocates nothing the trace counts."""
    got, want = runs["port_cells"]["host"][kind]
    assert got == want


def test_serving_prefill_cell_specs_match_jax_at_the_shipped_budget(runs):
    """(h): qwen3-moe-30b-a3b's prefill_32k on (2, 4), where the port's
    cell used to refuse the serving placement: every argument leaf's path,
    global shape, dtype, PartitionSpec and rank-0 local shape equal the
    JAX package's cell's, the weights' width over ``data``."""
    want = runs["xla_cells"]["serve_full"]
    got = runs["port_cells"]["serve_full"]
    assert want["serve_needs_fsdp"] and got["serve_needs_fsdp"]
    assert sorted(got["leaves"]) == sorted(want["leaves"])
    for path, entry in want["leaves"].items():
        assert got["leaves"][path] == entry, path
    assert want["leaves"]["0/embed"][2] == ["model", "data"]


# ---------------------------------------------------------------------------
# The kernel's traced path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,skv,h,hk,hd,dtype,causal,window", [
    (300, 300, 8, 2, 64, torch.bfloat16, True, 0),
    (300, 300, 8, 2, 64, torch.bfloat16, True, 128),
    (24, 24, 4, 4, 32, torch.bfloat16, False, 0),
    (100, 140, 4, 1, 40, torch.float32, False, 0)])
def test_flash_attention_traced_on_fake_cuda_tensors(monkeypatch, s, skv, h,
                                                     hk, hd, dtype, causal,
                                                     window):
    """Under ``FakeTensorMode`` with CUDA tensors: the output's shape and
    dtype, one traced call on ``flash_route``'s path with the analytic
    model's attention flops, nothing launched, nothing built."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    def no_build(*args, **kwargs):
        raise AssertionError("the traced path built or bound a kernel")

    monkeypatch.setattr(_build, "bind", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    before = flash_ops.flash_attention.launches
    with FakeTensorMode(), _build.trace_kernels() as traced, \
            FlopCounterMode(display=False) as counter:
        q = torch.empty(2, s, h, hd, dtype=dtype, device="cuda")
        k = torch.empty(2, skv, hk, hd, dtype=dtype, device="cuda")
        out = flash_ops.flash_attention(q, k, k, causal=causal,
                                        window=window)
        route = flash_ops.flash_route(q, k)
    assert out.shape == q.shape and out.dtype == dtype
    assert out.device.type == "cuda"
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b"),
                              sliding_window=window)
    if s == skv:
        eff = analytic._s_kv_eff(cfg, s, causal)
    else:
        eff = skv
    want = 4.0 * (2 * s) * eff * (h * hd)
    assert len(traced) == 1
    name, path, flops, nbytes = traced[0]
    assert (name, path) == ("flash_attention", route)
    assert flops == want
    assert counter.get_total_flops() == int(want)
    assert nbytes == (2 * q.numel() + 2 * k.numel()) * q.element_size()
    assert flash_ops.flash_attention.launches == before


def test_flash_attention_traced_refuses_grad_as_the_card_does():
    q = torch.empty(1, 64, 2, 32, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    with pytest.raises(RuntimeError, match="grad"):
        flash_ops.flash_attention(q, q.detach(), q.detach())
