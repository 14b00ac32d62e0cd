"""The port's mesh layer (``repro_torch.parallel``, ``optim.compression``,
``runtime.elastic``, ``launch.mesh``, the sequence-parallel attention and
forward, sharded restore) against the JAX package on the CPU.

* The sharding rules on the JAX package's shape-only stand-ins of the
  16x16 and 2x16x16 production meshes: equal as tuples, for every arch.
* Compression in-process: bitwise on the codes and the scale.
* The mesh runs: one JAX child process with 8 forced host devices (as
  ``tests/test_multidevice.py`` runs them) and, beside it, one run of 8
  gloo ranks of the port (a process each, their group on a ``file://``
  store under the test's temporary directory, a 60 s group timeout; the
  first process to fail, or a 150 s deadline, kills the rest).  Both
  write npz files; the tests below compare them.
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer  # noqa: E402,E501
from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models.common import abstract_params as jax_abstract  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro.models.common import is_spec_leaf  # noqa: E402
from repro.optim import compression as jax_comp  # noqa: E402
from repro.optim.adamw import OptimizerConfig as JaxOpt  # noqa: E402
from repro.optim.adamw import opt_state_specs as jax_opt_state_specs  # noqa: E402,E501
from repro.parallel import sharding as jax_shd  # noqa: E402
from repro.runtime.elastic import choose_mesh_shape as jax_choose  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import (abstract_params,  # noqa: E402
                                       tree_leaves_with_names)
from repro_torch.optim import compression  # noqa: E402
from repro_torch.optim.adamw import OptimizerConfig  # noqa: E402
from repro_torch.optim.adamw import opt_state_specs  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.runtime.elastic import choose_mesh_shape  # noqa: E402

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
STRATEGIES = ("megatron", "pure_dp", "seq_dp", "ep_seq")


class FakeMesh:
    """Shape-only stand-in for a production mesh (no devices), as
    ``tests/test_sharding_rules.py`` has it."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = (FakeMesh({"data": 16, "model": 16}),
          FakeMesh({"pod": 2, "data": 16, "model": 16}))


def _jax_named(tree):
    """(name, leaf) pairs of a JAX tree, named as the port names them."""
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
        or is_spec_leaf(x))[0]
    return [("/".join(key(k) for k in path), leaf) for path, leaf in flat]


def _specs_as_tuples(pairs):
    return [(n, tuple(p)) for n, p in pairs]


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_config(arch), **kw),
            dataclasses.replace(jax_get_config(arch), **kw))


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_pspecs_match_jax(arch, strategy):
    cfg, cfg_j = _cfgs(arch, shard_strategy=strategy)
    specs, specs_j = lm.model_specs(cfg), jax_lm.model_specs(cfg_j)
    for mesh in MESHES:
        for fsdp in (None, False, True):
            got = tree_leaves_with_names(shd.param_pspecs(specs, cfg, mesh,
                                                          fsdp))
            want = _jax_named(jax_shd.param_pspecs(specs_j, cfg_j, mesh,
                                                   fsdp))
            assert _specs_as_tuples(got) == _specs_as_tuples(want)
        assert _specs_as_tuples(tree_leaves_with_names(
            shd.opt_pspecs(specs, cfg, mesh))) == _specs_as_tuples(
            _jax_named(jax_shd.opt_pspecs(specs_j, cfg_j, mesh)))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_pspecs_match_jax(arch):
    for ring in (0, 256):
        cfg, cfg_j = _cfgs(arch, decode_ring=ring)
        for batch, seq in ((128, 32768), (1, 524288)):
            cross = 4096 if cfg.encoder_decoder else 0
            for mesh in MESHES:
                got = shd.cache_pspecs(lm.cache_specs(cfg, batch, seq, cross),
                                       cfg, mesh, global_batch=batch)
                want = jax_shd.cache_pspecs(
                    jax_lm.cache_specs(cfg_j, batch, seq, cross), cfg_j,
                    mesh, global_batch=batch)
                assert _specs_as_tuples(tree_leaves_with_names(got)) == \
                    _specs_as_tuples(_jax_named(want))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_serve_needs_fsdp_and_abstract_specs_match_jax(arch):
    cfg, cfg_j = _cfgs(arch)
    for mesh in MESHES:
        assert shd.serve_needs_fsdp(cfg, mesh) == \
            jax_shd.serve_needs_fsdp(cfg_j, mesh)
    specs, specs_j = lm.model_specs(cfg), jax_lm.model_specs(cfg_j)
    got = [(n, tuple(t.shape), str(t.dtype).replace("torch.", ""),
            t.device.type) for n, t in tree_leaves_with_names(
                abstract_params(specs))]
    want = [(n, tuple(s.shape), str(s.dtype), "meta")
            for n, s in _jax_named(jax_abstract(specs_j))]
    assert got == want
    for dtype in ("float32", "bfloat16"):
        mo = opt_state_specs(specs, OptimizerConfig(state_dtype=dtype))
        mo_j = jax_opt_state_specs(specs_j, JaxOpt(state_dtype=dtype))
        assert mo["step"] is None and mo_j["step"] is None
        for key in ("mu", "nu"):
            assert [(n, s.shape, s.logical_axes,
                     str(s.dtype).replace("torch.", ""), s.init,
                     s.init_scale)
                    for n, s in tree_leaves_with_names(mo[key])] == \
                [(n, s.shape, s.logical_axes, str(s.dtype), s.init,
                  s.init_scale) for n, s in _jax_named(mo_j[key])]


@pytest.mark.parametrize("batch", [1, 3, 256, 512])
def test_batch_pspec_matches_jax(batch):
    for mesh in MESHES:
        for strategy in ("megatron", "pure_dp"):
            for extra in (1, 2):
                assert tuple(shd.batch_pspec(mesh, batch, extra, strategy)) \
                    == tuple(jax_shd.batch_pspec(mesh, batch, extra,
                                                 strategy))


# ---------------------------------------------------------------------------
# Compression and the elastic mesh shape
# ---------------------------------------------------------------------------

def _grads(case):
    rng = np.random.default_rng(7)
    if case == "float32":
        return rng.normal(size=(4, 257)).astype(np.float32) * 3.0
    if case == "bfloat16":
        return rng.normal(size=(3, 100)).astype(np.float32)
    if case == "zeros":
        return np.zeros((5, 7), np.float32)
    # exact halves: max 127 makes the scale 1, so each code rounds a half
    return np.array([-127.0, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 126.5, 127.0],
                    np.float32)


@pytest.mark.parametrize("case", ["float32", "bfloat16", "zeros", "halves"])
def test_quantize_and_compress_decompress_match_jax(case):
    """Codes and scale bitwise; the dequantized round trip and its error
    within one float32 ulp (both are the same float32 products and
    differences, so they agree bitwise here)."""
    g = _grads(case)
    bf16 = case == "bfloat16"
    gt = torch.from_numpy(g).to(torch.bfloat16 if bf16 else torch.float32)
    gj = jnp.asarray(g, jnp.bfloat16 if bf16 else jnp.float32)
    q, scale = compression.quantize(gt)
    qj, scale_j = jax_comp.quantize(gj)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    assert scale.item() == float(scale_j)
    err0 = np.random.default_rng(1).normal(size=g.shape).astype(
        np.float32) * 1e-3
    for err in (None, err0):
        deq, new_e = compression.compress_decompress(
            gt, None if err is None else torch.from_numpy(err))
        deq_j, new_e_j = jax_comp.compress_decompress(
            gj, None if err is None else jnp.asarray(err))
        assert deq.dtype == gt.dtype and new_e.dtype == torch.float32
        np.testing.assert_array_max_ulp(deq.float().numpy(),
                                        np.asarray(deq_j, np.float32), 1)
        np.testing.assert_array_max_ulp(new_e.numpy(), np.asarray(new_e_j),
                                        1)


def test_error_feedback_converges_like_jax():
    """The JAX package's rule (rel < 0.02 over 50 rounds) and the port's
    error stream within 1e-6 of the JAX package's after 50 rounds."""
    g = np.random.default_rng(0).normal(size=(256,)).astype(np.float32)
    gt, gj = torch.from_numpy(g), jnp.asarray(g)
    err, err_j = torch.zeros(256), jnp.zeros(256)
    acc_true, acc_deq = np.zeros(256), np.zeros(256)
    for _ in range(50):
        deq, err = compression.compress_decompress(gt, err)
        _, err_j = jax_comp.compress_decompress(gj, err_j)
        acc_true += g
        acc_deq += deq.numpy()
    assert np.abs(acc_deq - acc_true).max() / np.abs(acc_true).max() < 0.02
    np.testing.assert_allclose(err.numpy(), np.asarray(err_j), rtol=0,
                               atol=1e-6)


def test_choose_mesh_shape_matches_jax():
    for m in (1, 2, 4, 8, 16):
        for n in range(1, 1025):
            assert choose_mesh_shape(n, m) == jax_choose(n, m), (n, m)


# ---------------------------------------------------------------------------
# Restore on a 1x1 mesh in this process
# ---------------------------------------------------------------------------

def test_elastic_restore_on_the_host_mesh(tmp_path):
    """The JAX package's ``test_elastic_restore_resharding``: a checkpoint
    the JAX package wrote restores onto the port's (1, 1) host mesh."""
    import torch.distributed as dist
    JaxCheckpointer(tmp_path).save(1, {"w": jnp.arange(16.0).reshape(4, 4)})
    started = not dist.is_initialized()
    try:
        mesh = make_host_mesh(device_type="cpu")
        sh = {"w": shd.NamedSharding(mesh, shd.P("data", "model"))}
        out, _ = Checkpointer(tmp_path).restore(
            1, {"w": torch.zeros(4, 4)}, shardings=sh)
        np.testing.assert_array_equal(out["w"].full_tensor().numpy(),
                                      np.arange(16.0).reshape(4, 4))
        assert tuple(out["w"].placements) == sh["w"].placements
        cfg = get_config(LM_ARCH).smoke()
        caches = shd.cache_shardings(lm.cache_specs(cfg, 2, 64), cfg, mesh,
                                     global_batch=2)
        kv = caches[0]["k"]
        assert tuple(kv.spec) == (None, "data", "model", None, None)
        assert [type(p).__name__ for p in kv.placements] == ["Shard"] * 2
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The mesh runs: one JAX child (8 host devices) and 8 gloo ranks
# ---------------------------------------------------------------------------

WORLD = 8
#: (name, arch, seq): llama3.2-1b as the JAX package's own test; danube at
#: 128 positions, so its 64-token window trims key blocks (lo > 0 on the
#: later shards)
ATTN_CASES = (("llama", "llama3.2-1b", 64), ("danube", "h2o-danube-3-4b",
                                              128))
#: (name, strategy, mesh shape, batch, seq) of the whole-model forward
LM_CASES = (("seq_dp", "seq_dp", (2, 4), 2, 64),
            ("seq_dp_m3", "seq_dp", (2, 3), 2, 64),    # 64 % 3: unsplit
            ("pure_dp", "pure_dp", (2, 2), 2, 64),     # batch over data
            ("pure_dp_b4", "pure_dp", (2, 2), 4, 64))  # over data x model
LM_ARCH = "h2o-danube-3-4b"

_JAX_CHILD = """
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import attention, lm
from repro.optim.compression import make_compressed_psum
from repro.parallel.pipeline import pipeline_fwd
inp = dict(np.load(sys.argv[1]))
cases = {attn_cases!r}
lm_cases = {lm_cases!r}
out = {{}}

def tree(prefix):
    names = [k[len(prefix):] for k in inp if k.startswith(prefix)]
    t = {{}}
    for n in names:
        node = t
        parts = n.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {{}})
        node[parts[-1]] = jnp.asarray(inp[prefix + n])
    return t

def fix_blocks(t):   # numbered dict keys back to the tuple of blocks
    if isinstance(t, dict) and t and all(k.isdigit() for k in t):
        return tuple(fix_blocks(t[str(i)]) for i in range(len(t)))
    if isinstance(t, dict):
        return {{k: fix_blocks(v) for k, v in t.items()}}
    return t

mesh = jax.make_mesh((2, 4), ("data", "model"))
for name, arch, s in cases:
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              shard_strategy="seq_dp")
    params = tree(name + "/p/")
    with jax.set_mesh(mesh):
        xs = jax.device_put(jnp.asarray(inp[name + "/x"]),
                            NamedSharding(mesh, P("data", "model", None)))
        ps = jax.tree.map(lambda a: jax.device_put(
            a, NamedSharding(mesh, P())), params)
        o = jax.jit(lambda p, h: attention.attention_fwd(
            p, h, cfg, causal=True))(ps, xs)
    out[name + "/attn"] = np.asarray(o)

# the compressed mean: a distinct gradient and error on each device, in
# arrays the function takes as replicated (each device keeps its own)
mesh8 = jax.make_mesh((8,), ("data",))
devs = list(mesh8.devices.flat)
def per_device(stack, dtype):
    return jax.make_array_from_single_device_arrays(
        stack.shape[1:], NamedSharding(mesh8, P()),
        [jax.device_put(jnp.asarray(stack[i], dtype), d)
         for i, d in enumerate(devs)])
leaves = (("a", jnp.float32), ("b", jnp.bfloat16))
g = {{k: per_device(inp["psum/g_" + k], dt) for k, dt in leaves}}
e = {{k: per_device(inp["psum/e_" + k], jnp.float32) for k, _ in leaves}}
mean, new_e = make_compressed_psum(mesh8, ("data",))(g, e)
for k, _ in leaves:
    for what, arr in (("mean", mean[k]), ("err", new_e[k])):
        by_dev = {{s.device: np.asarray(s.data, np.float32)
                   for s in arr.addressable_shards}}
        out["psum/" + what + "_" + k] = np.stack([by_dev[d] for d in devs])

mesh3 = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
w, h = jnp.asarray(inp["pipe/w"]), jnp.asarray(inp["pipe/h"])
def block_apply(stage_w, hm):
    for i in range(stage_w.shape[0]):
        hm = jnp.tanh(hm @ stage_w[i])
    return hm
out["pipe/out"] = np.asarray(pipeline_fwd(block_apply, w, h, mesh3,
                                          n_microbatches=4, axis="pod"))

cfg = get_config({lm_arch!r}).smoke()
params = fix_blocks(tree("lm/p/"))
for name, _, _, b, s in lm_cases:
    out["lm/" + name] = np.asarray(jax.jit(lambda p, t: lm.lm_logits(
        p, {{"tokens": t}}, cfg))(params, jnp.asarray(inp["lm/tokens_" + name])))
np.savez(sys.argv[2], **out)
"""

_RANK = """
import datetime, json, os, sys, dataclasses
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, inputs, out_path, ckpt = sys.argv[1:7]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.configs import get_config
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention, lm
from repro_torch.models.common import abstract_params
from repro_torch.optim.compression import make_compressed_psum
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.pipeline import pipeline_fwd
from repro_torch.runtime.elastic import make_elastic_mesh
torch.backends.cuda.matmul.allow_tf32 = False
inp = dict(np.load(inputs))
cases = {attn_cases!r}
lm_cases = {lm_cases!r}
out = {{}}

def tree(prefix):
    t = {{}}
    for k in inp:
        if k.startswith(prefix):
            node = t
            parts = k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {{}})
            node[parts[-1]] = torch.from_numpy(inp[k])
    return t

def fix_blocks(t):
    if isinstance(t, dict) and t and all(k.isdigit() for k in t):
        return tuple(fix_blocks(t[str(i)]) for i in range(len(t)))
    if isinstance(t, dict):
        return {{k: fix_blocks(v) for k, v in t.items()}}
    return t

mesh = make_mesh((2, 4), ("data", "model"), "cpu")
layout = shd.BatchLayout(mesh, ("data",), ("model",))
for name, arch, s in cases:
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              shard_strategy="seq_dp")
    assert attention.seq_parallel(cfg, mesh, s)
    assert not attention.seq_parallel(cfg, mesh, s - 2)
    x = torch.from_numpy(inp[name + "/x"])
    o = attention.attention_fwd(tree(name + "/p/"), layout.local(x), cfg,
                                causal=True, impl="plain", mesh=mesh)
    out[name + "/attn"] = o.numpy()

mesh8 = make_mesh((8,), ("data",), "cpu")
leaves = (("a", torch.float32), ("b", torch.bfloat16))
g = {{k: torch.from_numpy(inp["psum/g_" + k][rank]).to(dt)
      for k, dt in leaves}}
e = {{k: torch.from_numpy(inp["psum/e_" + k][rank]) for k, _ in leaves}}
mean, new_e = make_compressed_psum(mesh8, ("data",))(g, e)
for k, dt in leaves:
    assert mean[k].dtype == dt and new_e[k].dtype == torch.float32
    out["psum/mean_" + k] = mean[k].float().numpy()
    out["psum/err_" + k] = new_e[k].numpy()

mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
w, h = torch.from_numpy(inp["pipe/w"]), torch.from_numpy(inp["pipe/h"])
def block_apply(stage_w, hm):
    for i in range(stage_w.shape[0]):
        hm = torch.tanh(hm @ stage_w[i])
    return hm
out["pipe/out"] = pipeline_fwd(block_apply, w, h, mesh3, 4,
                               axis="pod").numpy()

cfg = get_config({lm_arch!r}).smoke()
params = fix_blocks(tree("lm/p/"))
meshes = {{}}
for name, strategy, shape, b, s in lm_cases:
    if shape not in meshes:
        meshes[shape] = make_mesh(shape, ("data", "model"), "cpu")
    m = meshes[shape]
    if m.get_coordinate() is None:
        continue
    c = dataclasses.replace(cfg, shard_strategy=strategy)
    with torch.no_grad():
        d = lm.lm_logits(params, {{"tokens": torch.from_numpy(
            inp["lm/tokens_" + name]).long()}}, c, attn_impl="plain", mesh=m)
    out["lm/" + name] = d.full_tensor().numpy()
    out["lm/" + name + "/placements"] = np.array(
        [repr(p) for p in d.placements])
em = make_elastic_mesh(device_type="cpu")
em4 = make_elastic_mesh(n_devices=4, device_type="cpu")
out["elastic"] = np.array([em.size(0), em.size(1), em4.size(0), em4.size(1),
                           em4.get_coordinate() is not None])
out["elastic_names"] = np.array(list(em.mesh_dim_names)
                                + list(em4.mesh_dim_names))

rm = make_mesh((2, 2), ("data", "model"), "cpu")
if rm.get_coordinate() is not None:
    ccfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    specs = lm.model_specs(ccfg)
    restored, extra = Checkpointer(ckpt).restore(
        1, abstract_params(specs),
        shardings=shd.param_shardings(specs, ccfg, rm, fsdp=True))
    out["restore/coord"] = np.array(rm.get_coordinate())
    out["restore/extra"] = np.array(json.dumps(extra))
    from repro_torch.models.common import tree_leaves_with_names
    # shard_tree of the whole leaves restores the same slices
    whole, _ = Checkpointer(ckpt).restore(1, abstract_params(specs))
    direct = dict(tree_leaves_with_names(shd.shard_tree(
        whole, shd.param_pspecs(specs, ccfg, rm, fsdp=True), rm)))
    for n, t in tree_leaves_with_names(restored):
        assert t.dtype == torch.bfloat16, (n, t.dtype)
        assert torch.equal(direct[n].to_local(), t.to_local()), n
        assert direct[n].placements == t.placements, n
        out["restore/local/" + n] = t.to_local().float().numpy()
        out["restore/full/" + n] = t.full_tensor().float().numpy()
        out["restore/placements/" + n] = np.array(
            [repr(p) for p in t.placements])
np.savez(out_path, **out)
dist.barrier()
dist.destroy_process_group()
"""


def _flat(prefix, tree):
    return {prefix + n: np.asarray(v, np.float32)
            for n, v in _jax_named(jax.tree.map(np.asarray, tree))}


def _inputs(tmp):
    rng = np.random.default_rng(0)
    inp = {}
    for name, arch, s in ATTN_CASES:
        cfg = jax_get_config(arch).smoke()
        params = jax_init_params(jax_attention.attention_specs(cfg),
                                 jax.random.PRNGKey(0))
        inp.update(_flat(name + "/p/", params))
        inp[name + "/x"] = rng.normal(size=(2, s, cfg.d_model)).astype(
            np.float32)
    for k in ("a", "b"):
        shape = (WORLD, 64) if k == "a" else (WORLD, 4, 16)
        inp["psum/g_" + k] = rng.normal(size=shape).astype(np.float32)
        inp["psum/e_" + k] = (rng.normal(size=shape) * 1e-3).astype(
            np.float32)
    inp["psum/g_b"] = np.asarray(jnp.asarray(inp["psum/g_b"], jnp.bfloat16),
                                 np.float32)   # bf16 values, held as f32
    inp["pipe/w"] = (rng.normal(size=(4, 16, 16)) / 4.0).astype(np.float32)
    inp["pipe/h"] = rng.normal(size=(8, 4, 16)).astype(np.float32)
    cfg = jax_get_config(LM_ARCH).smoke()
    inp.update(_flat("lm/p/", jax_lm.init_model(cfg, jax.random.PRNGKey(2))))
    for name, _, _, b, s in LM_CASES:
        inp["lm/tokens_" + name] = rng.integers(
            0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    np.savez(tmp / "inputs.npz", **inp)
    # a checkpoint of bf16 weights, written by the JAX package
    ccfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    saved = jax_lm.init_model(ccfg, jax.random.PRNGKey(3))
    JaxCheckpointer(tmp / "ckpt").save(1, saved, extra={"writer": "jax"})
    return inp, saved


def _run_all(tmp, deadline_s=150.0):
    """Starts the JAX child and the 8 ranks together.  The first process
    to fail (a rank whose collective timed out, say) or the deadline
    stops the rest: they are killed.  Returns {name: (returncode, the
    tail of its stderr)}."""
    fmt = dict(attn_cases=ATTN_CASES, lm_cases=LM_CASES, lm_arch=LM_ARCH)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    rank_code = textwrap.dedent(_RANK.format(**fmt))
    commands = {"jax": [sys.executable, "-c",
                        textwrap.dedent(_JAX_CHILD.format(**fmt)),
                        str(tmp / "inputs.npz"), str(tmp / "jax.npz")]}
    for r in range(WORLD):
        commands[f"rank{r}"] = [
            sys.executable, "-c", rank_code, str(r), str(WORLD),
            str(tmp / "store"), str(tmp / "inputs.npz"),
            str(tmp / f"rank{r}.npz"), str(tmp / "ckpt")]
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
    tmp = tmp_path_factory.mktemp("mesh")
    inp, saved = _inputs(tmp)
    status = _run_all(tmp)
    failed = {k: v for k, v in status.items() if v[0] != 0}
    assert not failed, failed
    return {"inp": inp, "saved": saved,
            "jax": dict(np.load(tmp / "jax.npz")),
            "ranks": [dict(np.load(tmp / f"rank{r}.npz"))
                      for r in range(WORLD)]}


def _coord(rank, shape):
    return np.unravel_index(rank, shape)


@pytest.mark.parametrize("case", [c[0] for c in ATTN_CASES])
def test_seq_dp_attention_matches_jax_mesh(runs, case):
    """Each rank of the (2, 4) mesh holds batch row `data` and positions
    `model`*S/4..; its output equals that block of the JAX package's
    sharded output within 1e-5 (float32; the JAX package's own test holds
    2e-3 against its single-device path)."""
    want = runs["jax"][case + "/attn"]
    b, s = want.shape[:2]
    for r, out in enumerate(runs["ranks"]):
        d, m = _coord(r, (2, 4))
        blk = want[d * b // 2:(d + 1) * b // 2,
                   m * s // 4:(m + 1) * s // 4]
        np.testing.assert_allclose(out[case + "/attn"], blk, rtol=1e-5,
                                   atol=1e-5)


def test_compressed_psum_matches_jax_mesh(runs):
    """Bitwise, rank for rank against the JAX package's devices: the mean
    (equal on every rank) and each rank's new error; the mean within
    max|g|/64 of the true mean, as the JAX package's test holds it."""
    inp = runs["inp"]
    for k in ("a", "b"):
        for what in ("mean", "err"):
            got = np.stack([o[f"psum/{what}_{k}"] for o in runs["ranks"]])
            np.testing.assert_array_equal(got, runs["jax"][f"psum/{what}_{k}"])
        means = np.stack([o["psum/mean_" + k] for o in runs["ranks"]])
        assert (means == means[0]).all()
        g = inp["psum/g_" + k] + inp["psum/e_" + k]
        assert np.abs(means[0] - g.mean(0)).max() <= np.abs(g).max() / 64


def test_pipeline_matches_jax_mesh(runs):
    """Every rank of the (2, 2, 2) mesh returns the JAX package's
    pipeline output (4 microbatches over 2 stages) within 1e-5, and the
    sequential blocks' within the JAX package's 1e-4."""
    want = runs["jax"]["pipe/out"]
    w, h = runs["inp"]["pipe/w"], runs["inp"]["pipe/h"]
    seq = h
    for i in range(w.shape[0]):
        seq = np.tanh(seq @ w[i])
    for out in runs["ranks"]:
        np.testing.assert_allclose(out["pipe/out"], want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out["pipe/out"], seq, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("case", [c[0] for c in LM_CASES])
def test_lm_forward_on_a_mesh_matches_jax(runs, case):
    """The whole model (danube smoke, 2 layers, float32) on a gloo mesh
    against the JAX package's single-device logits within 1e-4 (its own
    mesh run raises at the embedding gather under this JAX), with the
    split _constrain_batch's rules give."""
    name, strategy, shape, b, s = next(c for c in LM_CASES if c[0] == case)
    want = runs["jax"]["lm/" + name]
    n = shape[0] * shape[1]
    placements = {
        "seq_dp": ["Shard(dim=0)", "Shard(dim=1)"],
        "seq_dp_m3": ["Shard(dim=0)", "Replicate()"],
        "pure_dp": ["Shard(dim=0)", "Replicate()"],
        "pure_dp_b4": ["Shard(dim=0)", "Shard(dim=0)"]}[name]
    for out in runs["ranks"][:n]:
        np.testing.assert_allclose(out["lm/" + name], want, rtol=1e-4,
                                   atol=1e-4)
        assert list(out["lm/" + name + "/placements"]) == placements


def test_make_elastic_mesh_on_gloo(runs):
    for r, out in enumerate(runs["ranks"]):
        assert list(out["elastic"]) == [1, 8, 1, 4, r < 4]
        assert list(out["elastic_names"]) == ["data", "model"] * 2


def test_sharded_restore_of_a_jax_checkpoint(runs):
    """On a (2, 2) mesh with the placements of param_pspecs (megatron,
    fsdp): each rank's local leaf is bitwise its slice of the saved leaf,
    and full_tensor() bitwise the saved leaf."""
    cfg = dataclasses.replace(get_config(LM_ARCH).smoke(),
                              param_dtype="bfloat16")
    pspecs = dict(tree_leaves_with_names(shd.param_pspecs(
        lm.model_specs(cfg), cfg, FakeMesh({"data": 2, "model": 2}),
        fsdp=True)))
    saved = {n: np.asarray(v, np.float32)
             for n, v in _jax_named(jax.tree.map(np.asarray, runs["saved"]))}
    split = 0
    for out in runs["ranks"][:4]:
        coord = dict(zip(("data", "model"), out["restore/coord"]))
        assert json.loads(str(out["restore/extra"])) == {"writer": "jax"}
        for n, full in saved.items():
            want = full
            for d, entry in enumerate(pspecs[n]):
                names = () if entry is None else (
                    entry if isinstance(entry, tuple) else (entry,))
                for a in names:
                    step = want.shape[d] // 2
                    want = np.take(want, range(coord[a] * step,
                                               (coord[a] + 1) * step), d)
                    split += 1
            np.testing.assert_array_equal(out["restore/local/" + n], want)
            np.testing.assert_array_equal(out["restore/full/" + n], full)
    assert split > 0
