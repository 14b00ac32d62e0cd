"""Compute on sharded weights (``parallel.tensor_parallel``; ``megatron``
with and without fsdp, ``ep_seq``) against the JAX package on its own mesh.

One run serves every case: a JAX child process with 8 forced host devices
runs the JAX package on a (2, 4) ("data", "model") mesh of ``AxisType.Auto``
axes (one case (4, 2)), as ``repro.launch.mesh._make_mesh`` builds them,
with each leaf put on the mesh by ``param_pspecs`` and the batch by
``batch_pspec``; beside it, 8 gloo ranks of the port (a process each,
their group on a ``file://`` store under the test's temporary directory,
a 60 s group timeout; the first process to fail, or the deadline, kills
the rest) run the port on the same mesh, each rank holding only its
slices.  The (4, 2) train case is held against the JAX package's step on
one device (``ONE_DEVICE``).  The same
numpy weights (the JAX package's ``init_model``) and inputs go through
both, in float32.  Both write npz files; the tests compare them.

* The forward: every assigned arch's smoke config (seamless with its
  encoder, qwen2-vl with its vision prefix), phi3 with 6 query heads on 2
  KV heads (a rank holds 1.5 query heads and half a KV head, whose GQA
  group spans two ranks), olmoe under ``ep_seq``, and xlstm on a (4, 2)
  mesh, where sLSTM's fused ``up`` splits and its ``down`` does not (the
  train step too): each rank's logits
  against its block of the JAX package's within 1e-4 (xlstm-350m: see
  below).
* The train step (``make_train_step(..., mesh=)``): llama (tied), phi3
  6/2, olmoe (groups of 128, so that choices drop; and groups of 256,
  which a rank's rows do not fill, so that the MoE layer gathers the
  batch), jamba (fsdp, Mamba, MoE), xlstm, and olmoe under ``pure_dp``
  (ZeRO-1 moments): the loss
  within 1e-5, every gradient leaf within 1e-4 of its largest |g|, the
  stepped parameters within 2e-5 but at entries whose reference gradient
  is below 1e-6 or within that gradient tolerance of zero (AdamW's first
  step is lr g / (|g| + eps), which a gradient within its tolerance of
  zero may move by up to 2 lr), which must stay under 0.1% of the
  entries; and every stepped slice within 2e-5 of the JAX package's AdamW
  applied to the ranks' own gradients.  xlstm-350m's logits and
  gradients move by more than 1e-4 under a one-float32-ulp change of
  every weight (the witness, from the JAX package alone): they are held
  to twice the witness where that is larger, the witness staying under
  1e-2 of the largest value; its gradient norm clips g to a few eps, so
  its stepped entries whose first step can move by more than 2e-5 within
  the gradient's tolerance are exempt too.
* The shards: each rank's leaves are exactly its slices of the full
  tensors, at the split shapes, and its moments have its ``opt_pspecs``
  slices' shapes.
* Prefill on weights placed by the serving rule (``SERVE``): with
  ``HBM_BYTES_BUDGET`` set to ``SERVE_BUDGET`` in both packages for the
  case, so that ``serve_needs_fsdp`` holds for the smoke config, the JAX
  package's ``make_prefill_step`` on weights placed by ``param_pspecs(...,
  fsdp=serve_fsdp)``, as its prefill cell places them, beside the port's
  ``make_prefill_step(..., mesh=)`` on each rank's ``lm.serve_pspecs``
  slices (the width over ``data`` too): phi3 6/2, olmoe (its experts'
  width over ``data``) and seamless (its encoder through ``encode(...,
  pspecs=)``).  Each rank's logits against its block of the JAX
  package's within 1e-4, and its leaves exactly its serving slices.
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

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models.common import is_spec_leaf  # noqa: E402
from repro.optim.adamw import OptimizerConfig as JaxOpt  # noqa: E402
from repro.optim.adamw import adamw_update as jax_adamw  # noqa: E402
from repro.optim.adamw import init_opt_state as jax_init_opt  # noqa: E402
from repro.parallel import sharding as jax_shd  # noqa: E402

pytestmark = pytest.mark.tier1

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
WORLD, SHAPE = 8, (2, 4)
BATCH, ENC_LEN = 2, 32
#: (name, arch, config overrides, sequence length, mesh shape)
FORWARD = tuple((arch, arch, {}, 128 if arch == "h2o-danube-3-4b" else 64,
                 SHAPE) for arch in ASSIGNED_ARCHS) + (
    ("phi3-6-2", "phi3-medium-14b", {"n_heads": 6, "n_kv_heads": 2}, 64,
     SHAPE),
    ("olmoe-ep_seq", "olmoe-1b-7b", {"shard_strategy": "ep_seq"}, 64, SHAPE),
    # model 2: sLSTM's up (64, 170) splits and its down (85, 64) does not
    ("xlstm-model2", "xlstm-350m", {}, 64, (4, 2)))
#: prefill on serving weights with the budget lowered: fsdp over data
SERVE = (
    ("serve-phi3-6-2", "phi3-medium-14b", {"n_heads": 6, "n_kv_heads": 2},
     64, SHAPE),
    ("serve-olmoe", "olmoe-1b-7b", {}, 64, SHAPE),
    ("serve-seamless", "seamless-m4t-large-v2", {}, 64, SHAPE))
#: the serving budget (bytes a ``model`` slice) of the SERVE cases, set in
#: both packages' ``parallel.sharding`` for each: every smoke config is above
SERVE_BUDGET = 1024
TRAIN = (
    ("train-llama", "llama3.2-1b", {}, 64, SHAPE),
    ("train-phi3-6-2", "phi3-medium-14b", {"n_heads": 6, "n_kv_heads": 2},
     64, SHAPE),
    ("train-olmoe", "olmoe-1b-7b", {"moe_group_size": 128}, 128, SHAPE),
    ("train-jamba", "jamba-1.5-large-398b", {}, 64, SHAPE),
    ("train-xlstm", "xlstm-350m", {}, 64, SHAPE),
    ("train-xlstm-model2", "xlstm-350m", {}, 64, (4, 2)),
    # megatron where a rank's 128 tokens are half a group: the MoE layer
    # gathers the batch
    ("train-olmoe-gathered", "olmoe-1b-7b", {"moe_group_size": 256}, 128,
     SHAPE),
    # pure_dp: every leaf replicated, the moments split over model (ZeRO-1)
    ("train-olmoe-pure_dp", "olmoe-1b-7b", {"shard_strategy": "pure_dp"},
     64, SHAPE))
#: train cases held against the JAX package's step on one device: on the
#: (4, 2) mesh, whose data dim the batch of 2 does not divide, its mesh run
#: adds a gradient to embedding row 0, which no token looks up (ROADMAP §C)
ONE_DEVICE = ("train-xlstm-model2",)
#: the optimizer of the step: lr 1e-3 from step 1
OPT = {"peak_lr": 1e-3, "warmup_steps": 1, "total_steps": 100}
WITNESS_ARCH = "xlstm-350m"

_COMMON = """
import dataclasses, json, os, sys
import numpy as np
inp = dict(np.load(sys.argv[-3]))
cases = json.loads(sys.argv[-1])
out = {{}}

def tree(prefix, wrap):
    t = {{}}
    for k in inp:
        if k.startswith(prefix):
            node = t
            parts = k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {{}})
            node[parts[-1]] = wrap(inp[k])

    def fix(t):   # numbered keys back to the tuple of blocks
        if isinstance(t, dict) and t and all(k.isdigit() for k in t):
            return tuple(fix(t[str(i)]) for i in range(len(t)))
        if isinstance(t, dict):
            return {{k: fix(v) for k, v in t.items()}}
        return t
    return fix(t)
"""

_JAX_CHILD = _COMMON + """
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import contextlib
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.launch.mesh import _make_mesh
from repro.models import lm
from repro.optim.adamw import OptimizerConfig, adamw_update, init_opt_state
from repro.parallel import sharding as shd
from repro.train import steps

opt = OptimizerConfig(**{opt!r})

def named(t):
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return [("/".join(key(k) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]]

def put(t, pspecs):
    return jax.tree.map(lambda a, p: jax.device_put(a, NamedSharding(mesh, p)),
                        t, pspecs)

meshes = {{}}

def one_ulp(params):   # every element moved by one float32 ulp
    rng = np.random.default_rng(9)
    return jax.tree.map(lambda a: a * jnp.asarray(1 + 2.0 ** -23 * rng.choice(
        [-1.0, 1.0], size=a.shape), a.dtype), params)

budget = shd.HBM_BYTES_BUDGET
for name, arch, over, seq, shape, kind in cases:
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = _make_mesh(shape, ("data", "model"))
    mesh = meshes[shape]
    cfg = dataclasses.replace(get_config(arch).smoke(), **over)
    params = tree(name + "/p/", jnp.asarray)
    pspecs = shd.param_pspecs(lm.model_specs(cfg), cfg, mesh)
    if kind == "serve":   # as its prefill cell places the weights
        shd.HBM_BYTES_BUDGET = {serve_budget!r}
        serve_fsdp = cfg.fsdp or shd.serve_needs_fsdp(cfg, mesh)
        shd.HBM_BYTES_BUDGET = budget
        out[name + "/serve_fsdp"] = np.asarray(serve_fsdp)
        pspecs = shd.param_pspecs(lm.model_specs(cfg), cfg, mesh,
                                  fsdp=serve_fsdp)
    batch = {{k[len(name) + 3:]: jnp.asarray(v) for k, v in inp.items()
              if k.startswith(name + "/b/")}}
    one = name in {one_device!r}
    with contextlib.nullcontext() if one else jax.set_mesh(mesh):
        ps = params if one else put(params, pspecs)
        bs = batch if one else {{k: jax.device_put(v, NamedSharding(
            mesh, shd.batch_pspec(mesh, v.shape[0], v.ndim - 1)))
            for k, v in batch.items()}}
        if kind == "serve":
            out[name + "/logits"] = np.asarray(jax.jit(
                steps.make_prefill_step(cfg))(ps, bs))
            continue
        if kind == "forward":
            fwd = jax.jit(lambda p, b: lm.lm_logits(p, b, cfg))
            logits = np.asarray(fwd(ps, bs))
            out[name + "/logits"] = logits
            if arch == {witness!r}:
                out[name + "/witness"] = np.abs(np.asarray(fwd(
                    put(one_ulp(params), pspecs), bs)) - logits).max()
            continue
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: lm.lm_loss(p, b, cfg)[0]))
        loss, grads = vg(ps, bs)
        state = init_opt_state(params, opt)
        if not one:
            state = put(state, {{
                "mu": shd.opt_pspecs(lm.model_specs(cfg), cfg, mesh),
                "nu": shd.opt_pspecs(lm.model_specs(cfg), cfg, mesh),
                "step": jax.sharding.PartitionSpec()}})
        new, _, _ = jax.jit(lambda p, g, s: adamw_update(p, g, s, opt))(
            ps, grads, state)
        out[name + "/loss"] = np.asarray(loss)
        for n, g in named(grads):
            out[name + "/g/" + n] = np.asarray(g)
        for n, p in named(new):
            out[name + "/new/" + n] = np.asarray(p)
        if arch == {witness!r}:
            moved = one_ulp(params)
            _, moved = vg(moved if one else put(moved, pspecs), bs)
            for (n, g), (_, m) in zip(named(grads), named(moved)):
                out[name + "/gwitness/" + n] = np.abs(
                    np.asarray(m) - np.asarray(g)).max()
np.savez(sys.argv[-2], **out)
"""

_RANK = _COMMON + """
import datetime
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves_with_names
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.parallel import sharding as shd
from repro_torch.train import steps

opt = OptimizerConfig(**{opt!r})
meshes, seen = {{}}, {{}}
update = steps.adamw_update

def spy(params, grads, state, opt, mesh=None, split=None, zero=None):
    seen["grads"] = [g.clone() for g in grads]
    return update(params, grads, state, opt, mesh, split, zero)

steps.adamw_update = spy
budget = shd.HBM_BYTES_BUDGET
for name, arch, over, seq, shape, kind in cases:
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = make_mesh(shape, ("data", "model"), "cpu")
    mesh = meshes[shape]
    cfg = dataclasses.replace(get_config(arch).smoke(), **over)
    full = tree(name + "/p/", torch.from_numpy)
    pspecs = shd.param_pspecs(lm.model_specs(cfg), cfg, mesh)
    batch = {{k[len(name) + 3:]: torch.from_numpy(v) for k, v in inp.items()
              if k.startswith(name + "/b/")}}
    for k in ("tokens", "targets"):
        if k in batch:
            batch[k] = batch[k].long()
    if kind == "serve":
        shd.HBM_BYTES_BUDGET = {serve_budget!r}
        params = shd.local_tree(full, lm.serve_pspecs(cfg, mesh), mesh)
        for n, t in tree_leaves_with_names(params):
            out[name + "/p0/" + n] = t.numpy().copy()
        d = steps.make_prefill_step(cfg, attn_impl="plain", mesh=mesh)(
            params, batch)
        shd.HBM_BYTES_BUDGET = budget
        out[name + "/logits"] = d.to_local().numpy()
        out[name + "/placements"] = np.array([repr(p) for p in d.placements])
        continue
    if kind == "forward":
        with torch.no_grad():
            d = lm.lm_logits(shd.shard_tree(full, pspecs, mesh), batch, cfg,
                             attn_impl="plain", mesh=mesh)
        out[name + "/logits"] = d.to_local().numpy()
        out[name + "/placements"] = np.array([repr(p) for p in d.placements])
        continue
    params = shd.local_tree(full, pspecs, mesh)
    for n, t in tree_leaves_with_names(params):
        out[name + "/p0/" + n] = t.numpy().copy()
    state = steps.init_train_state(params, opt, cfg, mesh)
    params, state, m = steps.make_train_step(cfg, opt, mesh=mesh)(
        params, state, batch)
    out[name + "/loss"] = np.asarray(float(m["loss"]))
    names = [n for n, _ in tree_leaves_with_names(params)]
    for n, g in zip(names, seen["grads"]):
        out[name + "/g/" + n] = g.numpy()
    for n, t in tree_leaves_with_names(params):
        out[name + "/new/" + n] = t.detach().numpy()
    for key in ("mu", "nu"):
        for n, t in tree_leaves_with_names(state[key]):
            out[name + "/" + key + "/" + n] = np.array(t.shape)
np.savez(sys.argv[-2], **out)
dist.barrier()
dist.destroy_process_group()
"""


def _named(tree):
    """(name, leaf) pairs of a JAX tree, named as the port names them."""
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
        or is_spec_leaf(x))[0]
    return [("/".join(key(k) for k in path), leaf) for path, leaf in flat]


def _cfg(arch, over):
    return dataclasses.replace(jax_get_config(arch).smoke(), **over)


def _inputs(tmp):
    rng = np.random.default_rng(0)
    inp = {}
    for i, (name, arch, over, seq, _) in enumerate(FORWARD + TRAIN
                                                   + SERVE):
        cfg = _cfg(arch, over)
        params = jax_lm.init_model(cfg, jax.random.PRNGKey(i))
        for n, v in _named(jax.tree.map(np.asarray, params)):
            inp[f"{name}/p/{n}"] = np.asarray(v, np.float32)
        toks = rng.integers(0, cfg.vocab_size, (BATCH, seq + 1))
        inp[name + "/b/tokens"] = toks[:, :-1].astype(np.int32)
        if name.startswith("train-"):
            inp[name + "/b/targets"] = toks[:, 1:].astype(np.int32)
        if cfg.vision_tokens:
            inp[name + "/b/vision_embeds"] = rng.normal(
                size=(BATCH, cfg.vision_tokens, cfg.d_model)).astype(
                np.float32)
        if cfg.encoder_decoder:
            inp[name + "/b/enc_embeds"] = rng.normal(
                size=(BATCH, ENC_LEN, cfg.d_model)).astype(np.float32)
    np.savez(tmp / "inputs.npz", **inp)
    return inp


def _run_all(tmp, deadline_s=420.0):
    """Starts the JAX child and the 8 ranks together.  The first process
    to fail (a rank whose collective timed out, say) or the deadline
    stops the rest: they are killed.  Returns {name: (returncode, the
    tail of its stderr)}."""
    cases = json.dumps([c + ("forward",) for c in FORWARD]
                       + [c + ("train",) for c in TRAIN]
                       + [c + ("serve",) for c in SERVE])
    fmt = dict(opt=OPT, witness=WITNESS_ARCH, one_device=ONE_DEVICE,
               serve_budget=SERVE_BUDGET)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    tail = [str(tmp / "inputs.npz")]
    commands = {"jax": [sys.executable, "-c",
                        textwrap.dedent(_JAX_CHILD.format(**fmt))]
                + tail + [str(tmp / "jax.npz"), cases]}
    rank_code = textwrap.dedent(_RANK.format(**fmt))
    for r in range(WORLD):
        commands[f"rank{r}"] = [sys.executable, "-c", rank_code, str(r),
                                str(WORLD), str(tmp / "store")] + tail + [
            str(tmp / f"rank{r}.npz"), cases]
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
    tmp = tmp_path_factory.mktemp("tp")
    inp = _inputs(tmp)
    status = _run_all(tmp)
    failed = {k: v for k, v in status.items() if v[0] != 0}
    assert not failed, failed
    return {"inp": inp, "jax": dict(np.load(tmp / "jax.npz")),
            "ranks": [dict(np.load(tmp / f"rank{r}.npz"))
                      for r in range(WORLD)]}


def _block(full_shape, spec, coord, shape):
    """The index of the block of a full array of ``full_shape`` that the
    rank at ``coord`` (a dict of mesh dim to index) of a ("data", "model")
    mesh of ``shape`` holds under ``spec`` (a PartitionSpec as a
    tuple)."""
    sizes = dict(zip(("data", "model"), shape))
    out = []
    for d, size in enumerate(full_shape):
        entry = spec[d] if d < len(spec) else None
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n, i = 1, 0
        for a in names:
            n, i = n * sizes[a], i * sizes[a] + coord[a]
        out.append(slice(i * size // n, (i + 1) * size // n))
    return tuple(out)


def _local(full, spec, coord, shape):
    return full[_block(full.shape, spec, coord, shape)]


def _coords(runs, shape):
    """Each rank's coordinates on a mesh of ``shape`` over ranks 0.. in
    row-major order, as ``make_mesh`` lays them out."""
    return [dict(zip(("data", "model"), map(int, np.unravel_index(r, shape))))
            for r in range(len(runs["ranks"]))]


def _pspecs(arch, over, mesh_shape, rule=jax_shd.param_pspecs):
    """The JAX package's PartitionSpec of each leaf by ``rule``
    (``param_pspecs``, or ``opt_pspecs`` for the moments), as tuples."""
    cfg = _cfg(arch, over)

    class Mesh:   # shape-only, as tests/test_sharding_rules.py has it
        shape = dict(zip(("data", "model"), mesh_shape))
        axis_names = ("data", "model")
    return {n: tuple(p) for n, p in _named(rule(
        jax_lm.model_specs(cfg), cfg, Mesh()))}


def _witness_tol(name, want, witness):
    """Twice the witness (the JAX package's own movement under a one-ulp
    change of every weight) of a value of the witness arch, which must
    stay under 1e-2 of ``want``'s largest magnitude, so that the check
    can still fail a wrong value.  Prints the reading."""
    top = float(np.abs(want).max())
    print(f"{name}: witness {witness:.3e}, max {top:.3e}, ratio "
          f"{witness / top:.2e}")
    assert 2 * witness <= 1e-2 * top, (name, witness, top)
    return 2 * witness


@pytest.mark.parametrize("case", [c[0] for c in FORWARD])
def test_logits_on_sharded_weights_match_jax_mesh(runs, case):
    """Each rank's logits are its block of the JAX package's mesh run:
    batch rows over ``data`` and, under megatron, the vocabulary over
    ``model`` (the JAX package constrains them so), under ep_seq the
    positions over ``model``."""
    _, arch, over, _, shape = next(c for c in FORWARD if c[0] == case)
    want = runs["jax"][case + "/logits"]
    tol = 1e-4
    if arch == WITNESS_ARCH:
        tol = max(tol, _witness_tol(case, want,
                                    float(runs["jax"][case + "/witness"])))
    rows = "data" if BATCH % shape[0] == 0 else None
    if over.get("shard_strategy") == "ep_seq":
        spec, split = (rows, "model", None), "Shard(dim=1)"
    else:
        spec, split = (rows, None, "model"), "Shard(dim=2)"
    placements = ["Shard(dim=0)" if rows else "Replicate()", split]
    for coord, out in zip(_coords(runs, shape), runs["ranks"]):
        np.testing.assert_allclose(out[case + "/logits"],
                                   _local(want, spec, coord, shape),
                                   rtol=tol, atol=tol)
        assert list(out[case + "/placements"]) == placements


def _sensitive(g, tol, clip):
    """Where AdamW's first step, lr c g / (c |g| + eps) with the clipping
    scale ``clip``, can move by more than 2e-5 under a gradient error of
    ``tol``: by up to lr c eps tol / (c (|g| - tol) + eps)^2."""
    lr, eps = OPT["peak_lr"], JaxOpt().eps
    low = clip * np.maximum(np.abs(g) - tol, 0.0) + eps
    return lr * clip * eps * tol / low ** 2 > 2e-5


@pytest.mark.parametrize("case", [c[0] for c in TRAIN])
def test_train_step_on_sharded_weights_matches_jax_mesh(runs, case):
    """The loss, every gradient leaf and the stepped parameters of each
    rank against its block of the JAX package's mesh step.  For
    xlstm-350m, whose gradient norm clips g to a few eps, the stepped
    entries where the first step is that sensitive to the gradient's
    tolerance (:func:`_sensitive`) count with those near zero."""
    _, arch, over, _, shape = next(c for c in TRAIN if c[0] == case)
    jx = runs["jax"]
    pspecs = _pspecs(arch, over, shape)
    clip = min(1.0, JaxOpt().clip_norm / (np.sqrt(sum(
        np.sum(np.square(jx[f"{case}/g/{n}"].astype(np.float64)))
        for n in pspecs)) + 1e-9))
    tols = {}
    for n in pspecs:
        g_ref = jx[f"{case}/g/{n}"]
        tols[n] = 1e-4 * float(np.abs(g_ref).max())
        if arch == WITNESS_ARCH:
            tols[n] = max(tols[n], _witness_tol(
                f"{case} {n}", g_ref, float(jx[f"{case}/gwitness/{n}"])))
    flipped = total = 0
    for coord, out in zip(_coords(runs, shape), runs["ranks"]):
        np.testing.assert_allclose(out[case + "/loss"], jx[case + "/loss"],
                                   rtol=1e-5, atol=1e-5)
        for n, spec in pspecs.items():
            g_ref, tol = jx[f"{case}/g/{n}"], tols[n]
            near_zero = max(1e-6, tol)
            g_mine = _local(g_ref, spec, coord, shape)
            np.testing.assert_allclose(out[f"{case}/g/{n}"], g_mine,
                                       rtol=0, atol=tol, err_msg=n)
            moved = np.abs(out[f"{case}/new/{n}"] - _local(
                jx[f"{case}/new/{n}"], spec, coord, shape))
            small = np.abs(g_mine) < near_zero
            if arch == WITNESS_ARCH:
                small |= _sensitive(g_mine, tol, clip)
            assert (moved[~small] <= 2e-5).all(), (n, moved[~small].max())
            flipped += int((moved[small] > 2e-5).sum())
            total += moved.size
    print(f"{case}: {flipped} of {total} stepped entries beyond 2e-5, "
          f"all exempt (clip scale {clip:.3g})")
    assert flipped <= 1e-3 * total


@pytest.mark.parametrize("case", [c[0] for c in TRAIN])
def test_step_on_shards_is_adamw_of_the_ranks_gradients(runs, case):
    """The sharded optimizer: each rank's stepped slices are, within 2e-5,
    the JAX package's ``adamw_update`` (in this process, one device) of the
    full parameters by the ranks' own gradients put back together, so the
    clipping norm spans the mesh and every slice steps once."""
    _, arch, over, _, shape = next(c for c in TRAIN if c[0] == case)
    pspecs = _pspecs(arch, over, shape)
    coords = _coords(runs, shape)
    params, grads = {}, {}
    for n, spec in pspecs.items():
        params[n] = runs["inp"][f"{case}/p/{n}"]
        grads[n] = np.zeros_like(params[n])
        for coord, out in zip(coords, runs["ranks"]):
            grads[n][_block(params[n].shape, spec, coord, shape)] = \
                out[f"{case}/g/{n}"]
    opt = JaxOpt(**OPT)
    new, _, _ = jax_adamw(params, grads, jax_init_opt(params, opt), opt)
    for coord, out in zip(coords, runs["ranks"]):
        for n, spec in pspecs.items():
            np.testing.assert_allclose(
                out[f"{case}/new/{n}"],
                _local(np.asarray(new[n]), spec, coord, shape), rtol=0,
                atol=2e-5, err_msg=n)


@pytest.mark.parametrize("case", [c[0] for c in TRAIN])
def test_ranks_hold_only_their_slices(runs, case):
    """Before the step each rank's leaves are bitwise its slices of the
    full leaves, at the split shapes; its moments have the shapes of its
    slices by opt_pspecs (param_pspecs under megatron, ZeRO-1 over
    ``model`` under pure_dp)."""
    _, arch, over, _, shape = next(c for c in TRAIN if c[0] == case)
    pspecs = _pspecs(arch, over, shape)
    ospecs = _pspecs(arch, over, shape, jax_shd.opt_pspecs)
    split = 0
    for coord, out in zip(_coords(runs, shape), runs["ranks"]):
        for n, spec in pspecs.items():
            full = runs["inp"][f"{case}/p/{n}"]
            want = _local(full, spec, coord, shape)
            got = out[f"{case}/p0/{n}"]
            np.testing.assert_array_equal(got, want, err_msg=n)
            moment = _local(full, ospecs[n], coord, shape).shape
            for key in ("mu", "nu"):
                assert tuple(out[f"{case}/{key}/{n}"]) == moment, n
            split += got.size < full.size
    assert split > 0 or over.get("shard_strategy") == "pure_dp"
    if case == "train-jamba":   # fsdp: embed over data too
        assert pspecs["embed"] == ("model", "data")
    if over.get("shard_strategy") == "pure_dp":
        assert ospecs != pspecs


def _serve_pspecs(arch, over, mesh_shape):
    """The JAX package's PartitionSpecs of the serving weights with fsdp,
    as its prefill cell gives them where ``serve_needs_fsdp`` holds."""
    import functools
    return _pspecs(arch, over, mesh_shape,
                   functools.partial(jax_shd.param_pspecs, fsdp=True))


@pytest.mark.parametrize("case", [c[0] for c in SERVE])
def test_prefill_on_serving_weights_matches_jax_mesh(runs, case):
    """With the budget lowered, the JAX package's prefill cell places the
    weights with fsdp; each rank's logits from its serving slices are its
    block of the JAX package's (batch rows over ``data``, the vocabulary
    over ``model``) within 1e-4."""
    _, arch, over, _, shape = next(c for c in SERVE if c[0] == case)
    assert bool(runs["jax"][case + "/serve_fsdp"])
    want = runs["jax"][case + "/logits"]
    spec = ("data", None, "model")
    for coord, out in zip(_coords(runs, shape), runs["ranks"]):
        np.testing.assert_allclose(out[case + "/logits"],
                                   _local(want, spec, coord, shape),
                                   rtol=1e-4, atol=1e-4)
        assert list(out[case + "/placements"]) == ["Shard(dim=0)",
                                                   "Shard(dim=2)"]


@pytest.mark.parametrize("case", [c[0] for c in SERVE])
def test_ranks_hold_only_their_serving_slices(runs, case):
    """Each rank's leaves are bitwise its slices by the JAX package's
    serving placement, which splits the width over ``data`` where the
    training placement (``param_pspecs`` without fsdp) does not: the
    embedding table, every block's matrices (the encoder's too) and, for
    olmoe, the experts' (E, D, F) over (model, data)."""
    _, arch, over, _, shape = next(c for c in SERVE if c[0] == case)
    pspecs = _serve_pspecs(arch, over, shape)
    plain = _pspecs(arch, over, shape)
    over_data = [n for n, p in pspecs.items()
                 if any("data" in (e if isinstance(e, tuple) else (e,))
                        for e in p)]
    assert "embed" in over_data and pspecs["embed"] == ("model", "data")
    assert all("data" not in str(plain[n]) for n in over_data)
    if arch == "olmoe-1b-7b":
        assert any("/moe/" in n and pspecs[n][1:3] == ("model", "data")
                   for n in over_data), over_data
    if arch == "seamless-m4t-large-v2":
        assert any(n.startswith("encoder/") for n in over_data)
    for coord, out in zip(_coords(runs, shape), runs["ranks"]):
        for n, spec in pspecs.items():
            full = runs["inp"][f"{case}/p/{n}"]
            np.testing.assert_array_equal(out[f"{case}/p0/{n}"],
                                          _local(full, spec, coord, shape),
                                          err_msg=n)
