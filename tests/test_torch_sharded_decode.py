"""Decode and prefill over sharded caches (``lm.decode_step``,
``lm.prefill``, ``lm.init_cache`` and ``steps.make_serve_step`` with
``mesh=``) against the JAX package on its own mesh.

One run serves every case: a JAX child process with 8 forced host devices
runs the JAX package's serve step (``jax.jit(make_serve_step(cfg))``) and
``lm.prefill`` on a (2, 4) ("data", "model") mesh of ``AxisType.Auto``
axes (one case (1, 8)), as ``repro.launch.mesh._make_mesh`` builds them,
with the shardings of ``repro.launch.specs``' decode cell: the weights by
``param_pspecs`` with fsdp where ``cfg.fsdp`` or ``serve_needs_fsdp`` asks,
the caches by ``cache_shardings`` (in and out), the token by
``batch_pspec(mesh, b, extra_dims=1)`` and ``pos`` replicated.  Beside it,
8 gloo ranks of the port (a process each, their group on a ``file://``
store under the test's temporary directory, a 60 s group timeout; the
first process to fail, or the deadline, kills the rest) run the port on
the same mesh, each rank holding only its slices of the weights and of
every cache.  The same numpy weights (the JAX package's ``init_model``),
seeded caches and tokens go through both, in float32.

* decode: every assigned arch's smoke config at batch 2 over 64 slots, one
  step at pos 37 and one at pos 70 (the ring buffer wrapped), each from
  the same seeded caches; and the options: batch 1 (the slots over
  ("data", "model")) for danube, jamba and seamless (its cross caches), ``decode_ring=8`` (the rings
  split on head_dim), ``decode_cache_update="dus"``, ``seq_dp``,
  ``ep_seq`` and ``pure_dp`` (whole weights beside split caches and
  states), phi3 with 6 query heads on 2 KV heads (half a KV head a rank),
  jamba with fsdp (its config's) and xlstm on a (1, 8) mesh (mLSTM's
  states split on the key dim, sLSTM's mid-head).  Each rank's logits are
  its block of the JAX package's within 1e-4; its new cache slices are its
  blocks of the JAX package's new caches, attention's within 1e-5,
  recurrent states within 1e-5 of the leaf's largest magnitude.
* prefill: 16 tokens into 64 slots (seamless with 32 frames through its
  encoder, also at batch 1), then three chained decode steps, held
  likewise.
* the slices: each rank's cache leaves have exactly the local shapes of
  the JAX package's ``cache_pspecs``, and where that rule splits a leaf no
  rank holds it whole.
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
from repro.parallel import sharding as jax_shd  # noqa: E402

pytestmark = pytest.mark.tier1

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
WORLD, SHAPE = 8, (2, 4)
SLOTS, ENC_LEN, PROMPT, CHAIN = 64, 32, 16, 3
POSITIONS = (37, 70)
DEADLINE_S = 300.0
#: (name, arch, config overrides, batch, mesh shape)
DECODE = tuple((arch, arch, {}, 2, SHAPE) for arch in ASSIGNED_ARCHS) + (
    ("danube-b1", "h2o-danube-3-4b", {}, 1, SHAPE),
    ("jamba-b1", "jamba-1.5-large-398b", {}, 1, SHAPE),
    ("seamless-b1", "seamless-m4t-large-v2", {}, 1, SHAPE),
    ("llama-ring8", "llama3.2-1b", {"decode_ring": 8}, 2, SHAPE),
    ("llama-dus", "llama3.2-1b", {"decode_cache_update": "dus"}, 2, SHAPE),
    ("llama-seq_dp", "llama3.2-1b", {"shard_strategy": "seq_dp"}, 2, SHAPE),
    ("olmoe-ep_seq", "olmoe-1b-7b", {"shard_strategy": "ep_seq"}, 2, SHAPE),
    ("olmoe-pure_dp", "olmoe-1b-7b", {"shard_strategy": "pure_dp"}, 2,
     SHAPE),
    ("jamba-seq_dp", "jamba-1.5-large-398b", {"shard_strategy": "seq_dp"},
     2, SHAPE),
    ("xlstm-pure_dp", "xlstm-350m", {"shard_strategy": "pure_dp"}, 2, SHAPE),
    ("phi3-6-2", "phi3-medium-14b", {"n_heads": 6, "n_kv_heads": 2}, 2,
     SHAPE),
    ("xlstm-model8", "xlstm-350m", {}, 2, (1, 8)))
PREFILL = tuple((f"prefill-{arch}", arch, {}, 2, SHAPE) for arch in (
    "seamless-m4t-large-v2", "llama3.2-1b", "jamba-1.5-large-398b",
    "xlstm-350m")) + (
    # the frames over ("data", "model"): each rank projects its slice
    ("prefill-seamless-b1", "seamless-m4t-large-v2", {}, 1, SHAPE),)
DECODE_NAMES = tuple(c[0] for c in DECODE)
#: the arch whose float32 decode moves by more than the tolerances under a
#: one-ulp change of every weight (the witness), as on sharded weights
WITNESS_ARCH = "xlstm-350m"
#: the recurrent states, held relative to the leaf's largest magnitude
RECURRENT = ("conv", "h", "c", "n", "m")

_COMMON = """
import dataclasses, json, os, sys
import numpy as np
inp = dict(np.load(sys.argv[-3]))
cases = json.loads(sys.argv[-1])
out = {}

def tree(prefix, wrap):
    t = {}
    for k in inp:
        if k.startswith(prefix):
            node = t
            parts = k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = wrap(inp[k])

    def fix(t):   # numbered keys back to tuples
        if isinstance(t, dict) and t and all(k.isdigit() for k in t):
            return tuple(fix(t[str(i)]) for i in range(len(t)))
        if isinstance(t, dict):
            return {k: fix(v) for k, v in t.items()}
        return t
    return fix(t)

def batch_of(name, wrap):
    return {k[len(name) + 3:]: wrap(v) for k, v in inp.items()
            if k.startswith(name + "/b/")}
"""

_JAX_CHILD = _COMMON + """
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.mesh import _make_mesh
from repro.models import lm
from repro.parallel import sharding as shd
from repro.train.steps import make_serve_step

def named(t):
    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))
    return [("/".join(key(k) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]]

def one_ulp(params):   # every element moved by one float32 ulp
    rng = np.random.default_rng(9)
    return jax.tree.map(lambda a: a * jnp.asarray(1 + 2.0 ** -23 * rng.choice(
        [-1.0, 1.0], size=a.shape), a.dtype), params)

class Placed:   # the decode cell on a mesh by specs.py's shardings;
                # with mesh None, the same step and prefill on one device
    def __init__(self, cfg, b, mesh):
        self.mesh = mesh
        if mesh is None:
            self.step = jax.jit(make_serve_step(cfg))
            self.fill = jax.jit(lambda p, bt: lm.prefill(p, bt, cfg, SLOTS))
            return
        fsdp = cfg.fsdp or shd.serve_needs_fsdp(cfg, mesh)
        self.psh = shd.param_shardings(lm.model_specs(cfg), cfg, mesh,
                                       fsdp=fsdp)
        cross = ENC_LEN if cfg.encoder_decoder else 0
        self.csh = shd.cache_shardings(lm.cache_specs(cfg, b, SLOTS, cross),
                                       cfg, mesh, b)
        self.tok = NamedSharding(mesh, shd.batch_pspec(mesh, b, extra_dims=1))
        self.pos_sh = NamedSharding(mesh, P())
        self.bsh = lambda v: NamedSharding(mesh, shd.batch_pspec(
            mesh, b, v.ndim - 1))
        self.step = jax.jit(make_serve_step(cfg), in_shardings=(
            self.psh, self.csh, self.tok, self.pos_sh),
            out_shardings=(None, self.csh))
        self.fill = jax.jit(lambda p, bt: lm.prefill(p, bt, cfg, SLOTS),
                            out_shardings=(None, self.csh))

    def put(self, t, what):
        if self.mesh is None:
            return t
        if what == "batch":
            return {k: jax.device_put(v, self.bsh(v)) for k, v in t.items()}
        sh = {"params": self.psh, "caches": self.csh}.get(what)
        if sh is not None:
            return jax.tree.map(jax.device_put, t, sh)
        return jax.device_put(t, self.tok if what == "token" else self.pos_sh)

    def run(self, name, kind, params):
        got = {}
        params = self.put(params, "params")
        if kind == "decode":
            token = self.put(jnp.asarray(inp[name + "/token"]), "token")
            for pos in POSITIONS:
                caches = self.put(tree(name + "/cache/", jnp.asarray),
                                  "caches")
                logits, new = self.step(params, caches, token,
                                        self.put(jnp.int32(pos), "pos"))
                got[f"{name}/{pos}/logits"] = np.asarray(logits)
                for n, leaf in named(new):
                    got[f"{name}/{pos}/cache/{n}"] = np.asarray(leaf)
            return got
        batch = self.put(batch_of(name, jnp.asarray), "batch")
        logits, caches = self.fill(params, batch)
        got[name + "/logits"] = np.asarray(logits)
        for n, leaf in named(caches):
            got[f"{name}/cache/{n}"] = np.asarray(leaf)
        chain = self.put(jnp.asarray(inp[name + "/chain"]), "token")
        for t in range(CHAIN):
            logits, caches = self.step(params, caches, chain[:, t:t + 1],
                                       self.put(jnp.int32(PROMPT + t), "pos"))
            got[f"{name}/chain{t}/logits"] = np.asarray(logits)
        for n, leaf in named(caches):
            got[f"{name}/chain/cache/{n}"] = np.asarray(leaf)
        return got

meshes = {}
for name, arch, over, b, shape, kind, witness in cases:
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = _make_mesh(shape, ("data", "model"))
    mesh = meshes[shape]
    cfg = dataclasses.replace(get_config(arch).smoke(), **over)
    params = tree(name + "/p/", jnp.asarray)
    cell = Placed(cfg, b, mesh)
    with jax.set_mesh(mesh):
        got = cell.run(name, kind, params)
        moved = cell.run(name, kind, one_ulp(params)) if witness else None
    out.update(got)
    if witness:   # the larger of the two movements, by output
        one = Placed(cfg, b, None).run(name, kind, params)
        for k, v in got.items():
            out["witness/" + k] = max(np.abs(moved[k] - v).max(),
                                      np.abs(one[k] - v).max())
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
from repro_torch.parallel import sharding as shd
from repro_torch.train import steps

def save(prefix, caches):
    for n, t in tree_leaves_with_names(caches):
        out[prefix + n] = t.to_local().numpy().copy()

meshes = {}
for name, arch, over, b, shape, kind, _ in cases:
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = make_mesh(shape, ("data", "model"), "cpu")
    mesh = meshes[shape]
    cfg = dataclasses.replace(get_config(arch).smoke(), **over)
    params = shd.local_tree(tree(name + "/p/", torch.from_numpy),
                            lm.serve_pspecs(cfg, mesh), mesh)
    step = steps.make_serve_step(cfg, mesh=mesh)
    cross = ENC_LEN if cfg.encoder_decoder else 0
    cspecs = shd.cache_pspecs(lm.cache_specs(cfg, b, SLOTS, cross), cfg,
                              mesh, b)
    if kind == "decode":
        token = torch.from_numpy(inp[name + "/token"]).long()
        for pos in POSITIONS:
            caches = shd.shard_tree(tree(name + "/cache/", torch.from_numpy),
                                    cspecs, mesh)
            logits, caches = step(params, caches, token, pos)
            out[f"{name}/{pos}/logits"] = logits.to_local().numpy()
            out[f"{name}/{pos}/placements"] = np.array(
                [repr(p) for p in logits.placements])
            save(f"{name}/{pos}/cache/", caches)
        continue
    batch = batch_of(name, torch.from_numpy)
    batch["tokens"] = batch["tokens"].long()
    with torch.no_grad():
        logits, caches = lm.prefill(params, batch, cfg, SLOTS, mesh=mesh)
    out[name + "/logits"] = logits.to_local().numpy()
    save(name + "/cache/", caches)
    chain = torch.from_numpy(inp[name + "/chain"]).long()
    for t in range(CHAIN):
        logits, caches = step(params, caches, chain[:, t:t + 1], PROMPT + t)
        out[f"{name}/chain{t}/logits"] = logits.to_local().numpy()
    save(name + "/chain/cache/", caches)
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


def _init_params(cfg, rng):
    """Seeded float32 weights of every leaf by the JAX package's
    ``init_params`` rule (zeros, ones, or normal * init_scale /
    sqrt(fan_in)), drawn with numpy: (name, array) pairs."""
    out = []
    for n, spec in _named(jax_lm.model_specs(cfg)):
        if spec.init in ("zeros", "ones"):
            v = (np.zeros if spec.init == "zeros" else np.ones)(spec.shape)
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            v = rng.normal(size=spec.shape) * spec.init_scale / np.sqrt(
                max(fan_in, 1))
        out.append((n, v.astype(np.float32)))
    return out


def _cfg(arch, over):
    return dataclasses.replace(jax_get_config(arch).smoke(), **over)


def _witnessed(case) -> bool:
    """Whether a case is held to the witness where it exceeds the
    tolerances: the witness arch's, and the prefills' (16 replayed steps
    and 3 more)."""
    return case[1] == WITNESS_ARCH or case in PREFILL


def _tol(runs, key, tol, want):
    """``tol``, or twice the witness where the key has one and it is
    larger: the JAX package's own movement, the larger of its run's under
    a one-ulp change of every weight and of its run on one device against
    its mesh run.  The witness must stay under 1e-2 of ``want``'s largest
    magnitude, so that the check can still fail a wrong value."""
    witness = runs["jax"].get("witness/" + key)
    if witness is None:
        return tol
    top = float(np.abs(want).max())
    assert 2 * witness <= 1e-2 * top, (key, float(witness), top)
    return max(tol, 2 * float(witness))


def _seeded_cache(cfg, b, rng):
    """Seeded caches of 64 slots (and the cross caches' frames), by leaf
    name: normal draws, sLSTM's normaliser n positive (it sums positive
    input gates from 0, so no state reaches a negative one)."""
    cross = ENC_LEN if cfg.encoder_decoder else 0
    specs = jax_lm.cache_specs(cfg, b, SLOTS, cross)
    out = {}
    slstm = [i for i, s in enumerate(cfg.pattern) if s.mixer == "slstm"]
    for n, s in _named(specs):
        v = rng.normal(size=s.shape).astype(np.float32)
        pos, leaf = n.split("/")
        if int(pos) in slstm and leaf == "n":
            v = np.abs(v) + 0.5
        out[n] = v
    return out


def _inputs(tmp):
    rng = np.random.default_rng(0)
    inp = {}
    for name, arch, over, b, _ in DECODE + PREFILL:
        cfg = _cfg(arch, over)
        for n, v in _init_params(cfg, rng):
            inp[f"{name}/p/{n}"] = v
        if name in DECODE_NAMES:
            inp[name + "/token"] = rng.integers(
                0, cfg.vocab_size, (b, 1)).astype(np.int32)
            for n, v in _seeded_cache(cfg, b, rng).items():
                inp[f"{name}/cache/{n}"] = v
            continue
        inp[name + "/b/tokens"] = rng.integers(
            0, cfg.vocab_size, (b, PROMPT)).astype(np.int32)
        inp[name + "/chain"] = rng.integers(
            0, cfg.vocab_size, (b, CHAIN)).astype(np.int32)
        if cfg.encoder_decoder:
            inp[name + "/b/enc_embeds"] = rng.normal(
                size=(b, ENC_LEN, cfg.d_model)).astype(np.float32)
    np.savez(tmp / "inputs.npz", **inp)
    return inp


def _run_all(tmp, deadline_s=DEADLINE_S):
    """Starts the JAX child and the 8 ranks together.  The first process
    to fail (a rank whose collective timed out, say) or the deadline
    stops the rest: they are killed.  Returns {name: (returncode, the
    tail of its stderr)}."""
    cases = json.dumps([c + ("decode", _witnessed(c)) for c in DECODE]
                       + [c + ("prefill", True) for c in PREFILL])
    consts = (f"SLOTS, ENC_LEN, PROMPT, CHAIN = {SLOTS}, {ENC_LEN}, "
              f"{PROMPT}, {CHAIN}\nPOSITIONS = {POSITIONS!r}\n")
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    tail = [str(tmp / "inputs.npz")]
    commands = {"jax": [sys.executable, "-c",
                        consts + textwrap.dedent(_JAX_CHILD)]
                + tail + [str(tmp / "jax.npz"), cases]}
    rank_code = consts + textwrap.dedent(_RANK)
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
    tmp = tmp_path_factory.mktemp("sharded_decode")
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


def _coords(shape):
    """Each rank's coordinates on a mesh of ``shape`` over ranks 0.. in
    row-major order, as ``make_mesh`` lays them out."""
    return [dict(zip(("data", "model"), map(int, np.unravel_index(r, shape))))
            for r in range(WORLD)]


class _ShapeMesh:
    """A shape-only mesh, as tests/test_sharding_rules.py has it."""
    axis_names = ("data", "model")

    def __init__(self, shape):
        self.shape = dict(zip(self.axis_names, shape))


def _cache_pspecs(cfg, b, shape):
    """The JAX package's PartitionSpec of each cache leaf, by name."""
    cross = ENC_LEN if cfg.encoder_decoder else 0
    return {n: tuple(p) for n, p in _named(jax_shd.cache_pspecs(
        jax_lm.cache_specs(cfg, b, SLOTS, cross), cfg, _ShapeMesh(shape),
        b))}


def _logits_spec(cfg, b, shape):
    """How the JAX package's logits (B, 1, V) are cut for a rank: the rows
    over data where the batch divides it, the vocabulary over model where
    the weights split it (the port's logits hold those columns)."""
    rows = "data" if b % shape[0] == 0 else None
    split = (cfg.shard_strategy == "megatron"
             and cfg.padded_vocab % shape[1] == 0)
    return (rows, None, "model" if split else None)


def _check(runs, key, cfg, b, shape, cache_key=None):
    """Each rank's logits (``key``/logits) and, with ``cache_key``, its
    cache slices against its blocks of the JAX package's."""
    want = runs["jax"][key + "/logits"]
    lspec = _logits_spec(cfg, b, shape)
    cspecs = _cache_pspecs(cfg, b, shape)
    tol = _tol(runs, key + "/logits", 1e-4, want)
    ctols = {}
    if cache_key is not None:
        for n in cspecs:
            full = runs["jax"][f"{cache_key}/cache/{n}"]
            tol_n = 1e-5
            if n.split("/")[-1] in RECURRENT:
                tol_n *= float(np.abs(full).max())
            ctols[n] = _tol(runs, f"{cache_key}/cache/{n}", tol_n, full)
    for coord, out in zip(_coords(shape), runs["ranks"]):
        got = out[key + "/logits"]
        np.testing.assert_allclose(
            got, want[_block(want.shape, lspec, coord, shape)], rtol=tol,
            atol=tol, err_msg=key)
        for n, spec in cspecs.items() if ctols else ():
            full = runs["jax"][f"{cache_key}/cache/{n}"]
            np.testing.assert_allclose(
                out[f"{cache_key}/cache/{n}"],
                full[_block(full.shape, spec, coord, shape)], rtol=0,
                atol=ctols[n], err_msg=f"{cache_key} {n}")


@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("case", [c[0] for c in DECODE])
def test_decode_step_matches_jax_mesh(runs, case, pos):
    """One serve step at ``pos`` from the seeded caches: each rank's
    logits and new cache slices against its blocks of the JAX package's
    mesh step; the logits a DTensor split as those blocks."""
    _, arch, over, b, shape = next(c for c in DECODE if c[0] == case)
    cfg = _cfg(arch, over)
    _check(runs, f"{case}/{pos}", cfg, b, shape, f"{case}/{pos}")
    rows, _, vocab = _logits_spec(cfg, b, shape)
    placements = ["Shard(dim=0)" if rows else "Replicate()",
                  "Shard(dim=2)" if vocab else "Replicate()"]
    for out in runs["ranks"]:
        assert list(out[f"{case}/{pos}/placements"]) == placements


@pytest.mark.parametrize("case", [c[0] for c in PREFILL])
def test_prefill_matches_jax_mesh(runs, case):
    """``prefill(..., mesh=)`` of 16 tokens into 64 slots (seamless: the
    encoder over 32 frames and the cross caches): each rank's logits of
    every position and its cache slices."""
    _, arch, over, b, shape = next(c for c in PREFILL if c[0] == case)
    _check(runs, case, _cfg(arch, over), b, shape, case)


@pytest.mark.parametrize("case", [c[0] for c in PREFILL])
def test_decode_chained_after_prefill_matches_jax_mesh(runs, case):
    """Three serve steps after the prefill, each on the caches the last
    left: each step's logits, and the caches after the third."""
    _, arch, over, b, shape = next(c for c in PREFILL if c[0] == case)
    cfg = _cfg(arch, over)
    for t in range(CHAIN):
        _check(runs, f"{case}/chain{t}", cfg, b, shape)
    _check(runs, f"{case}/chain2", cfg, b, shape, f"{case}/chain")


@pytest.mark.parametrize("case", [c[0] for c in DECODE + PREFILL])
def test_ranks_hold_only_their_cache_slices(runs, case):
    """Each rank's cache leaves have the local shapes of the JAX package's
    ``cache_pspecs`` blocks, and a leaf the rule splits is whole on no
    rank; the attention caches' slots are split wherever they divide."""
    _, arch, over, b, shape = next(c for c in DECODE + PREFILL
                                   if c[0] == case)
    cfg = _cfg(arch, over)
    key = f"{case}/{POSITIONS[0]}" if case in DECODE_NAMES else case
    cspecs = _cache_pspecs(cfg, b, shape)
    split = 0
    for coord, out in zip(_coords(shape), runs["ranks"]):
        for n, spec in cspecs.items():
            full = runs["jax"][f"{key}/cache/{n}"]
            got = out[f"{key}/cache/{n}"].shape
            assert got == full[_block(full.shape, spec, coord, shape)].shape, n
            if any(e is not None for e in spec):
                assert got != full.shape, n
                split += 1
    assert split > 0
    names = {n.split("/")[-1]: spec for n, spec in cspecs.items()}
    if "k" in names:
        seq = ("data", "model") if b == 1 else "model"
        assert names["k"][2] == seq, names["k"]


def test_witness_raised_tolerances_stay_small(runs):
    """Every tolerance that a witness raises above the stated one (1e-4
    for logits, 1e-5 for caches, relative for recurrent states), by key:
    printed (``pytest -rP`` shows them, largest first) and each under 1e-2
    of the JAX package's largest magnitude there, so that it can still
    fail a wrong value."""
    rows = []
    for wkey in (k for k in runs["jax"] if k.startswith("witness/")):
        key = wkey[len("witness/"):]
        want = runs["jax"][key]
        top = float(np.abs(want).max())
        stated = 1e-4 if key.endswith("/logits") else 1e-5 * (
            top if key.split("/")[-1] in RECURRENT else 1.0)
        tol = _tol(runs, key, stated, want)
        if tol > stated:
            rows.append((tol / top, key, stated, tol, top))
    for rel, key, stated, tol, top in sorted(rows, reverse=True):
        print(f"{key}: stated {stated:.3g}, held to {tol:.3g} "
              f"({rel:.3g} of the largest magnitude {top:.4g})")
    assert rows, "no witness raised a tolerance"
    assert all(rel <= 1e-2 for rel, *_ in rows)
