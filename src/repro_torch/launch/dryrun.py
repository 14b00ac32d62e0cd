"""Multi-pod dry run: trace one rank's step of an (arch x shape x mesh) cell.

The JAX package lowers and compiles each cell for 512 forced host devices
and reads XLA's cost and memory analyses.  The port has no compiler; its
dry run traces the step of **one rank** (rank 0 unless ``--rank``) in this
process, eagerly, on tensors without data, and allocates nothing on any
device:

* the mesh: a ``DeviceMesh`` of the production shape (``launch.mesh``)
  over a ``"fake"`` process group of 256 or 512 ranks (``host``: the (1, 1)
  mesh of one);
* the arguments: the rank's slices of every argument as ``meta`` tensors
  (``launch.specs``).  The steps take the card's own paths (``attn_impl``,
  ``flash_route``): the one branch of a traced step that reads the device
  type, the kernel wrappers', takes a tensor without data
  (``device.is_traced``) to the kernel's traced call, as it would a
  ``FakeTensorMode`` CUDA tensor.  Meta tensors rather than
  ``FakeTensorMode``'s: a CPU build of PyTorch cannot index a fake CUDA
  tensor, and a fake tensor's op costs ~0.5 ms against a meta tensor's
  ~0.05-0.2 ms, which a sequential scan's hundreds of thousands of ops
  feel;
* the collectives: recorded at ``parallel.collectives``
  (``launch.wire.count_collectives``); the fake group runs none;
* the rest in one pass over the aten ops (:class:`Tally`): flops by
  ``torch.utils.flop_counter``'s formulas (the kernels' registered too),
  bytes accessed as each op's input and output bytes but views' and
  allocations', before any fusion, as XLA's pre-fusion count,
  transcendentals, and the peak of live storages, every argument live
  from the start (temporaries: the peak less the arguments and the new
  outputs);
* argument and output bytes: the exact sums of the rank's slices.  An
  argument that the step never reads is left out, as ``jax.jit`` prunes
  unused arguments (``keep_unused=False``); the decode position, which the
  port reads on the host, is always counted.

The port runs every layer in Python, so the trace counts every layer's
work and every layer's collectives: ``loop_trip_counts`` is always ``{}``.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --arch ... --shape ... --mesh multi --block

Writes one JSON per cell to ``experiments/dryrun_torch/`` (the JAX
package's go to ``experiments/dryrun/``).  A dry run owns its process's
default process group: run each cell in a process of its own
(``run_all_dryruns``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
import weakref
from contextlib import contextmanager
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import SHAPE_BY_NAME, cell_is_runnable, get_config
from repro_torch.configs.base import ShapeConfig

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")
#: the mesh of each ``--mesh``: (shape, dim names)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "host": ((1, 1), ("data", "model"))}

_aten = torch.ops.aten
#: ops that allocate or read a value on the host and move no bytes
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.new_empty.default, _aten.new_empty_strided.default,
               _aten.empty_like.default, _aten.detach.default,
               _aten.lift_fresh.default, _aten._local_scalar_dense.default}
#: ops whose every output element is a transcendental
_TRANSCENDENTAL = {getattr(_aten, n) for n in (
    "exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid",
    "rsqrt", "sqrt", "sin", "cos", "erf", "silu", "gelu", "softplus",
    "pow", "_softmax", "_log_softmax", "logsumexp", "logit")}


def _flat(args) -> list:
    """The tensors of an op's arguments (and of the lists among them)."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _key(x):
    """A hashable stand-in for an op argument: a tensor's metadata, a
    value, or None where there is none (the call is then not cached)."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device, x.requires_grad)
    if isinstance(x, (list, tuple)):
        keys = tuple(_key(v) for v in x)
        return None if any(k is None for k in keys) else (type(x), keys)
    try:
        hash(x)
    except TypeError:
        return None
    return x


class Tally(TorchDispatchMode):
    """One pass over every aten op of a trace on meta tensors, counting:

    * ``flops``: by ``torch.utils.flop_counter``'s formulas (the matmuls,
      attention, and each kernel's own: ``register_flop_formula``);
    * ``bytes``: each op's input and output bytes but views' and
      allocations';
    * ``transcendentals``: the output elements of :data:`_TRANSCENDENTAL`;
    * ``peak``: the most bytes of live storages (a storage counts from the
      first op that sees it until it is freed);
    * ``read``: the storages that an op but a view took as input.

    A functional aten op met again on inputs of the same metadata returns a
    new meta tensor of the output it gave before without running its meta
    function again: a sequential scan repeats one op thousands of times,
    and a meta function costs ~100-500 us.  The counts are those of running
    it.  Other ops (a kernel's custom op, which records its traced call)
    always run.
    """

    def __init__(self, live=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.read = set()
        self._live = {}
        self.live_bytes = 0
        self.peak = 0
        self._shapes = {}
        for t in live:
            self._see(t)

    def _see(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = weakref.ref(st, lambda _, k=key, n=n: self._free(k, n))
        self.live_bytes += n
        self.peak = max(self.peak, self.live_bytes)

    def _free(self, key: int, n: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= n

    def _run(self, func, args, kwargs):
        schema = func._schema
        if func.namespace != "aten" or func.is_view or schema.is_mutable or \
                any(r.alias_info is not None for r in schema.returns):
            return func(*args, **kwargs)
        key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
        if key[1] is None or key[2] is None:
            return func(*args, **kwargs)
        meta = self._shapes.get(key)
        if meta is None:
            out = func(*args, **kwargs)
            single = isinstance(out, torch.Tensor)
            outs = [out] if single else list(out) if isinstance(
                out, (list, tuple)) else None
            if outs is not None and all(isinstance(o, torch.Tensor)
                                        and o.device.type == "meta"
                                        for o in outs):
                self._shapes[key] = (single, [(o.shape, o.stride(), o.dtype)
                                              for o in outs])
            return out
        single, shapes = meta
        outs = [torch.empty_strided(shp, st, dtype=dt, device="meta")
                for shp, st, dt in shapes]
        return outs[0] if single else tuple(outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        inputs = _flat(args) + _flat(kwargs.values())
        outputs = _flat(out if isinstance(out, (list, tuple)) else (out,))
        for t in inputs:
            self._see(t)
        for t in outputs:
            self._see(t)
        packet = func.overloadpacket
        if func not in _NO_TRAFFIC and not func.is_view:
            for t in inputs:
                self.read.add(_storage(t))
            self.bytes += sum(t.numel() * t.element_size()
                              for t in inputs + outputs)
        if packet in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outputs)
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out


@contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A ``"fake"`` default process group of ``world_size`` ranks, this
    process rank ``rank``: every collective on it returns at once and moves
    nothing.  Destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a dry run needs a process of its own: this "
                           "process has a default process group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def configure(arch: str, overrides: Optional[dict]):
    """The arch's config with ``overrides`` (strings typed as the field)."""
    cfg = get_config(arch)
    if overrides:
        typed = {}
        for k, v in overrides.items():
            cur = getattr(cfg, k)
            typed[k] = type(cur)(v) if cur is not None else v
        cfg = dataclasses.replace(cfg, **typed)
    return cfg


def trace(cell) -> dict:
    """Run ``cell``'s step once on its meta arguments; what it cost."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels import _build
    from repro_torch.launch import wire
    from repro_torch.models.common import tree_leaves

    def tensors(tree) -> list:
        return [t.to_local() if isinstance(t, DTensor) else t
                for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]

    def nbytes(ts) -> int:
        return sum({_storage(t): t.untyped_storage().nbytes()
                    for t in ts}.values())

    arg_leaves = [tensors(a) for a in cell.args]
    every_arg = [t for ts in arg_leaves for t in ts]
    tally = Tally(live=every_arg)
    t0 = time.time()
    with tally, wire.count_collectives() as coll, \
            _build.trace_kernels() as kernels:
        out = cell.fn(*cell.args)
    trace_s = time.time() - t0
    arg_storages = {_storage(t) for t in every_arg}
    argument_bytes = sum(
        spec.local_bytes
        for i, (ts, specs) in enumerate(zip(arg_leaves, cell.specs))
        for t, spec in zip(ts, tree_leaves(specs))
        if i in cell.host or _storage(t) in tally.read)
    out_leaves = tensors(out)
    fresh = nbytes([t for t in out_leaves if _storage(t) not in arg_storages])
    launches: dict = {}
    for name, path, _, _ in kernels:
        by_path = launches.setdefault(name, {})
        by_path[path] = by_path.get(path, 0) + 1
    coll_sum = coll.summary()
    return {
        "trace_s": round(trace_s, 3),
        "flops_per_device": float(tally.flops),
        "bytes_accessed_per_device": float(tally.bytes),
        "transcendentals": float(tally.transcendentals),
        "peak_memory_bytes": int(tally.peak),
        "argument_bytes": int(argument_bytes),
        "output_bytes": int(sum(t.numel() * t.element_size()
                                for t in out_leaves)),
        "temp_bytes": int(max(0, tally.peak - nbytes(every_arg) - fresh)),
        "wire_bytes_per_device": coll_sum["wire_bytes_per_device"],
        "collective_op_counts": coll_sum["op_counts"],
        "loop_trip_counts": coll_sum["loops"],
        "kernel_launches": launches,
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, block: bool = False,
             attn_impl: Optional[str] = None, overrides: dict = None,
             rank: int = 0, batch: Optional[int] = None) -> dict:
    """Trace rank ``rank``'s step of the cell in this process (which must
    have no default process group); ``batch`` cuts the shape's global
    batch."""
    from repro_torch.launch import specs as specs_lib
    from repro_torch.launch.mesh import make_mesh

    cfg = configure(arch, overrides)
    shape = SHAPE_BY_NAME[shape_name]
    if batch:
        shape = ShapeConfig(shape.name, shape.seq_len, batch, shape.kind)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "block": block, "status": "skipped"}
    if not cell_is_runnable(arch, shape):
        result["reason"] = ("long_500k requires sub-quadratic attention; "
                            f"{arch} is pure full-attention (DESIGN.md §6)")
        return result
    dims, names = MESHES[mesh_kind]
    n = 1
    for d in dims:
        n *= d
    with fake_world(n, rank):
        # the mesh's device type is read by no traced step
        mesh = make_mesh(dims, names, device_type="cpu")
        build = specs_lib.build_block_cell if block else specs_lib.build_cell
        cell = build(cfg, shape, mesh, attn_impl=attn_impl)
        cost = trace(cell)
    result.update({
        "status": "ok",
        "overrides": overrides or {},
        "kind": cell.static["kind"],
        "n_devices": n,
        "rank": rank,
        "global_batch": shape.global_batch,
        "device": "meta",
        **cost,
        "n_repeats": cfg.n_repeats,
    })
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=sorted(MESHES), default="single")
    ap.add_argument("--block", action="store_true",
                    help="trace one layer-block (the per-block cost)")
    ap.add_argument("--attn-impl", default=None,
                    help="kernel or plain (default: each step's own: the "
                         "kernel for prefill, plain for training)")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose step is traced")
    ap.add_argument("--batch", type=int, default=0,
                    help="cut the shape's global batch to this")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. shard_strategy=pure_dp)")
    ap.add_argument("--tag", default="", help="variant suffix for the output file")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{args.arch}__{args.shape}__{args.mesh}" + ("__block" if args.block else "")
    if args.tag:
        tag += f"__{args.tag}"
    out_path = out_dir / f"{tag}.json"
    overrides = dict(kv.split("=", 1) for kv in args.set)

    try:
        result = run_cell(args.arch, args.shape, args.mesh, block=args.block,
                          attn_impl=args.attn_impl, overrides=overrides,
                          rank=args.rank, batch=args.batch or None)
    except Exception as e:  # record failures as data, not crashes
        result = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
                  "block": args.block, "status": "error",
                  "overrides": overrides,
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    out_path.write_text(json.dumps(result, indent=2))
    status = result["status"]
    extra = ""
    if status == "ok":
        extra = (f" trace={result['trace_s']}s"
                 f" flops/dev={result['flops_per_device']:.3e}"
                 f" peak={result['peak_memory_bytes']}")
    elif status == "error":
        extra = " " + result["error"][:200]
    print(f"[dryrun] {tag}: {status}{extra}")


if __name__ == "__main__":
    main()
