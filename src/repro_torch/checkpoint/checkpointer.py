"""Checkpointing: async npz save, manifest, atomic rename, garbage
collection — the on-disk layout of ``repro.checkpoint.checkpointer``.

* ``step_XXXXXXXX/arrays.npz`` holds leaf ``i`` as ``a{i}``, leaves in the
  JAX package's flattening order (dict keys sorted); ``manifest.json`` holds
  the step, each leaf's name (its path's keys and indices joined by ``/``),
  shape and dtype, the caller's ``extra`` and the time.
* ``save_async`` snapshots every leaf to host memory before it returns and
  writes on a background thread — the train loop never blocks on I/O.
* Atomicity: write to ``step_XXXX.tmp`` then rename; interrupted writes are
  invisible to ``latest_step``.  ``keep`` bounds the steps kept.

bfloat16 leaves are stored as float32 under manifest dtype ``bfloat16``,
as the JAX package stores them (numpy has no bfloat16 without
``ml_dtypes``; float32 holds every bfloat16 value exactly), so a
checkpoint restores leaf for leaf in either package.  ``restore`` also
reads the raw-bits form earlier versions of this package wrote (uint16
under manifest ``bfloat16``).
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models.common import (PyTree, tree_leaves_with_names,
                                       tree_unflatten_like)
from repro_torch.parallel.sharding import shard_tensor


def _host(leaf) -> np.ndarray:
    """A leaf (tensor, numpy array or number) as a host array of its own,
    bfloat16 as float32.  Always a copy: ``.cpu()`` of a CPU tensor is the
    tensor itself, which the train step goes on updating in place."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy()        # .float() copies
        return t.numpy().copy()
    a = np.asarray(leaf)
    if a.dtype == object:
        raise TypeError("checkpoint leaves must be numeric arrays; carry run "
                        "metadata via the `extra` dict instead")
    return a.copy()


def _snapshot(tree: PyTree):
    pairs = tree_leaves_with_names(tree)
    names = [n for n, _ in pairs]
    dtypes = [str(v.dtype).replace("torch.", "") if isinstance(
        v, torch.Tensor) else str(np.asarray(v).dtype) for _, v in pairs]
    return names, [_host(v) for _, v in pairs], dtypes


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: PyTree,
             extra: Optional[Dict] = None) -> None:
        self._write(step, *_snapshot(tree), extra or {})

    def save_async(self, step: int, tree: PyTree,
                   extra: Optional[Dict] = None) -> None:
        self.wait()
        snap = _snapshot(tree)          # device -> host before returning

        def work():
            self._write(step, *snap, extra or {})

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, names, host, dtypes, extra: Dict) -> None:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz",
                 **{f"a{i}": a for i, a in enumerate(host)})
        manifest = {
            "step": step,
            "names": names,
            "shapes": [list(a.shape) for a in host],
            "dtypes": dtypes,
            "extra": extra,
            "time": time.time(),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: PyTree,
                shardings: Optional[PyTree] = None):
        """A new tree of ``target``'s layout, each leaf read from step
        ``step`` as a tensor of the target leaf's dtype on its device (the
        CPU for a number, a numpy leaf or a ``meta`` tensor, as
        ``abstract_params`` gives); returns (tree, extra).

        With ``shardings`` (a tree of ``parallel.sharding.NamedSharding``
        of the same layout, ``None`` for a leaf kept whole) each such leaf
        becomes a DTensor on its sharding's mesh: every rank reads the file
        and keeps its own slice, on the mesh's device type.  This is the
        elastic-resharding path: the file holds no sharding, so a
        checkpoint written under one mesh restores onto any other."""
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        pairs = tree_leaves_with_names(target)
        names = [n for n, _ in pairs]
        if names != manifest["names"]:
            raise ValueError("checkpoint/target tree mismatch")
        placed = ([None] * len(pairs) if shardings is None else
                  _sharding_leaves(target, shardings))
        out = []
        with np.load(d / "arrays.npz") as data:
            for i, (_, tgt) in enumerate(pairs):
                arr = data[f"a{i}"]
                if manifest["dtypes"][i] == "bfloat16" and arr.dtype == np.uint16:
                    # the raw bits earlier versions of the port wrote
                    t = torch.from_numpy(arr.view(np.int16).copy()).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(np.array(arr))
                if isinstance(tgt, torch.Tensor):
                    dtype = tgt.dtype
                    device = ("cpu" if placed[i] is not None or tgt.is_meta
                              else tgt.device)
                else:
                    dtype = torch.from_numpy(np.asarray(tgt)).dtype
                    device = "cpu"
                t = t.to(device=device, dtype=dtype)
                if placed[i] is not None:
                    t = shard_tensor(t, placed[i])
                out.append(t)
        return tree_unflatten_like(target, out), manifest["extra"]


def _sharding_leaves(target: PyTree, shardings: PyTree) -> list:
    """``shardings``' leaves in the order of ``target``'s leaves."""
    by_name = dict(tree_leaves_with_names(shardings))
    return [by_name.get(name) for name, _ in tree_leaves_with_names(target)]
