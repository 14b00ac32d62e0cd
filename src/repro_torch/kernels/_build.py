"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, and loaded with
:mod:`ctypes`.  No source includes PyTorch's headers, which would cost
minutes per build.  The libraries land in ``build/kernels/`` at the
repository root, each named by a hash of its own source, the ``csrc``
headers it includes and the flags: an unchanged kernel is never rebuilt, a
changed one never loads a stale library, and editing one source rebuilds
that library alone.  What needs building compiles in parallel, one
``nvcc`` per source.

Nothing here runs at import time; the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from contextlib import contextmanager
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}
#: the open traces of :func:`trace_kernels`
_traces: List[list] = []


def build_dir() -> pathlib.Path:
    return CSRC.parents[2] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME   # CUDA_HOME, CUDA_PATH
    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME to "
                       "build the CUDA kernels")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _includes(path: pathlib.Path, seen=None) -> list:
    """The ``csrc`` headers that ``path`` includes, directly or not."""
    seen = set() if seen is None else seen
    for name in _INCLUDE.findall(path.read_text()):
        dep = CSRC / name
        if dep.exists() and dep not in seen:
            seen.add(dep)
            _includes(dep, seen)
    return sorted(seen)


def source_hash(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, the headers it includes and the flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src, *_includes(src)]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> pathlib.Path:
    return build_dir() / f"{name}-{source_hash(name)}.so"


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every kernel source that has no library for its current
    hash, all in parallel; returns ``{kernel name: library path}``.  The
    compiler's register/spill report goes beside each library, as
    ``<name>-<hash>.log``."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {p.stem: _lib_path(p.stem) for p in sorted(CSRC.glob("*.cu"))}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(path.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, todo[name])     # atomic: concurrent builds agree
        else:
            failed.append(name)
    if failed:
        logs = "\n".join(todo[n].with_suffix(".log").read_text()
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (``csrc/<name>.cu``), building
    every kernel first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            for n, p in paths.items():
                _libs[n] = ctypes.CDLL(str(p))
                _libs[n].repro_error_string.argtypes = [ctypes.c_int]
                _libs[n].repro_error_string.restype = ctypes.c_char_p
            lib = _libs[name]
        return lib


def bind(name: str, symbol: str, argtypes: list):
    """The launcher ``symbol`` of kernel ``name``, its argument types set
    once (ctypes.c_void_p for pointers and the stream, c_int, c_float) and
    an int (a cudaError_t) returned."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(name: str, status: int, what: str) -> None:
    """Raise if a launcher of kernel ``name`` returned a CUDA error code."""
    if status != 0:
        msg = load(name).repro_error_string(status).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({status})")


def count_launch(wrapper, path=None) -> None:
    """Add one to ``wrapper.launches`` and, given a ``path``, to
    ``wrapper.launches_by_path[path]``, under a lock: serving threads
    launch concurrently."""
    with _count_lock:
        wrapper.launches += 1
        if path is not None:
            wrapper.launches_by_path[path] += 1


@contextmanager
def trace_kernels():
    """While open, every kernel call that a wrapper takes on tensors with
    no data (``device.is_traced``: the dry run's fake tensors) appends
    ``(kernel, path, flops, bytes)`` to the list it yields; such a call
    launches nothing and adds nothing to the wrapper's launch count."""
    rec: list = []
    with _count_lock:
        _traces.append(rec)
    try:
        yield rec
    finally:
        with _count_lock:
            _traces.remove(rec)


def count_traced(wrapper, path: str, flops: float, nbytes: int) -> None:
    """Record a traced call of ``wrapper``'s kernel on ``path`` in every
    open :func:`trace_kernels`."""
    with _count_lock:
        for rec in _traces:
            rec.append((wrapper.__name__, path, float(flops), int(nbytes)))


def refuse_grad(name: str, *tensors) -> None:
    """Raise if grad mode is on and a tensor input requires grad: a kernel's
    output (written through ctypes into ``torch.empty``) has no
    ``grad_fn``, so launching would cut the gradient without a word.  No
    kernel of the port has a backward; training takes the plain route."""
    import torch
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {name} kernel has no backward and an input requires "
            f"grad: call it under torch.no_grad(), or take the plain "
            f"route (attn_impl='plain', or the {name} ref.py) to train "
            f"through it")


def aligned16(t):
    """t, contiguous, at a 16-byte aligned address (TMA and 16-byte loads
    need one): a copy only where the view is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
