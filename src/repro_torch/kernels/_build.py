"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, and loaded with
:mod:`ctypes`.  No source includes PyTorch's headers, which would cost
minutes per build.  The libraries land in ``build/kernels/`` at the
repository root, named by a hash of all sources and flags: an unchanged
tree is never rebuilt, and a changed one never loads a stale library.  All
sources compile in parallel, one ``nvcc`` each.

Nothing here runs at import time; the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


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


def sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str, digest: str) -> pathlib.Path:
    return build_dir() / f"{name}-{digest}.so"


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every kernel source that has no library for the current
    hash, all in parallel; returns ``{kernel name: library path}``.  The
    compiler's register/spill report goes to ``<name>-<hash>.log``."""
    digest = sources_hash()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {p.stem: _lib_path(p.stem, digest)
             for p in sorted(CSRC.glob("*.cu"))}
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


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if status != 0:
        msg = lib.repro_error_string(status).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({status})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
