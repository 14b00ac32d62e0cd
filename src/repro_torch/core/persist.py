"""Atomic file writes for on-disk artifacts (index, label store).

A crash mid-save must never leave a torn ``.meta.json``/``.npz`` pair on
disk: every writer in this repo goes through :func:`atomic_write`, which
writes to a temp file in the destination directory, fsyncs, and renames into
place.  ``os.replace`` is atomic on POSIX (and on Windows for same-volume
paths), so readers only ever observe the old file or the complete new one.
"""
from __future__ import annotations

import contextlib
import os
import pathlib
import tempfile
from typing import IO, Iterator, Union


@contextlib.contextmanager
def atomic_write(path: Union[str, os.PathLike], mode: str = "w"
                 ) -> Iterator[IO]:
    """Context manager yielding a file object whose contents replace
    ``path`` atomically on clean exit (and are discarded on error).

        with atomic_write(p, "wb") as f:
            np.savez(f, ...)
    """
    if "r" in mode or "a" in mode or "+" in mode:
        raise ValueError(f"atomic_write is write-only, got mode {mode!r}")
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
