"""Index: device milliseconds of copies a build, from the profiler's
copy records over the window (the embeddings' round trip: down in
``embed_all``, up in ``TastiIndex.build``, and the records' upload)."""


def read(r):
    if not r.traced or not r.window.units:
        return None
    return 1e3 * r.capture.copy_seconds() / r.window.units
