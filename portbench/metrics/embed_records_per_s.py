"""Embedder: records per second of the port's ``embed_all`` over the
cell's records with one build's weights, timed alone by a synchronised
host clock after the window (the driver's probe)."""


def read(r):
    return r.probe("embed_records_per_s")
