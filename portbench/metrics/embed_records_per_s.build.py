"""Embedder: records per second of ``embed_all`` inside the window's
builds: the records of each build's ``tasti.embed`` span over its seconds
on the host clock (the span ends with the embeddings on the host, so it
holds all of the stage's device work), the mean over the builds.  The
in-window counterpart of the probe ``embed_records_per_s``."""
from portbench.spans import named, per_build, seconds


def _rate(build, inner):
    embed = named(inner, "tasti.embed")
    t = seconds(embed)
    return sum(s["attrs"].get("records", 0) for s in embed) / t if t else None


def read(r, spans=None):
    return per_build(r, spans, _rate)
