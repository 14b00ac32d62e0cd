"""Index: milliseconds a build spends outside its device stages: the
``tasti.build`` span less its ``tasti.embed``, ``tasti.fpf`` and
``tasti.topk`` spans (loading the embedder, annotating the
representatives, uploading the embeddings, the glue between), the mean
over the window's builds."""
from portbench.spans import STAGES, per_build, seconds


def _ms(build, inner):
    stages = [s for s in inner if s["name"] in STAGES]
    return 1e3 * (seconds([build]) - seconds(stages))


def read(r, spans=None):
    return per_build(r, spans, _ms)
