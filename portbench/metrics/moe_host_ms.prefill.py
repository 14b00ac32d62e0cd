"""MoE layer: host milliseconds a step inside the ``moe.forward`` spans
(one a layer, nested in the step's ``lm.forward``), the mean over the
window's steps.  The layer launches its work without waiting for the
card, so this is its launch time, or the card's pace where something in
the layer syncs with the host (``d2h_bytes`` counts what it reads
back)."""
from statistics import fmean

from portbench.spans import named, window_spans


def read(r, spans=None):
    got = window_spans(r, spans) or []
    moes = named(got, "moe.forward")
    steps = named(got, "lm.forward")
    if not moes or not steps:
        return None
    return 1e3 * fmean(
        sum(m["end_ns"] - m["start_ns"] for m in moes
            if f["start_ns"] <= m["start_ns"] and m["end_ns"] <= f["end_ns"])
        / 1e9 for f in steps)
