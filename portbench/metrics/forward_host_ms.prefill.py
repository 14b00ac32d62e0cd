"""Model step: host milliseconds to launch a forward, the mean of the
window's ``lm.forward`` spans.  The forward does not wait for the card,
so this is the host's launch time plus any wait on a full launch queue
or a sync inside the forward."""
from statistics import fmean

from portbench.spans import named, window_spans


def read(r, spans=None):
    fwd = named(window_spans(r, spans) or [], "lm.forward")
    if not fwd:
        return None
    return 1e3 * fmean((s["end_ns"] - s["start_ns"]) / 1e9 for s in fwd)
