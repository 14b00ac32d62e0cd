"""Index: the rate of the build's host-device copies: the bytes the
window's builds counted on their spans (``h2d_bytes`` and ``d2h_bytes``:
the records up, the embeddings down and up, the top-k lists down, the
embedder's weights) over the device seconds of the profiler's HtoD and
DtoH copy records, in GB/s."""
from portbench.spans import builds


def read(r, spans=None):
    nbytes = sum(s["attrs"].get(k, 0) for b, inner in builds(r, spans)
                 for s in [b] + inner for k in ("h2d_bytes", "d2h_bytes"))
    t = r.capture.seconds(r"HtoD|DtoH", what="copy")
    return nbytes / t / 1e9 if nbytes and t else None
