"""Kernels: ``distance_topk``'s share of its roofline, the least time the
H100's published peaks allow its calls over their own device time (the
distance kernel on either route and the row norms it takes).  A call on
N records, C representatives of D float32 dims and k nearest does 2 N C D
operations, counted against the TF32 tensor peak whatever the route, and
reads N D + C D floats and writes N k (distance, id) pairs of 8 bytes."""
from portbench.peaks import least_seconds


def ops_bytes(n: int, c: int, d: int, k: int):
    return 2.0 * n * c * d, 4.0 * (n * d + c * d) + 8.0 * n * k


def read(r):
    if not r.traced:
        return None
    calls = r.capture.count(r"distance_topk(_tc)?_kernel")
    if not calls:
        return None
    t = r.capture.seconds(r"distance_topk(_tc)?_kernel|row_sqnorm_kernel")
    s = r.shape
    flops, nbytes = ops_bytes(s["records"], s["reps"], s["embed_dim"], s["k"])
    return 100.0 * calls * least_seconds(flops, nbytes, "tf32") / t
