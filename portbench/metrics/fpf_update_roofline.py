"""Kernels: ``fpf_update``'s share of its roofline, the least time the
H100's published peaks allow its launches over their own device time
(``fpf_update_kernel`` and its ``fpf_finalize_kernel``).  A launch reads
the (N, D) float32 embeddings, the newest representative and the N-vector
of nearest distances once and writes that vector once; it does 3 N D
operations (difference, square, sum) against float32's peak."""
from portbench.peaks import least_seconds


def ops_bytes(n: int, d: int):
    return 3.0 * n * d, 4.0 * (n * d + d + 2 * n)


def read(r):
    if not r.traced:
        return None
    launches = r.capture.count(r"fpf_update_kernel")
    if not launches:
        return None
    t = r.capture.seconds(r"fpf_update_kernel|fpf_finalize_kernel")
    flops, nbytes = ops_bytes(r.shape["records"], r.shape["embed_dim"])
    return 100.0 * launches * least_seconds(flops, nbytes, "float32") / t
