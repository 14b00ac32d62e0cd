"""Kernels: ``rmsnorm``'s share of its roofline, the least time the H100's
published peaks allow its launches over their own device time
(``rmsnorm_kernel``).  A launch on the step's (batch x seq, d) bfloat16
hidden states reads x and writes y once and reads the scale once, and does
4 operations an element (square, sum, two products) against float32's
peak; whatever the implementation moves.  d is the shape's ``hidden_size``
where the driver gives one, else heads x head_dim.  The prefill driver
gives none today and takes no configuration with qk-norm (rows of
head_dim), so the share holds for a hidden width of heads x head_dim, as
phi3-medium-14b's 5,120 = 40 x 128; for any other it counts the wrong
bytes until the driver's ``shape()`` gives ``hidden_size``."""
from portbench.peaks import least_seconds


def ops_bytes(rows: int, d: int):
    return 4.0 * rows * d, 2.0 * 2 * rows * d + 2.0 * d


def read(r):
    if not r.traced:
        return None
    launches = r.capture.count(r"rmsnorm_kernel")
    if not launches:
        return None
    t = r.capture.seconds(r"rmsnorm_kernel")
    s = r.shape
    d = s.get("hidden_size", s["heads"] * s["head_dim"])
    flops, nbytes = ops_bytes(s["batch"] * s["seq"], d)
    return 100.0 * launches * least_seconds(flops, nbytes, "float32") / t
