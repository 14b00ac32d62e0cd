"""Kernels: the dropless MoE's combine's share of its roofline: the least
time the H100's published peaks allow the window's combines over the
device time of the kernels whose names hold ``moe_combine`` (the port's
hand-written combine and the positions it makes for it).  A layer's
combine reads the T k bfloat16 rows of the experts' outputs and the T k
float32 router weights and writes the T bfloat16 output rows once, and
does 2 T k d operations against float32's peak, whatever the
implementation moves (the rows' order, an index list, is the
implementation's and not counted); a window of closed-loop units holds
units x layers such layers.  A program without the kernel (the eager
scatter-add) launches nothing of that name, and the reader gives
nothing."""
from portbench.peaks import least_seconds

KERNELS = r"moe_combine"


def ops_bytes(tokens: int, k: int, d: int):
    return 2.0 * tokens * k * d, (2.0 * tokens * k * d + 4.0 * tokens * k
                                  + 2.0 * tokens * d)


def read(r):
    s = r.shape
    if not r.traced or "n_experts" not in s or not r.window.units:
        return None
    t = r.capture.seconds(KERNELS)
    if not t:
        return None
    flops, nbytes = ops_bytes(s["batch"] * s["seq"], s["top_k"],
                              s["hidden_size"])
    return (100.0 * r.window.units * s["layers"]
            * least_seconds(flops, nbytes, "float32") / t)
