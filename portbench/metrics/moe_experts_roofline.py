"""Kernels: the experts' grouped products' share of their roofline: the
least time the H100's published peaks allow the window's expert products
over those products' own device time.  A layer's experts do 6 T k d f
operations (gate, up and down over its T k (token, choice) rows) against
bfloat16's peak, and read their weights once (3 E d f) and the T tokens
once and write them once (2 T d), in bfloat16, whatever the
implementation moves; a window of closed-loop units holds units x layers
such layers.  The kernels are those of ``torch._grouped_mm`` in the card's
trace (torch 2.11: CUTLASS's sm90 grouped GEMM, ``cutlass::device_kernel<
... GemmUniversal<GroupProblemShape<...>, ... ArrayTmaGmmaWarpSpecialized
...>>``, three a layer, and its ``prepare_grouped_gemm_data``), or any
whose name holds ``moe_experts``, the name a later hand-written kernel
takes."""
from portbench.peaks import least_seconds

KERNELS = r"GroupProblemShape|prepare_grouped_gemm_data|moe_experts"


def ops_bytes(tokens: int, k: int, d: int, f: int, experts: int):
    return 6.0 * tokens * k * d * f, 2.0 * (3 * experts * d * f
                                            + 2 * tokens * d)


def read(r):
    s = r.shape
    if not r.traced or "n_experts" not in s or not r.window.units:
        return None
    t = r.capture.seconds(KERNELS)
    if not t:
        return None
    flops, nbytes = ops_bytes(s["batch"] * s["seq"], s["top_k"],
                              s["hidden_size"], s["moe_d_ff"], s["n_experts"])
    return (100.0 * r.window.units * s["layers"]
            * least_seconds(flops, nbytes, "bfloat16") / t)
