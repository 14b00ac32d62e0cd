"""Kernels: ``flash_attention``'s share of its roofline on the tc path,
the least time the H100's published peaks allow its launches over their
own device time (``flash_tc_kernel``).  A causal launch on q (B, S, H, hd)
against k, v (B, S, Hk, hd) in bfloat16 does 4 hd operations for each of
the B H S (S + 1) / 2 unmasked (query, key) pairs against bfloat16's peak,
and reads q, k, v and writes o once."""
from portbench.peaks import least_seconds


def ops_bytes(b: int, s: int, h: int, hk: int, hd: int):
    pairs = s * (s + 1) / 2
    return 4.0 * hd * b * h * pairs, 2.0 * hd * (2 * b * s * h + 2 * b * s * hk)


def read(r):
    if not r.traced:
        return None
    launches = r.capture.count(r"flash_tc_kernel")
    if not launches:
        return None
    t = r.capture.seconds(r"flash_tc_kernel")
    s = r.shape
    flops, nbytes = ops_bytes(s["batch"], s["seq"], s["heads"], s["kv_heads"],
                              s["head_dim"])
    return 100.0 * launches * least_seconds(flops, nbytes, "bfloat16") / t
