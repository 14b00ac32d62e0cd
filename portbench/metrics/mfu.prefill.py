"""Model step: the whole step's share of the card's peak: the least
seconds the window's model FLOPs take at the H100's published peak for
their type (the driver's ``peak_seconds_per_unit``: for a bf16 decoder,
``portbench.flops`` at each step's shape and the published vocabulary
over 989 TFLOP/s) over the window's seconds."""


def read(r):
    w = r.window
    if not w.units or "peak_seconds_per_unit" not in r.shape:
        return None
    return 100.0 * w.units * r.shape["peak_seconds_per_unit"] / w.seconds
