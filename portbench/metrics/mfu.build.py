"""Index: the whole build's share of the card's peak: the least seconds
the window's model FLOPs take at the H100's published peaks (the driver's
``peak_seconds_per_unit``: the embedder's forward and FPF's distances in
float32 at 67 TFLOP/s, the top-k distances at TF32's 494.7) over the
window's seconds."""


def read(r):
    w = r.window
    if not w.units or "peak_seconds_per_unit" not in r.shape:
        return None
    return 100.0 * w.units * r.shape["peak_seconds_per_unit"] / w.seconds
