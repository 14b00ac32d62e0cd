"""Device: the share of the traced window in which no kernel, copy or set
ran on the device (the union of their intervals from the profiler)."""


def read(r):
    if not r.traced or r.window.seconds <= 0:
        return None
    return 100.0 * (1.0 - r.capture.busy_s() / r.window.seconds)
