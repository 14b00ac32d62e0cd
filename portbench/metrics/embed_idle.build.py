"""Device: the share of the ``tasti.embed`` spans' time in which no
kernel, copy or set ran on the device (the union of the profiler's device
intervals), the mean over the window's builds."""
from portbench.spans import idle_share


def read(r, spans=None):
    return idle_share(r, "tasti.embed", spans)
