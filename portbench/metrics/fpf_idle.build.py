"""Device: the share of the ``tasti.fpf`` spans' time (the selection
loop, its ids read back and the random mix) in which no kernel, copy or
set ran on the device, the mean over the window's builds."""
from portbench.spans import idle_share


def read(r, spans=None):
    return idle_share(r, "tasti.fpf", spans)
