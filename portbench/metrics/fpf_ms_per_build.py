"""Index: milliseconds of FPF selection a build, the ``tasti.fpf`` spans'
time on the host clock (6,299 ``fpf_update`` steps, the chosen ids read
back, the random mix), the mean over the window's builds."""
from portbench.spans import named, per_build, seconds


def _ms(build, inner):
    fpf = named(inner, "tasti.fpf")
    return 1e3 * seconds(fpf) if fpf else None


def read(r, spans=None):
    return per_build(r, spans, _ms)
