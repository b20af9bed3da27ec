"""K1's (``csrc/raster_pass1.cu``) share of its roofline: the frozen least
time of a launch at the traced renders' poses (``counts.pass1_bound_s``)
over its device time a launch."""
from portbench import trace


def read(ctx):
    sec, n = trace.seconds_of(ctx["summary"], trace.K1_KERNEL)
    return 100.0 * ctx["k1_bound_s"] / (sec / n) if n else None
