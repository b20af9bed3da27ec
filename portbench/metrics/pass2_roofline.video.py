"""pass2_shade's (``csrc/pass2_shade.cu``) share of its roofline: the
frozen least time of a launch (``counts.pass2_bound_s``, the distinct
winner rows of the traced renders) over its device time a launch."""
from portbench import trace


def read(ctx):
    sec, n = trace.seconds_of(ctx["summary"], trace.PASS2_KERNEL)
    return 100.0 * ctx["pass2_bound_s"] / (sec / n) if n else None
