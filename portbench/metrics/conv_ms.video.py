"""Device milliseconds a frame of the network's library kernels: cuDNN
convolutions, GEMMs, BatchNorm and the layout conversions, by kernel
name."""
from portbench import trace


def read(ctx):
    sec, n = trace.seconds_of(ctx["summary"], trace.CNN_KERNEL)
    return 1e3 * sec / ctx["frames"] if n else None
