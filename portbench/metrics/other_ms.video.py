"""Device milliseconds a frame of every device operation outside the
network's library kernels and the two hand-written render kernels: the
crop, normalisation, render set-up, pose update, the network's
activations and pooling, and the copies of the frame slots."""
from portbench import trace


def read(ctx):
    sec, n = trace.seconds_of(ctx["summary"], None, exclude=(
        trace.CNN_KERNEL, trace.K1_KERNEL, trace.PASS2_KERNEL))
    return 1e3 * sec / ctx["frames"] if n else None
