"""Device milliseconds a frame of every device operation outside the
refiner's encoder and head kernels and the two hand-written render
kernels: crop, XYZ maps, render set-up, pose update, activations, the
position embedding and the copies of the frame slots."""
import os
import runpy

from portbench import trace

ATTN_KERNEL = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                          "attn_ms.fpr_video.py"))[
    "ATTN_KERNEL"]


def read(ctx):
    sec, n = trace.seconds_of(ctx["summary"], None, exclude=(
        trace.CNN_KERNEL, ATTN_KERNEL, trace.K1_KERNEL, trace.PASS2_KERNEL))
    return 1e3 * sec / ctx["frames"] if n else None
