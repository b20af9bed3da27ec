"""Device milliseconds a frame of the refiner's encoder kernels: cuDNN
convolutions, BatchNorm and the layout conversions (``conv_ms.video``'s
kernels), less the heads' kernels that ``attn_ms.fpr_video`` reads."""
import os
import runpy

from portbench import trace

ATTN_KERNEL = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                          "attn_ms.fpr_video.py"))[
    "ATTN_KERNEL"]


def read(ctx):
    sec, n = trace.seconds_of(ctx["summary"], trace.CNN_KERNEL,
                              exclude=(ATTN_KERNEL,))
    return 1e3 * sec / ctx["frames"] if n else None
