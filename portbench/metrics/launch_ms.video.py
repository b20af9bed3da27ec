"""Host milliseconds a frame of the span ``compiled.replay``: the launch
of the captured step's CUDA graph, once a frame of the video."""
from portbench import spans


def read(ctx):
    return spans.host_ms(("compiled.replay",), ctx["frames"])
