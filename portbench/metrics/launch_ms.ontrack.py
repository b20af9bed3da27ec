"""Host milliseconds a call of the span ``compiled.replay``: the launch of
the captured step's CUDA graph."""
from portbench import spans


def read(ctx):
    return spans.host_ms(("compiled.replay",), ctx["calls"])
