"""Host milliseconds a call of the span ``compiled.key``: the program's
static key (every parameter's shape, pointer and version) and the
cache's lookup."""
from portbench import spans


def read(ctx):
    return spans.host_ms(("compiled.key",), ctx["calls"])
