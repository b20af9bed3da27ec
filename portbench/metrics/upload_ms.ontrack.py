"""Host milliseconds a call of the spans ``tracker.prepare`` (depth units,
the prior pose to the card) and ``tracker.upload`` (the frame from
pageable memory)."""
from portbench import spans


def read(ctx):
    return spans.host_ms(("tracker.prepare", "tracker.upload"),
                         ctx["calls"])
