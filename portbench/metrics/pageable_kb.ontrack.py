"""KiB a call copied to the card from pageable host memory: the
``pageable_bytes`` counted in the spans ``tracker.prepare`` (the prior
pose) and ``tracker.upload`` (the frame's RGB and depth)."""
from portbench import spans


def read(ctx):
    sel = spans.closed(("tracker.prepare", "tracker.upload"))
    if not sel or not ctx["calls"]:
        return None
    b = sum(s["counts"].get("pageable_bytes", 0) for s in sel)
    return b / 1024 / ctx["calls"]
