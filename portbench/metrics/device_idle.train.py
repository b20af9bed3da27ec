"""Share of the traced window in which no kernel, copy or memset ran on
the card (busy time is the union of their intervals)."""


def read(ctx):
    s = ctx["summary"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
