"""The training step's share of the card's peak: three forwards'
operations a sample (forward, and backward at twice the forward) times the
samples of the traced steps, over the traced window, over the peak."""


def read(ctx):
    s = ctx["summary"]
    return 100.0 * ctx["flops_per_sample"] * ctx["samples"] / s["window_s"] \
        / ctx["peak_flops"]
