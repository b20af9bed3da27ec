"""The replayed tracking step's share of the card's peak: the network's
forward operations a frame (frozen count) times the frames of the traced
pass, over the traced window, over the configuration's peak."""


def read(ctx):
    s = ctx["summary"]
    return 100.0 * ctx["flops_per_frame"] * ctx["frames"] / s["window_s"] \
        / ctx["peak_flops"]
