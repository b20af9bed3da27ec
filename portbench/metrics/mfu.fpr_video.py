"""The replayed refiner step's share of the card's bf16 peak: the refiner's
operations a round (frozen count, ``counts_refiner.py``) times the rounds
of the traced pass (the port's counter ``refine.rounds``), over the traced
window, over the peak. None where the port counts no rounds."""


def read(ctx):
    rounds = ctx.get("rounds")
    if not rounds:
        return None
    s = ctx["summary"]
    return 100.0 * ctx["flops_per_round"] * rounds / s["window_s"] \
        / ctx["peak_flops"]
