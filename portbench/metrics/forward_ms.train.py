"""Milliseconds a step on the card's stream of the span
``trainer.forward``: the forward pass and the loss."""
from portbench import spans


def read(ctx):
    return spans.device_ms(("trainer.forward",), ctx["steps"])
