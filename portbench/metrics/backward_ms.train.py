"""Milliseconds a step on the card's stream of the span
``trainer.backward``: ``zero_grad`` and the backward pass."""
from portbench import spans


def read(ctx):
    return spans.device_ms(("trainer.backward",), ctx["steps"])
