"""Milliseconds a step on the card's stream of the span
``trainer.adam``: the learning rate set and Adam's step."""
from portbench import spans


def read(ctx):
    return spans.device_ms(("trainer.adam",), ctx["steps"])
