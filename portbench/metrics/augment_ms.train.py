"""Milliseconds a step on the card's stream of the span
``trainer.augment``: the B augmentation, OffsetDepth, normalisation and
labels (``preprocess_batch``)."""
from portbench import spans


def read(ctx):
    return spans.device_ms(("trainer.augment",), ctx["steps"])
