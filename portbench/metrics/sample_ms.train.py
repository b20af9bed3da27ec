"""Milliseconds of the pair sampler a step (render of both branches and
the domain-randomisation composite), CUDA events around the call, mean
over the traced steps."""


def read(ctx):
    ms = ctx["sample_ms"]
    return sum(ms) / len(ms) if ms else None
