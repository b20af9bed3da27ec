"""``tiny.py``'s small copy of a configuration, for every configuration,
the refiner's too (which has no training group for ``tiny.shrink`` to
cut)."""
from __future__ import annotations

import contextlib

from portbench import config
from portbench.tests.tiny import shrink


def shrink_any(cfg: dict) -> dict:
    if "train" in cfg:
        return shrink(cfg)
    out = shrink(dict(cfg, train={}))
    del out["train"]
    return out


@contextlib.contextmanager
def tiny_configs():
    """Every configuration loads shrunk while the block runs."""
    load = config._load

    def small(kind, name):
        d = load(kind, name)
        return shrink_any(d) if kind == "configs" else d

    config._load = small
    try:
        yield
    finally:
        config._load = load
