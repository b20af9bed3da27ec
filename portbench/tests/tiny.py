"""A small copy of a configuration, for the harness's CPU tests: a 96x128
camera with the intrinsics scaled alike, a 48x48 ROI, a coarser sphere, a
6-frame video, batch 4. The widths of the network stay as published."""
from __future__ import annotations

import contextlib

from portbench import config


def shrink(cfg: dict) -> dict:
    cfg = dict(cfg)
    s = 0.2
    cam = dict(cfg["camera"])
    cam.update(height=96, width=128, focalX=cam["focalX"] * s,
               focalY=cam["focalY"] * s, centerX=cam["centerX"] * s,
               centerY=cam["centerY"] * s)
    cfg["camera"] = cam
    cfg["resolution"] = 48
    cfg["mesh"] = dict(cfg["mesh"], subdiv=2, max_faces=256)
    cfg["video"] = dict(cfg["video"], frames=6)
    cfg["train"] = dict(cfg["train"], batch_size=4)
    return cfg


@contextlib.contextmanager
def tiny_configs():
    """Every configuration loads shrunk while the block runs."""
    load = config._load

    def small(kind, name):
        d = load(kind, name)
        return shrink(d) if kind == "configs" else d

    config._load = small
    try:
        yield
    finally:
        config._load = load
