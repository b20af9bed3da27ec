"""Configurations (``configs/<name>.json``) and workloads
(``workloads/<name>.json``), found by name, and the quantities the
benchmark derives from a configuration's published values."""
from __future__ import annotations

import json
import math
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(name: str) -> dict:
    return _load("workloads", name)


def configuration(name: str, mesh_diameter_m: float | None = None) -> dict:
    """The configuration with its derived values: the intrinsics K, the
    normalisers in radians, and (given the mesh's diameter) the ROI width
    in mm (diameter plus the bounding-box pad, reference
    predict.py:131-142)."""
    cfg = _load("configs", name)
    cam = cfg["camera"]
    cfg["K"] = [[cam["focalX"], 0.0, cam["centerX"]],
                [0.0, cam["focalY"], cam["centerY"]], [0.0, 0.0, 1.0]]
    cfg["trans_normalizer"] = cfg["track_trans_normalizer_m"]
    cfg["rot_normalizer"] = math.radians(cfg["track_rot_normalizer_deg"])
    cfg["train_trans_norm"] = cfg["max_translation_m"]
    cfg["train_rot_norm"] = math.radians(cfg["max_rotation_deg"])
    if mesh_diameter_m is not None:
        cfg["object_width_mm"] = mesh_diameter_m * 1000.0 * (
            1.0 + cfg["boundingbox"] / 100.0)
    return cfg
