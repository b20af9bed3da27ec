"""Pinhole camera intrinsics.

Counterpart of ``iros20_6d_pose_tracking_tpu/core/camera.py``: the
``Camera`` record and ``cam_K_from_dict`` (reference Utils.py:444-447),
numpy only. The projection helpers (``project_points*``) are not ported
yet (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Camera:
    """Pinhole intrinsics. fx/fy/cx/cy in pixels; width/height in pixels."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]]
        )

    @staticmethod
    def from_dict(cam_cfg: dict) -> "Camera":
        """From the ``camera`` block of a reference dataset_info.yml
        (focalX/focalY/centerX/centerY, optional width/height)."""
        return Camera(
            fx=float(cam_cfg["focalX"]),
            fy=float(cam_cfg["focalY"]),
            cx=float(cam_cfg["centerX"]),
            cy=float(cam_cfg["centerY"]),
            width=int(cam_cfg.get("width", 640)),
            height=int(cam_cfg.get("height", 480)),
        )


def cam_K_from_dict(cam_cfg: dict) -> np.ndarray:
    """3x3 K from a dataset_info camera dict."""
    return Camera.from_dict(cam_cfg).K
