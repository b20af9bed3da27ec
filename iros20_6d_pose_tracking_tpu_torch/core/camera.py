"""Pinhole camera intrinsics.

Counterpart of ``iros20_6d_pose_tracking_tpu/core/camera.py``: the
``Camera`` record and ``cam_K_from_dict`` (reference Utils.py:444-447),
and the pinhole projection of camera-frame points: ``project_points``
(rounded int32 pixels, reference predict.py:81-86) and ``project_points_f``
(float pixels), and :func:`round_to_int32`, the rounding of pixel
coordinates to int32 that both ``project_points`` and ``ops/roi.compute_bbox``
use.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


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


def project_points_f(points: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Float (u, v) pixels of (..., 3) camera-frame points: u = x fx / z +
    cx, v = y fy / z + cy, in that order of operations. Returns (..., 2)."""
    us = points[..., 0] * K[0, 0] / points[..., 2] + K[0, 2]
    vs = points[..., 1] * K[1, 1] / points[..., 2] + K[1, 2]
    return torch.stack([us, vs], dim=-1)


def round_to_int32(x: torch.Tensor) -> torch.Tensor:
    """Round half to even (``jnp.round``) and convert to int32 as XLA
    converts: NaN -> 0, values at or beyond +-2^31 saturate to 2147483647 or
    -2147483648. torch leaves its own conversion undefined there (on the
    CPU each of them becomes -2^31; an H100 gives XLA's ints), and a pose at
    z = 0, a NaN pose or one near the camera plane projects to them. The
    limits are compared in float and written as ints: float32(2147483647)
    is 2^31, which would overflow again. Elementwise ops with scalar
    operands only, so nothing is copied from the host and nothing waits."""
    r = torch.round(x)
    limit = 2147483648.0  # 2^31, exact in float32 and float64
    i = torch.where(r.abs() < limit, r, 0.0).to(torch.int32)  # NaN fails <
    i = torch.where(r >= limit, 2147483647, i)
    return torch.where(r <= -limit, -2147483648, i)


def project_points(points: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) int32 (u, v) pixels,
    rounded to the nearest (half to even, as ``jnp.round``) and converted
    by :func:`round_to_int32`."""
    return round_to_int32(project_points_f(points, K))
