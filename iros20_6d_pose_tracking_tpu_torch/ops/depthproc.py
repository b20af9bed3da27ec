"""Depth-channel preprocessing, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/ops/depthproc.py``. Only
``offset_depth`` is ported so far; ``fill_depth`` waits for the image ops
(ROADMAP.md, P13).
"""
from __future__ import annotations

import torch

DEPTH_INVALID_MM = 2000.0
DEPTH_MIN_MM = 100.0


def offset_depth(depth_mm: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Subtract the object's camera-frame |z| (mm) from depth and pin
    invalid depth (<= 100 mm or >= 2000 mm) to 2000."""
    depth = depth_mm.to(torch.float32)
    invalid = (depth <= DEPTH_MIN_MM) | (depth >= DEPTH_INVALID_MM)
    z = pose[..., 2, 3] * 1000.0
    return torch.where(invalid, DEPTH_INVALID_MM, depth - torch.abs(z))
