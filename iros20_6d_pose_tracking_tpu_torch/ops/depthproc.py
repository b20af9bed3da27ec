"""Depth-channel preprocessing, in PyTorch: the pose-z offset of the network
input and morphological depth hole filling.

Counterpart of ``iros20_6d_pose_tracking_tpu/ops/depthproc.py``:

  - ``offset_depth``: reference data_augmentation.py:124-144 ``OffsetDepth``;
  - ``fill_depth``: reference Utils.py:455-514, the ROS node's depth repair
    (reference predict_ros.py:38-41): inversion, masked dilation, closing,
    hole fill, median and bilateral (or Gaussian) smoothing, on the device
    of its tensor, in the JAX function's op order.
"""
from __future__ import annotations

import numpy as np
import torch

from . import image as I

DEPTH_INVALID_MM = 2000.0
DEPTH_MIN_MM = 100.0

_CROSS_KERNEL_5 = np.array(
    [
        [0, 0, 1, 0, 0],
        [0, 1, 1, 1, 0],
        [1, 1, 1, 1, 1],
        [0, 1, 1, 1, 0],
        [0, 0, 1, 0, 0],
    ],
    dtype=np.uint8,
)


def offset_depth(depth_mm: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Subtract the object's camera-frame |z| (mm) from depth and pin
    invalid depth (<= 100 mm or >= 2000 mm) to 2000."""
    depth = depth_mm.to(torch.float32)
    invalid = (depth <= DEPTH_MIN_MM) | (depth >= DEPTH_INVALID_MM)
    z = pose[..., 2, 3] * 1000.0
    return torch.where(invalid, DEPTH_INVALID_MM, depth - torch.abs(z))


def fill_depth(depth_m: torch.Tensor, max_depth: float = 2.0,
               extrapolate: bool = False,
               blur_type: str = "bilateral") -> torch.Tensor:
    """Morphological depth hole filling of an (H, W) depth in metres
    (float32 out); ``blur_type`` "bilateral", "gaussian" or anything else
    for none; ``extrapolate`` extends each column's highest valid pixel to
    the top of the image."""
    depth = depth_m.to(torch.float32)
    valid = depth > 0.1
    depth = torch.where(valid, max_depth - depth, depth)
    depth = I.dilate(depth, _CROSS_KERNEL_5)
    depth = I.morph_close(depth, np.ones((5, 5), np.uint8))

    empty = depth < 0.1
    dilated = I.dilate(depth, np.ones((7, 7), np.uint8))
    depth = torch.where(empty, dilated, depth)

    if extrapolate:
        H = depth.shape[0]
        is_valid = depth > 0.1
        # first valid row of each column (0 where none, as argmax gives)
        top_row = torch.argmax(is_valid.to(torch.uint8), dim=0)
        top_val = torch.gather(depth, 0, top_row[None, :])[0]
        rows = torch.arange(H, device=depth.device)[:, None]
        depth = torch.where(rows < top_row[None, :], top_val[None, :], depth)
        empty = depth < 0.1
        dilated = I.dilate(depth, np.ones((31, 31), np.uint8))
        depth = torch.where(empty, dilated, depth)

    depth = I.median_blur(depth, 5)

    if blur_type == "bilateral":
        depth = I.bilateral_filter(depth, 5, 1.5, 2.0)
    elif blur_type == "gaussian":
        valid = depth > 0.1
        depth = torch.where(valid, I.gaussian_blur(depth, 5, 0.0), depth)

    valid = depth > 0.1
    return torch.where(valid, max_depth - depth, depth)
