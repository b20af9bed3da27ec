"""Point-cloud ops (reference Utils.py:147-168 and friends), in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/ops/pointcloud.py``:
``rgbd_to_pointcloud`` unprojects RGB-D into camera-frame points (reference
Utils.py:147-158) on the device of its tensors;
``find_class_contained_videos_ycb`` is the JAX module's dataset discovery
helper (reference Utils.py:108-123), copied.

The camera-frame XYZ map of an ROI (FoundationPose's refiner input, no JAX
counterpart): :func:`roi_xyz` back-projects an ROI's depth through the image
coordinates each ROI pixel samples (:func:`window_pixel_centres` for a
rendered window, ``ops/roi.source_pixels`` for a nearest crop), and
:func:`normalize_xyz` centres, scales and masks it. Static shapes, the same
ops on the CPU and on the card.
"""
from __future__ import annotations

import os
import re

import torch


def rgbd_to_pointcloud(K, depth_m: torch.Tensor,
                       rgb: torch.Tensor | None = None, z_range=(0.1, 2.0)):
    """Unproject a depth map (metres, (H, W)) into an (H*W, 3) cloud with a
    validity mask (H*W,); the colors (H*W, C) are reshaped from ``rgb`` if
    given, else None. Static shapes (masked, not compacted): callers filter
    with the mask."""
    H, W = depth_m.shape
    dev = depth_m.device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    us = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    vs = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    z = depth_m.to(torch.float32)
    mask = (z > z_range[0]) & (z < z_range[1])
    x = (us - K[0, 2]) * z / K[0, 0]
    y = (vs - K[1, 2]) * z / K[1, 1]
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    colors = None if rgb is None else rgb.reshape(-1, rgb.shape[-1])
    return pts, colors, mask.reshape(-1)


def window_pixel_centres(window: torch.Tensor, out_hw: tuple[int, int]):
    """(us (..., W), vs (..., H)) float32: the full-image coordinates of the
    pixel centres of an ``out_hw`` render of ``window`` ((..., 4) left,
    right, top, bottom; ``render/rasterizer.render``'s grid: output pixel
    (i, j) at u = left + (j + 0.5) (right - left) / W)."""
    H, W = out_hw
    dev = window.device
    left, right, top, bottom = window.to(torch.float32).unbind(-1)
    j = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    i = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    us = left[..., None] + j * ((right - left) / W)[..., None]
    vs = top[..., None] + i * ((bottom - top) / H)[..., None]
    return us, vs


def roi_xyz(depth_mm: torch.Tensor, us: torch.Tensor, vs: torch.Tensor,
            K: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., H, W, 3) in metres of an ROI depth (...,
    H, W) in mm whose pixel (i, j) samples the image at (vs[..., i],
    us[..., j]): x = (u - cx) z / fx, y = (v - cy) z / fy, z = depth /
    1000."""
    z = depth_mm.to(torch.float32) / 1000.0
    x = (us[..., None, :] - K[0, 2]) * z / K[0, 0]
    y = (vs[..., :, None] - K[1, 2]) * z / K[1, 1]
    return torch.stack([x, y, z], dim=-1)


def normalize_xyz(xyz: torch.Tensor, centre: torch.Tensor, radius,
                  bound: float = 2.0) -> torch.Tensor:
    """(xyz - centre) / radius, 0 where the point's z is under 1 mm or any
    normalised coordinate has |.| >= ``bound`` (FoundationPose's
    ``normalize_xyz``). ``centre`` (..., 3) and ``radius`` (a float, or
    (...,)) per view, broadcast over the ROI's (H, W)."""
    if torch.is_tensor(radius) and radius.dim():
        radius = radius[..., None, None, None]
    n = (xyz - centre[..., None, None, :]) / radius
    bad = (xyz[..., 2:3] < 0.001) | (n.abs() >= bound).any(-1, keepdim=True)
    return torch.where(bad, 0.0, n)


def find_class_contained_videos_ycb(data_organized_dir: str, class_id: int,
                                    testset: bool = True) -> list[int]:
    """Sequence ids whose pose_gt contains the class (reference
    Utils.py:108-123; test set = videos 48..59)."""
    out = []
    for entry in sorted(os.listdir(data_organized_dir)):
        if not re.fullmatch(r"\d{4}", entry):
            continue
        vid = int(entry)
        if testset and (vid < 48 or vid > 59):
            continue
        gt_dir = os.path.join(data_organized_dir, entry, "pose_gt")
        if not os.path.isdir(gt_dir):
            continue
        try:
            ids = [int(x) for x in os.listdir(gt_dir)]
        except ValueError:
            continue
        if class_id in ids:
            out.append(vid)
    return out
