"""Point-cloud ops (reference Utils.py:147-168 and friends), in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/ops/pointcloud.py``:
``rgbd_to_pointcloud`` unprojects RGB-D into camera-frame points (reference
Utils.py:147-158) on the device of its tensors;
``find_class_contained_videos_ycb`` is the JAX module's dataset discovery
helper (reference Utils.py:108-123), copied.
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
