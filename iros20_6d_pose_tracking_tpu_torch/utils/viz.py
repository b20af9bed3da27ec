"""Visualization helpers (reference Utils.py:125-144 makeCanvas, the
projected-point overlays and mp4 writers of predict.py:403,424-433,549-559).

The port's own copy of ``iros20_6d_pose_tracking_tpu/utils/viz.py`` (numpy
and cv2 only; tests/test_torch_port_copies.py holds the two equal).
Headless-first: everything writes files; nothing calls imshow.
"""
from __future__ import annotations

import numpy as np


def make_canvas(imgs, flip_br: bool = True, gap: int = 10) -> np.ndarray:
    """Tile same-size images horizontally with a gap (reference
    Utils.py:125-144)."""
    H, W = imgs[0].shape[:2]
    n = len(imgs)
    canvas = np.zeros((H, W * n + gap * (n - 1), 3), np.uint8)
    x = 0
    for img in imgs:
        img = np.asarray(img)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img[..., :3].astype(np.uint8)
        if flip_br:
            img = img[..., ::-1]
        canvas[:, x : x + W] = img
        x += W + gap
    return canvas


def draw_projected_points(rgb: np.ndarray, pose: np.ndarray, K: np.ndarray,
                          points: np.ndarray,
                          color=(0, 255, 255)) -> np.ndarray:
    """Overlay the transformed model points (reference predict.py:549-556).
    Returns a BGR uint8 image (cv2 convention)."""
    import cv2

    pts = points @ pose[:3, :3].T + pose[:3, 3]
    z = np.maximum(pts[:, 2], 1e-6)
    us = np.round(pts[:, 0] * K[0, 0] / z + K[0, 2]).astype(int)
    vs = np.round(pts[:, 1] * K[1, 1] / z + K[1, 2]).astype(int)
    bgr = cv2.cvtColor(rgb.astype(np.uint8), cv2.COLOR_RGB2BGR)
    H, W = bgr.shape[:2]
    keep = (us >= 0) & (us < W) & (vs >= 0) & (vs < H)
    bgr[vs[keep], us[keep]] = color
    return bgr


class VideoWriter:
    """mp4 writer (reference predict.py:403). No-ops if cv2 lacks codecs."""

    def __init__(self, path: str, fps: float = 30.0):
        self.path = path
        self.fps = fps
        self._writer = None

    def write(self, bgr: np.ndarray):
        import cv2

        if self._writer is None:
            h, w = bgr.shape[:2]
            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            self._writer = cv2.VideoWriter(self.path, fourcc, self.fps, (w, h))
        self._writer.write(bgr.astype(np.uint8))

    def close(self):
        if self._writer is not None:
            self._writer.release()
            self._writer = None
