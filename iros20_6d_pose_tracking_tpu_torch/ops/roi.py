"""Pose-conditioned ROI and the nearest crop-resize, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/ops/roi.py``. The crop uses
the exact integer floor ``src = top + (d * crop) // out`` of cv2
INTER_NEAREST, never ``F.interpolate`` (whose float scale picks other
source pixels), and zero-pads source pixels outside the image.

Depth frames arrive as uint16 millimetres. PyTorch implements few ops on
uint16 (indexing and ``where`` among the missing ones on CUDA), so the
tracker widens depth to int32 at upload; every op here then runs on
int32, uint8 or float32, and the crop stays bit-exact.

The crop also takes N bboxes (N, 4, 2) at once (the N hypotheses of one
frame, JAX's ``vmap`` of ``crop_bbox``): one gather gives (N, r, r[, C]),
and view n is the same bits as the call on bbox n alone. With N frames
(N, H, W[, C]) beside the N bboxes, view n crops frame n (the V videos or O
objects of ``parallel/spmd.py``, each at its own frame).
"""
from __future__ import annotations

import torch

from ..core.camera import round_to_int32


def compute_bbox(pose: torch.Tensor, K: torch.Tensor,
                 scale_size: float | torch.Tensor,
                 scale: tuple[float, float, float] = (1.0, 1.0, 1.0),
                 ) -> torch.Tensor:
    """Square ``scale_size`` window centred on the projected object origin,
    as a (4, 2) int32 tensor of (v, u) = (row, col) corners; a batch of
    poses (..., 4, 4) gives (..., 4, 2). ``scale`` multiplies the pose
    translation ((1000, 1000, 1000) for metres -> mm). The corners are
    rounded half to even and converted as XLA converts
    (``core/camera.round_to_int32``: NaN -> 0, saturating at the int32
    limits), so a pose at z = 0 or a NaN pose gets JAX's window.
    ``scale_size`` may be a tensor of one size per pose (...,)."""
    # Constants come from device kernels, not torch.tensor(): a copy from
    # pageable host memory would make the host wait for the stream.
    obj = [pose[..., i, 3, None] * scale[i] for i in range(3)]
    offset = scale_size / 2.0
    if torch.is_tensor(offset) and offset.dim():
        offset = offset[..., None]  # one size a pose, over the 4 corners
    corner = torch.arange(4, device=pose.device)
    dx = torch.where(corner >= 2, 1.0, -1.0) * offset  # [-1, -1, 1, 1]
    dy = torch.where(corner % 2 == 1, 1.0, -1.0) * offset  # [-1, 1, -1, 1]
    xs = obj[0] + dx
    ys = obj[1] + dy
    zs = obj[2].expand(xs.shape)
    us = xs * K[0, 0] / zs + K[0, 2]
    vs = ys * K[1, 1] / zs + K[1, 2]
    return round_to_int32(torch.stack([vs, us], dim=-1))


def bbox_window(bbox: torch.Tensor):
    """(left, right, top, bottom) int scalars from a (4, 2) (v, u) bbox, or
    (N,) each from N bboxes (N, 4, 2)."""
    return (bbox[..., 1].amin(-1), bbox[..., 1].amax(-1),
            bbox[..., 0].amin(-1), bbox[..., 0].amax(-1))


def crop_resize_nearest(img: torch.Tensor, top: torch.Tensor,
                        left: torch.Tensor, crop_h: torch.Tensor,
                        crop_w: torch.Tensor, out_hw: tuple[int, int],
                        per_view: bool = False) -> torch.Tensor:
    """Nearest resample of ``img[top:top+crop_h, left:left+crop_w]`` to
    ``out_hw``; out-of-image source pixels read as 0. ``img`` is (H, W) or
    (H, W, C); the bbox arguments are int tensors on ``img``'s device, 0-d
    for one crop or (N,) for N crops, which give (N, H_out, W_out[, C]).
    ``per_view``: ``img`` is N frames (N, H, W[, C]) and crop n reads frame
    n."""
    H_out, W_out = out_hw
    lead = 1 if per_view else 0
    h, w = img.shape[lead], img.shape[lead + 1]
    dev = img.device
    oi = torch.arange(H_out, dtype=torch.int32, device=dev)
    oj = torch.arange(W_out, dtype=torch.int32, device=dev)

    def src(start, size, o, n):  # (..., n) source indices
        return start.to(torch.int32)[..., None] + (
            o * size.to(torch.int32)[..., None]) // n

    src_r = src(top, crop_h, oi, H_out)
    src_c = src(left, crop_w, oj, W_out)
    valid_r = (src_r >= 0) & (src_r < h)
    valid_c = (src_c >= 0) & (src_c < w)
    rr = src_r.clamp(0, h - 1)
    cc = src_c.clamp(0, w - 1)
    if per_view:
        n = torch.arange(img.shape[0], device=dev)[:, None, None]
        out = img[n, rr[:, :, None], cc[:, None, :]]
    else:
        out = img[rr[..., :, None], cc[..., None, :]]  # one gather, N crops
    mask = valid_r[..., :, None] & valid_c[..., None, :]
    if img.ndim == 3 + lead:
        mask = mask[..., None]
    return torch.where(mask, out, torch.zeros((), dtype=img.dtype, device=dev))


def crop_bbox(color: torch.Tensor, depth: torch.Tensor, bbox: torch.Tensor,
              output_size: tuple[int, int], seg: torch.Tensor | None = None):
    """Crop + nearest-resize color and depth (and ``seg``, where given) to
    the bbox window, or to each of N bboxes (N, 4, 2), from one frame or
    from N frames ((N, H, W, 3) color, crop n from frame n).
    ``output_size`` is (W, H), the cv2 convention of the reference."""
    W_out, H_out = output_size
    left, right, top, bottom = bbox_window(bbox)
    crop_h = bottom - top
    crop_w = right - left
    per_view = bbox.dim() == 3 and color.dim() == 4
    out = tuple(crop_resize_nearest(img, top, left, crop_h, crop_w,
                                    (H_out, W_out), per_view)
                for img in ((color, depth) if seg is None
                            else (color, depth, seg)))
    return out
