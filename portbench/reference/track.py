"""The tracking step of se(3)-TrackNet (reference predict.py:217-296), plain:
the ROI at the previous pose, the nearest crop of the observed frame, the
render at the previous pose, OffsetDepth and the 8-channel normalisation,
the network, and the pose update t_B = t_A + tau trans,
R_B = exp(rho rot) R_A."""
from __future__ import annotations

import torch

from . import cnn, render

DEPTH_MIN_MM = 100.0
DEPTH_INVALID_MM = 2000.0


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, (..., 3) -> (..., 3, 3), any float dtype."""
    th2 = (w * w).sum(-1)
    th = th2.sqrt()
    small = th2 < 1e-8
    safe = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(safe)) / (safe * safe))
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    o = torch.zeros_like(x)
    Kx = torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                      torch.stack([-y, x, o], -1)], -2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * Kx + b[..., None, None] * (Kx @ Kx)


def roi_bbox(poses: torch.Tensor, K: torch.Tensor, width_mm: float):
    """(left, right, top, bottom) int64 (N,) of the square ``width_mm`` ROI
    around each projected object origin (reference predict.py:232): the
    four corners rounded half to even."""
    t = poses[:, :3, 3] * 1000.0
    half = width_mm / 2.0
    us, vs = [], []
    for dx, dy in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
        us.append(torch.round((t[:, 0] + dx * half) * K[0, 0] / t[:, 2]
                              + K[0, 2]))
        vs.append(torch.round((t[:, 1] + dy * half) * K[1, 1] / t[:, 2]
                              + K[1, 2]))
    us, vs = torch.stack(us, -1), torch.stack(vs, -1)
    return (us.amin(-1).long(), us.amax(-1).long(), vs.amin(-1).long(),
            vs.amax(-1).long())


def crop_nearest(img: torch.Tensor, left, right, top, bottom, res: int):
    """cv2 INTER_NEAREST of img[top:bottom, left:right] to res x res, one
    crop per frame: img (N, H, W[, C]); source pixels outside read 0."""
    N, H, W = img.shape[:3]
    o = torch.arange(res, device=img.device)
    rows = top[:, None] + (o[None] * (bottom - top)[:, None]) // res
    cols = left[:, None] + (o[None] * (right - left)[:, None]) // res
    ok = ((rows >= 0) & (rows < H))[:, :, None] & \
        ((cols >= 0) & (cols < W))[:, None, :]
    n = torch.arange(N, device=img.device)[:, None, None]
    out = img[n, rows.clamp(0, H - 1)[:, :, None],
              cols.clamp(0, W - 1)[:, None, :]]
    if out.dim() == 4:
        ok = ok[..., None]
    return torch.where(ok, out, torch.zeros((), dtype=out.dtype,
                                            device=out.device))


def offset_depth(depth_mm, pose_z_m):
    """Reference OffsetDepth: depth minus the object's |z| (mm); invalid
    depth (<= 100 or >= 2000 mm) pinned to 2000."""
    bad = (depth_mm <= DEPTH_MIN_MM) | (depth_mm >= DEPTH_INVALID_MM)
    z = (pose_z_m * 1000.0).abs().reshape((-1,) + (1,) * (depth_mm.dim() - 1))
    return torch.where(bad, DEPTH_INVALID_MM, depth_mm - z)


def network_input(rgbA, depthA, rgbB, depthB, poseA, mean, std):
    """Both branches packed (N, H, W, 4) and normalised."""
    z = poseA[:, 2, 3]
    A = torch.cat([rgbA, offset_depth(depthA, z)[..., None]], -1)
    B = torch.cat([rgbB, offset_depth(depthB, z)[..., None]], -1)
    return (A - mean[:4]) / std[:4], (B - mean[4:]) / std[4:]


def views(mesh, poses, K, frames_rgb, frames_depth, width_mm, res, near,
          far, precision="float32"):
    """The rendered and cropped ROI pair at each prior pose, float32 (the
    render's matrix products in ``precision``)."""
    left, right, top, bottom = roi_bbox(poses, K, width_mm)
    win = torch.stack([left, right, top, bottom], -1).to(torch.float32)
    rgbA, depthA, _ = render.render(mesh, poses, K, win, (res, res), near,
                                    far, precision)
    rgbB = crop_nearest(frames_rgb, left, right, top, bottom, res)
    depthB = crop_nearest(frames_depth, left, right, top, bottom, res)
    return rgbA, depthA, rgbB.to(torch.float32), depthB.to(torch.float32)


@torch.no_grad()
def step(params, buffers, mesh, K, mean, std, poses, frames_rgb,
         frames_depth, cfg, precision="float32", block=32):
    """The tracking update of N frames from their N prior poses (float32),
    in blocks of ``block`` frames. Returns the new poses in float64.
    ``precision`` is the arithmetic of every matrix product and
    convolution ("tf32": the render's too; "fp8": the network's only)."""
    out = []
    for s in range(0, poses.shape[0], block):
        p = poses[s:s + block]
        with cnn.Arith(precision):
            rgbA, depthA, rgbB, depthB = views(
                mesh, p, K, frames_rgb[s:s + block],
                frames_depth[s:s + block], cfg["object_width_mm"],
                cfg["resolution"], cfg["near_m"], cfg["far_m"],
                "tf32" if precision == "tf32" else "float32")
            A, B = network_input(rgbA, depthA, rgbB, depthB, p, mean, std)
            o = cnn.forward(params, buffers, A, B, precision=precision)
        p64 = p.double()
        t = p64[:, :3, 3] + o["trans"].double() * cfg["trans_normalizer"]
        R = so3_exp(o["rot"].double() * cfg["rot_normalizer"]) @ p64[:, :3, :3]
        new = torch.zeros_like(p64)
        new[:, :3, :3], new[:, :3, 3], new[:, 3, 3] = R, t, 1.0
        out.append(new)
    return torch.cat(out)
