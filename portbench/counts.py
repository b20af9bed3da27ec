"""Frozen counts: the card's peaks, the network's operations, and the work
the two hand-written render kernels must do, computed from shapes and from
the bytes each launch needs, so they read the same whatever implements the
work.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
"""
from __future__ import annotations

import torch

from .reference import cnn

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
# Pass 1: four linear forms (three edges and 1/z) at a (pixel, face) pair.
OPS_PER_PAIR = 16
# Pass 2: interpolation, normalisation, lighting and depth of a hit pixel.
OPS_PER_HIT_PIXEL = 120
# Floats of one face's attribute row that pass 2 reads: 1/z, albedo,
# normal and position forms (3 + 9 + 9 + 9).
ATTR_ROW_FLOATS = 30
COEF_ROWS = 12

# Operations (2 per multiply-add) of one forward of an (A, B) pair at
# 176 x 176: every convolution and the two heads' linear layers. Held equal
# to forward_flops(176) by the tests.
FORWARD_FLOPS_176 = 5_527_115_776


def _out(h: int, k: int, s: int) -> int:
    return (h + 2 * ((k - 1) // 2) - k) // s + 1


def forward_flops(res: int) -> int:
    """Convolution and linear operations of one forward at res x res."""
    spatial = {}
    h = _out(res, 7, 2)
    spatial["convA1"] = spatial["convB1"] = h
    h = _out(h, 3, 2)                                   # max-pool 3/2/1
    for name in ("convA2", "convB2", "convB3"):
        spatial[name] = h
    h = spatial["convAB1"] = _out(h, 3, 2)
    spatial["convAB2"] = h
    h = _out(h, 3, 2)
    for name in ("trans_conv1", "trans_conv2", "rot_conv1", "rot_conv2"):
        spatial[name] = h
    total = 0
    for name, kind, cin, cout, k, _ in cnn.LAYERS:
        hw = spatial[name] ** 2
        if kind == "cbs":
            total += 2 * cin * k * k * cout * hw
        else:
            total += 2 * 2 * cin * k * k * cout * hw
    for _, cin, cout in cnn.HEADS:
        total += 2 * cin * cout
    return total


def bound_s(n_bytes: float, ops: float) -> float:
    """The least time of a launch: bytes over HBM bandwidth or float32
    operations over the float32 peak, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS["float32"])


def _screen(mesh, pose, K, window, hw):
    H, W = hw
    R, t = pose[:3, :3], pose[:3, 3]
    cam = mesh["verts"] @ R.T + t
    z = cam[:, 2]
    u = cam[:, 0] / z * K[0, 0] + K[0, 2]
    v = cam[:, 1] / z * K[1, 1] + K[1, 2]
    left, right, top, bottom = window
    X = (u - left) * (W / (right - left)) - 0.5
    Y = (v - top) * (H / (bottom - top)) - 0.5
    f = mesh["faces"]
    return X[f], Y[f], cam[f]


@torch.no_grad()
def pass1_bound_s(mesh, pose, K, window, hw, near, face_block=1024):
    """K1's least time for one culled render: the coefficients of the front
    faces whose screen bbox holds a pixel centre of the window, the block
    bboxes and the outputs (1/z and winner a pixel); OPS_PER_PAIR for each
    (pixel, face) pair of those bboxes."""
    H, W = hw
    X, Y, cam = _screen(mesh, pose, K, window, hw)
    valid = (cam[..., 2] > near).all(1)
    gn = torch.linalg.cross(cam[:, 1] - cam[:, 0], cam[:, 2] - cam[:, 0])
    n_avg = mesh["normals"][mesh["faces"]].mean(1) @ pose[:3, :3].T
    gn = gn * torch.sign((gn * n_avg).sum(-1, keepdim=True))
    front = valid & ~((gn * cam.mean(1)).sum(-1) > 0)
    X, Y = X.double(), Y.double()
    nx = (X.amax(1).floor().clamp(max=W - 1) - X.amin(1).ceil().clamp(min=0)
          + 1).clamp(min=0)
    ny = (Y.amax(1).floor().clamp(max=H - 1) - Y.amin(1).ceil().clamp(min=0)
          + 1).clamp(min=0)
    pix = torch.where(front, nx * ny, 0.0)
    n_faces = mesh["faces"].shape[0]
    blocks = -(-n_faces // face_block)
    n_bytes = int((pix > 0).sum()) * COEF_ROWS * 4 + blocks * 16 + H * W * 8
    return bound_s(n_bytes, OPS_PER_PAIR * float(pix.sum()))


def pass2_bound_s(winner, hw) -> float:
    """pass2_shade's least time for one render from its winners (face ids,
    -1 where none): 1/z and winner read and rgb and depth written a pixel,
    the distinct attribute rows the hit pixels name, R and t;
    OPS_PER_HIT_PIXEL for each hit pixel."""
    H, W = hw
    hit = winner >= 0
    rows = torch.unique(winner[hit]).numel()
    n_bytes = H * W * 8 + rows * ATTR_ROW_FLOATS * 4 + 48 + H * W * 16
    return bound_s(n_bytes, OPS_PER_HIT_PIXEL * int(hit.sum()))
