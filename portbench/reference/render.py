"""A plain z-buffer rasterizer: the rendered (A) branch of the tracker and
the sampler's views, from the mesh's vertex arrays.

Every face whose three corners lie beyond the near plane is tested at every
pixel centre of the output grid, which resamples a window (left, right,
top, bottom) of the full image: a pixel is covered where its three
barycentric coordinates are >= 0 and the interpolated 1/z is > 0, and the
closest covering face (largest interpolated 1/z) wins. Depth, albedo,
normal and object-space position are interpolated perspective-correctly
(weights lambda_k / z_k), and the pixel is shaded with the reference
renderer's light: albedo x (0.65 + 0.4 max(n . l, 0)), clamped to [0, 1],
for a point light at (0, -0.1, -0.9) in the camera frame. Depth is metric
millimetres; 0 where no face covers or beyond ``far``.
"""
from __future__ import annotations

import torch

from .cnn import matmul

AMBIENT = 0.65
DIFFUSE = 0.4
LIGHT_CAM = (0.0, -0.1, -0.9)
FACES_PER_CHUNK = 256


def _project(mesh, pose, K, window, hw, precision):
    """Corner screen coordinates in output pixels (F, 3) and camera z."""
    H, W = hw
    R, t = pose[:3, :3], pose[:3, 3]
    cam = matmul(mesh["verts"], R.T, precision) + t
    z = cam[:, 2]
    u = cam[:, 0] / z * K[0, 0] + K[0, 2]
    v = cam[:, 1] / z * K[1, 1] + K[1, 2]
    left, right, top, bottom = window
    X = (u - left) * (W / (right - left)) - 0.5
    Y = (v - top) * (H / (bottom - top)) - 0.5
    f = mesh["faces"]
    return X[f], Y[f], z[f]


def _barycentric(X, Y, px, py):
    """lambda (3, ..., P) of pixels (P,) in faces (..., 3), and the doubled
    signed area (...)."""
    x0, x1, x2 = X[..., 0, None], X[..., 1, None], X[..., 2, None]
    y0, y1, y2 = Y[..., 0, None], Y[..., 1, None], Y[..., 2, None]
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    l0 = (x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)
    l1 = (x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)
    l2 = (x0 - px) * (y1 - py) - (x1 - px) * (y0 - py)
    return torch.stack([l0, l1, l2]) / area, area[..., 0]


def winners(mesh, pose, K, window, hw, near, precision="float32"):
    """(winner face (P,), -1 where none) of one view: the covering face of
    largest interpolated 1/z at each pixel centre."""
    H, W = hw
    dev = mesh["verts"].device
    X, Y, Z = _project(mesh, pose, K, window, hw, precision)
    ok = (Z > near).all(dim=1)
    q = torch.arange(H * W, device=dev)
    px, py = (q % W).to(torch.float32), (q // W).to(torch.float32)
    best = torch.full((H * W,), -1.0, device=dev)
    arg = torch.full((H * W,), -1, dtype=torch.int64, device=dev)
    for s in range(0, X.shape[0], FACES_PER_CHUNK):
        sl = slice(s, s + FACES_PER_CHUNK)
        lam, area = _barycentric(X[sl], Y[sl], px, py)   # (3, f, P), (f,)
        iz = (lam / Z[sl].T[..., None]).sum(0)
        cov = (lam >= 0).all(0) & (iz > 0) & (ok[sl] & (area.abs() > 1e-4)
                                              )[:, None]
        iz = torch.where(cov, iz, -1.0)
        val, idx = iz.max(dim=0)
        better = val > best
        best = torch.where(better, val, best)
        arg = torch.where(better, idx + s, arg)
    return arg


def shade(mesh, pose, K, window, hw, winner, far, precision="float32"):
    """rgb (H, W, 3) in [0, 255] and depth (H, W) mm of one view from its
    winners."""
    H, W = hw
    dev = mesh["verts"].device
    X, Y, Z = _project(mesh, pose, K, window, hw, precision)
    q = torch.arange(H * W, device=dev)
    px, py = (q % W).to(torch.float32), (q // W).to(torch.float32)
    f = winner.clamp(min=0)
    lam, _ = _barycentric(X[f], Y[f], px[:, None], py[:, None])  # (3, P, 1)
    w = lam[..., 0].T / Z[f]                                     # (P, 3)
    iz = w.sum(1)
    faces = mesh["faces"][f]                                      # (P, 3)

    def interp(attr):
        return (w[..., None] * attr[faces]).sum(1) / iz[:, None]

    R, t = pose[:3, :3], pose[:3, 3]
    albedo = interp(mesh["colors"])
    n = matmul(interp(mesh["normals"]), R.T, precision)
    n = n / n.norm(dim=1, keepdim=True).clamp(min=1e-9)
    p = matmul(interp(mesh["verts"]), R.T, precision) + t
    light = torch.tensor(LIGHT_CAM, dtype=torch.float32, device=dev)
    l = light - p
    l = l / l.norm(dim=1, keepdim=True).clamp(min=1e-9)
    ndotl = (n * l).sum(1).clamp(min=0.0)
    rgb = (albedo * (AMBIENT + DIFFUSE * ndotl)[:, None]).clamp(0.0, 1.0)
    depth_m = 1.0 / iz.clamp(min=1e-9)
    hit = (winner >= 0) & (depth_m < far)
    rgb = torch.where(hit[:, None], rgb * 255.0, 0.0)
    depth = torch.where(hit, depth_m * 1000.0, 0.0)
    return rgb.reshape(H, W, 3), depth.reshape(H, W)


@torch.no_grad()
def render(mesh, poses, K, windows, hw, near=0.1, far=2.0,
           precision="float32"):
    """N views: poses (N, 4, 4), windows (N, 4) float (left, right, top,
    bottom). Returns rgb (N, H, W, 3), depth (N, H, W) and winner (N, H*W).
    ``precision``: the matrix products' ("float32" or "tf32", see
    ``cnn.Arith``)."""
    rgbs, depths, wins = [], [], []
    for pose, window in zip(poses, windows):
        win = winners(mesh, pose, K, window, hw, near, precision)
        rgb, depth = shade(mesh, pose, K, window, hw, win, far, precision)
        rgbs.append(rgb)
        depths.append(depth)
        wins.append(win)
    return torch.stack(rgbs), torch.stack(depths), torch.stack(wins)
