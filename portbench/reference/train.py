"""The training step of se(3)-TrackNet, plain: the synthetic pair sampler's
domain-randomised composite of the observed (B) branch, the reference's B
augmentation stack (reference data_augmentation.py:48-267: HSV jitter,
brightness, Gaussian noise, Gaussian blur, black cover), OffsetDepth and
normalisation, the label codec (reference datasets.py:141-150), the network
in train mode, MSE(trans) + MSE(rot), and Adam with L2 weight decay added
to the gradient (torch.optim.Adam's update, written out).

Random numbers are inputs: the benchmark draws them (``portbench/scene``)
and hands the same draws to both sides."""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from . import cnn, render, track

DEPTH_VALID_MIN = 100.0


# --- the sampler: render both branches, composite B ------------------------

def smooth_noise(d, res):
    up = [F.interpolate(d[k].permute(0, 3, 1, 2), size=(res, res),
                        mode="bilinear", align_corners=False)
          .permute(0, 2, 3, 1) for k in ("lo", "hi")]
    return up[0] * 0.75 + up[1] * 0.25


def dr_composite(d, rgbB, depthB, dr):
    """Background texture at valid depth behind the object, and an
    elliptic occluder in front of it; returns rgb, depth and the object's
    visibility mask."""
    res = depthB.shape[-1]
    dev = depthB.device
    obj = depthB > 100.0
    lo, hi = dr["bg_depth_range"]
    n_obj = obj.sum(dim=(1, 2))
    mean_d = torch.where(n_obj > 0, (depthB * obj).sum(dim=(1, 2))
                         / (n_obj + 1e-9), 600.0)
    lo = torch.clamp(mean_d + 120.0, min=lo)
    hi = torch.maximum(torch.full_like(lo, hi), lo + 100.0)
    base = torch.maximum(lo, d["u_base"] * (hi - lo) + lo)
    yy = torch.arange(res, device=dev)[:, None].float()
    xx = torch.arange(res, device=dev)[None, :].float()
    gx, gy = d["grad"][:, 0, None, None], d["grad"][:, 1, None, None]
    bg_d = base[:, None, None] + gx * (xx - res / 2) + gy * (yy - res / 2) \
        + smooth_noise(d["depth_noise"], res)[..., 0] * 40.0
    bg_d = torch.clamp(torch.maximum(bg_d, lo[:, None, None]), max=2500.0)
    use_bg = d["use_bg"][:, None, None] & ~obj
    rgb = torch.where(use_bg[..., None], smooth_noise(d["bg_noise"], res)
                      * 255.0, rgbB)
    depth = torch.where(use_bg, bg_d, depthB)
    cx, cy = d["centre"][:, 0, None, None], d["centre"][:, 1, None, None]
    rx, ry = d["radii"][:, 0, None, None], d["radii"][:, 1, None, None]
    ell = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 < 1.0
    occ_d = mean_d * d["occ_scale"]
    occ_rgb = d["occ_colour"][:, None, None, :] * 235.0 + 10.0 + \
        (smooth_noise(d["occ_noise"], res) - 0.5) * 40.0
    hidden = (ell & obj).sum(dim=(1, 2)) / (n_obj + 1e-9)
    use_occ = d["use_occ"] & (hidden <= dr["max_occluded_frac"])
    far = torch.where(depth > 100.0, depth, torch.inf)
    wins = ell & (occ_d[:, None, None] < far) & use_occ[:, None, None]
    rgb = torch.where(wins[..., None], occ_rgb.clamp(0, 255), rgb)
    depth = torch.where(wins, occ_d[:, None, None], depth)
    return rgb, depth, obj & ~wins


@torch.no_grad()
def sample(mesh, K, A_in_cam, B_in_cam, dr_draws, cfg, views=None,
           precision="float32"):
    """The raw pair batch, both branches in A's ROI window. ``views``: the
    indices of the pairs to make (all by default); ``precision``: the
    render's matrix products'."""
    if views is not None:
        A_in_cam, B_in_cam = A_in_cam[views], B_in_cam[views]
        dr_draws = _rows(dr_draws, views)
    res = cfg["resolution"]
    left, right, top, bottom = track.roi_bbox(A_in_cam, K,
                                              cfg["object_width_mm"])
    win = torch.stack([left, right, top, bottom], -1).to(torch.float32)
    with cnn.Arith(precision):
        rgbA, depthA, _ = render.render(mesh, A_in_cam, K, win, (res, res),
                                        cfg["near_m"], cfg["far_m"], precision)
        rgbB, depthB, _ = render.render(mesh, B_in_cam, K, win, (res, res),
                                        cfg["near_m"], cfg["far_m"], precision)
    rgbB, depthB, maskB = dr_composite(dr_draws, rgbB, depthB, cfg["dr"])
    return {"rgbA": rgbA, "depthA": depthA, "rgbB": rgbB, "depthB": depthB,
            "maskB": maskB, "A_in_cam": A_in_cam, "B_in_cam": B_in_cam}


def _rows(d, idx):
    if isinstance(d, dict):
        return {k: _rows(v, idx) for k, v in d.items()}
    return d[idx]


# --- the B augmentation -----------------------------------------------------

def rgb_to_hsv(rgb):
    """cv2 RGB2HSV on [0, 255] floats: H in [0, 180), S, V in [0, 255]."""
    r, g, b = rgb.unbind(-1)
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    dd = torch.where(diff > 0, diff, 1.0)
    s = torch.where(v > 0, diff / v.clamp(min=1e-12) * 255.0, 0.0)
    h = torch.where(v == r, 60.0 * (g - b) / dd,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / dd,
                                240.0 + 60.0 * (r - g) / dd))
    h = torch.where(diff > 0, h, 0.0)
    h = torch.where(h < 0, h + 360.0, h) * 0.5
    return torch.stack([h, s, v], -1)


def hsv_to_rgb(hsv):
    h = torch.remainder(hsv[..., 0] * 2.0, 360.0)
    s, v = hsv[..., 1] / 255.0, hsv[..., 2]
    hp = h / 60.0
    sector = torch.remainder(torch.floor(hp), 6.0)
    f = hp - torch.floor(hp)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    table = ((v, q, p, p, t, v), (t, v, v, q, p, p), (p, p, t, v, v, q))
    out = []
    for ch in table:
        c = torch.zeros_like(v)
        for k in range(6):
            c = torch.where(sector == k, ch[k], c)
        out.append(c)
    return torch.stack(out, -1)


def gaussian_blur(img, ksize, sigma=2.0):
    """cv2.GaussianBlur with reflect-101 borders over the axes (1, 2) of
    (N, H, W[, C])."""
    half = (ksize - 1) * 0.5
    xs = torch.arange(ksize, dtype=torch.float32, device=img.device) - half
    k = torch.exp(-(xs * xs) / (2.0 * sigma * sigma))
    k = k / k.sum()
    pad = ksize // 2
    out = img
    for ax in (2, 1):
        n = out.shape[ax]
        i = torch.arange(-pad, n + pad, device=img.device).abs()
        i = torch.where(i >= n, 2 * (n - 1) - i, i)
        padded = out.index_select(ax, i)
        acc = None
        for j in range(ksize):
            sl = padded.narrow(ax, j, n) * k[j]
            acc = sl if acc is None else acc + sl
        out = acc
    return out


def _per(x, like):
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


def augment(d, rgb, depth, mask, aug):
    valid = depth > DEPTH_VALID_MIN
    # HSV jitter of valid-depth pixels
    hsv = rgb_to_hsv(rgb) + torch.where(d["hsv"]["gates"], d["hsv"]["shifts"],
                                        0.0)[:, None, None, :]
    jit = hsv_to_rgb(hsv.clamp(0.0, 255.0)).clamp(0.0, 255.0)
    rgb = torch.where(valid[..., None], jit, rgb)
    # brightness
    rgb = (rgb * _per(d["bright"]["mag"], rgb)).clamp(0.0, 255.0)
    # Gaussian noise of valid-depth pixels
    nz = d["noise"]
    valid = depth > DEPTH_VALID_MIN
    noisy = (rgb + nz["noise_rgb"] * _per(nz["std_rgb"], rgb)).clamp(0, 255)
    rgb = torch.where(_per(nz["gate_rgb"], rgb) & valid[..., None], noisy, rgb)
    noisy_d = depth + nz["noise_d"] * _per(nz["std_d"], depth)
    depth = torch.where(_per(nz["gate_d"], depth) & valid, noisy_d, depth)
    # Gaussian blur, sigma 2, a per-sample odd size from {3, 5, ...}
    bl = d["blur"]
    sizes = [2 * i + 1 for i in range(1, aug["blur_max_kernel"] // 2 + 1)]
    b_rgb, b_d = rgb, depth
    for j, k in enumerate(sizes):
        b_rgb = torch.where(_per(bl["idx_rgb"] == j, rgb),
                            gaussian_blur(rgb, k), b_rgb)
        b_d = torch.where(_per(bl["idx_d"] == j, depth),
                          gaussian_blur(depth, k), b_d)
    rgb = torch.where(_per(bl["gate_rgb"], rgb), b_rgb, rgb)
    depth = torch.where(_per(bl["gate_d"], depth), b_d, depth)
    # black cover: the first candidate quadrant that leaves >= 50% visible
    bc = d["black_cover"]
    N, H, W = depth.shape
    n_valid = mask.float().sum(dim=(1, 2)).clamp(min=1.0)
    ys = torch.arange(H, device=depth.device)[None, None, :, None]
    xs = torch.arange(W, device=depth.device)[None, None, None, :]
    quad = bc["quad"][..., None, None]
    above = ys < bc["cv"][..., None, None]
    left = xs < bc["cu"][..., None, None]
    covers = (above == ((quad == 0) | (quad == 1))) & (
        left == ((quad == 0) | (quad == 2)))
    remain = (mask[:, None] & ~covers).float().sum(dim=(2, 3)) \
        / n_valid[:, None]
    ok = remain >= 0.5
    first = torch.argmax(ok.to(torch.int32), dim=1)
    cover = covers[torch.arange(N, device=depth.device), first]
    cover = cover & _per(bc["apply"] & ok.any(dim=1), cover)
    rgb = torch.where(cover[..., None], 0.0, rgb)
    depth = torch.where(cover, -9999.0, depth)
    return rgb, depth


# --- labels, loss, Adam -----------------------------------------------------

def so3_log(R):
    """Rotation vector of R (angles well below pi: the sampler's relative
    rotations stay under max_rotation)."""
    cos = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5
           ).clamp(-1.0, 1.0)
    th = torch.arccos(cos)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    small = th < 1e-5
    scale = torch.where(small, 0.5 + th * th / 12.0,
                        th / (2.0 * torch.sin(th)).clamp(min=1e-12))
    return scale[..., None] * vee


def labels(A, B, trans_norm, rot_norm):
    t = (B[:, :3, 3] - A[:, :3, 3]) / trans_norm
    rel = B[:, :3, :3] @ A[:, :3, :3].transpose(-1, -2)
    rel = rel / torch.linalg.vector_norm(rel, dim=-2, keepdim=True).clamp(
        min=1e-12)
    return t, so3_log(rel) / rot_norm


def loss_and_grads(params, buffers, raw, aug_draws, mean, std, cfg,
                   precision="float32", half_batch=False):
    """The loss of one step and d loss / d params. ``half_batch`` leaves
    the second half of the batch out (a planted fault)."""
    rgb, depth = augment(aug_draws, raw["rgbB"], raw["depthB"], raw["maskB"],
                         cfg["augment"])
    A, B = track.network_input(raw["rgbA"], raw["depthA"], rgb, depth,
                               raw["A_in_cam"], mean, std)
    tl, rl = labels(raw["A_in_cam"], raw["B_in_cam"], cfg["train_trans_norm"],
                    cfg["train_rot_norm"])
    if half_batch:
        n = A.shape[0] // 2
        A, B, tl, rl = A[:n], B[:n], tl[:n], rl[:n]
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with cnn.Arith(precision):  # the backward in the same arithmetic
        out = cnn.forward(leaves, buffers, A, B, train=True,
                          precision=precision)
        loss = cnn.loss(out, tl, rl)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


class Adam:
    """torch.optim.Adam's update with L2 weight decay on the gradient, from
    zero moments or from a state ``(m, v, t)`` given."""

    def __init__(self, params, lr, betas, eps, weight_decay, state=None):
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        if state is None:
            self.t = 0
            self.m = {k: torch.zeros_like(v) for k, v in params.items()}
            self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        else:
            m, v, self.t = state
            self.m = {k: m[k].clone() for k in params}
            self.v = {k: v[k].clone() for k in params}
        self.first_grad = None

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        b1, b2 = self.betas
        out, seen = {}, {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            seen[k] = g
            self.m[k] = self.m[k] * b1 + g * (1 - b1)
            self.v[k] = self.v[k] * b2 + g * g * (1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(1 - b2 ** self.t)) + self.eps
            out[k] = p - (self.lr / (1 - b1 ** self.t)) * self.m[k] / denom
        if self.first_grad is None:
            self.first_grad = seen
        return out
