"""The benchmark's inputs, made from ``--seed`` by the benchmark's own
plain code and handed alike to the program and to the reference: the
object's mesh, the network's weights, the recorded RGB-D video and its
ground-truth trajectory, and every random draw of a training step.

Tensors are made on the device with ``torch.Generator``s on that device,
in a few large calls; each purpose has its own stream (``generator``)."""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from .reference import cnn
from .reference.track import so3_exp


def generator(device, seed: int, *purpose) -> torch.Generator:
    """A generator on ``device`` for one purpose of one run's seed."""
    key = repr((int(seed),) + tuple(purpose)).encode()
    s = int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(), "little")
    return torch.Generator(device=torch.device(device)).manual_seed(
        s & ((1 << 63) - 1))


def uniform(gen, shape, lo=0.0, hi=1.0):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


# --- the mesh ---------------------------------------------------------------

def icosphere(subdiv: int, radius: float, color):
    """Midpoint-subdivided icosahedron with the banded vertex albedo
    0.3 color + 0.7 (0.5 + 0.5 sin(6 n + (0, 1, 2)))."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                      [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                      [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                     np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10],
                      [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                      [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6],
                      [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                      [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        mids, vl = {}, list(verts)

        def mid(i, j):
            k = (min(i, j), max(i, j))
            if k not in mids:
                m = (verts[i] + verts[j]) / 2.0
                mids[k] = len(vl)
                vl.append(m / np.linalg.norm(m))
            return mids[k]

        nf = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts, faces = np.array(vl), np.array(nf, np.int64)
    n = verts.astype(np.float32)
    band = np.stack([0.5 + 0.5 * np.sin(n[:, k] * 6.0 + k) for k in range(3)],
                    -1)
    colors = 0.3 * np.asarray(color, np.float32) + 0.7 * band
    return (verts * radius).astype(np.float32), faces, colors.astype(
        np.float32)


def decimate(verts, faces, colors, target: int, iters: int = 8):
    """Vertex clustering on a grid whose cell is bisected (geometrically)
    towards ``target`` faces; vertices and colours of a cell averaged,
    collapsed faces dropped."""
    v = np.asarray(verts, np.float64)
    lo = v.min(0)
    extent = float(np.max(v.max(0) - lo))

    def cluster(cell):
        keys = np.floor((v - lo) / cell).astype(np.int64)
        _, inv = np.unique(keys, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        n = inv.max() + 1
        cnt = np.bincount(inv, minlength=n)[:, None].astype(np.float64)
        nv = np.stack([np.bincount(inv, v[:, k], n) for k in range(3)],
                      1) / cnt
        nc = np.stack([np.bincount(inv, colors[:, k].astype(np.float64), n)
                       for k in range(3)], 1) / cnt
        f = inv[faces]
        keep = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (
            f[:, 0] != f[:, 2])
        return nv, f[keep], nc

    lo_c, hi_c, best = extent / 512.0, extent / 2.0, None
    for _ in range(iters):
        cell = math.sqrt(lo_c * hi_c)
        out = cluster(cell)
        if best is None or abs(len(out[1]) - target) < abs(
                len(best[1]) - target):
            best = out
        if len(out[1]) > target:
            lo_c = cell
        else:
            hi_c = cell
    v, f, c = best
    return v.astype(np.float32), f.astype(np.int64), c.astype(np.float32)


def vertex_normals(verts, faces):
    """Area-weighted vertex normals."""
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    n = np.zeros_like(verts)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    return (n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
            ).astype(np.float32)


def make_mesh(cfg: dict) -> dict:
    """The configuration's object as numpy arrays: verts (V, 3), faces
    (F, 3), colors (V, 3), normals (V, 3); and its diameter (m)."""
    m = cfg["mesh"]
    v, f, c = icosphere(m["subdiv"], m["radius_m"], m["color"])
    v, f, c = decimate(v, f, c, m["max_faces"])
    d = np.sqrt(((v[:, None] - v[None]) ** 2).sum(-1).max())
    return {"verts": v, "faces": f, "colors": c,
            "normals": vertex_normals(v, f), "diameter_m": float(d)}


def mesh_on(mesh: dict, device) -> dict:
    return {k: torch.as_tensor(mesh[k]).to(device)
            for k in ("verts", "faces", "colors", "normals")}


# --- the network's weights --------------------------------------------------

def make_weights(cfg: dict, seed: int, device):
    """(params, buffers) of the network, float32 on ``device``: convolution
    and linear weights and biases uniform in +-1/sqrt(fan_in) (torch's
    default initialisation), BatchNorm scale 1 and shift 0, running means
    uniform in [-0.5, 0.5] and variances in [0.5, 2], the heads' weights
    scaled by ``head_scale`` and their biases 0. One draw for all."""
    w = cfg["weights"]
    shapes = cnn.param_shapes()
    sizes = [int(np.prod(s)) for s in shapes.values()]
    bns = cnn.bn_names()
    gen = generator(device, seed, "weights")
    u = uniform(gen, (sum(sizes) + 2 * sum(shapes[f"{b}.weight"][0]
                                           for b in bns),), -1.0, 1.0)
    params, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        layer = name.rsplit(".", 1)[0]
        if layer in bns:
            val = torch.full(shape, 1.0 if name.endswith("weight") else 0.0,
                             device=device)
        else:
            fan = cnn.fan_in(shapes[f"{layer}.weight"])
            val = u[at:at + n].reshape(shape) / math.sqrt(fan)
            if layer.endswith("_out.0"):
                val = val * w["head_scale"] if name.endswith("weight") \
                    else torch.zeros_like(val)
        params[name] = val.contiguous()
        at += n
    buffers = {}
    for b in bns:
        c = shapes[f"{b}.weight"][0]
        buffers[f"{b}.running_mean"] = (u[at:at + c] * 0.5).contiguous()
        buffers[f"{b}.running_var"] = (u[at + c:at + 2 * c] * 0.75 + 1.25
                                       ).contiguous()
        at += 2 * c
    return params, buffers


# --- the recorded video -----------------------------------------------------

def trajectory(cfg: dict, seed: int, n: int, device) -> torch.Tensor:
    """(n, 4, 4) float32 ground-truth poses: a seeded smooth path, each
    coordinate of the translation and of the rotation vector a constant
    plus three sines of 1, 2 and 3 cycles over the video, the largest step
    a frame well inside max_translation and max_rotation."""
    v = cfg["video"]
    gen = generator(device, seed, "trajectory")
    s = torch.arange(n, device=device, dtype=torch.float64)[:, None, None]
    freq = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64,
                        device=device)[None, None, :]

    def path(centre_lo, centre_hi, amp):
        c = uniform(gen, (3,), 0.0, 1.0).double()
        c = torch.tensor(centre_lo, device=device, dtype=torch.float64) + c * (
            torch.tensor(centre_hi, device=device, dtype=torch.float64)
            - torch.tensor(centre_lo, device=device, dtype=torch.float64))
        a = uniform(gen, (1, 3, 3), 0.0, amp).double()
        ph = uniform(gen, (1, 3, 3), 0.0, 2 * math.pi).double()
        return c + (a * torch.sin(2 * math.pi * freq * s / n + ph)).sum(-1)

    t = path(v["centre_lo_m"], v["centre_hi_m"], v["amplitude_m"])
    w = path((-math.pi,) * 3, (math.pi,) * 3, v["amplitude_rad"])
    pose = torch.zeros((n, 4, 4), dtype=torch.float64, device=device)
    pose[:, :3, :3] = so3_exp(w)
    pose[:, :3, 3] = t
    pose[:, 3, 3] = 1.0
    return pose.float()


def make_video(cfg: dict, seed: int, poses: torch.Tensor, device,
               block: int = 16):
    """The analytic RGB-D video of the sphere the mesh approximates, at the
    ground-truth poses, over a seeded smooth textured background plane:
    rgb (n, H, W, 3) uint8 and depth (n, H, W) int32 millimetres (the
    sensor's uint16 values, widened)."""
    cam, v, m = cfg["camera"], cfg["video"], cfg["mesh"]
    H, W = cam["height"], cam["width"]
    gen = generator(device, seed, "background")
    grid = uniform(gen, (1, 3, 12, 16))
    tex = torch.nn.functional.interpolate(grid, size=(H, W), mode="bilinear",
                                          align_corners=False)[0].permute(
        1, 2, 0) * 200.0 + 30.0
    tilt = uniform(gen, (2,), -0.3, 0.3)
    vv, uu = torch.meshgrid(
        torch.arange(H, device=device, dtype=torch.float32),
        torch.arange(W, device=device, dtype=torch.float32), indexing="ij")
    dx = (uu - cam["centerX"]) / cam["focalX"]
    dy = (vv - cam["centerY"]) / cam["focalY"]
    bg_depth = v["background_m"] + tilt[0] * dx + tilt[1] * dy
    d = torch.stack([dx, dy, torch.ones_like(dx)], -1)           # (H, W, 3)
    dd = (d * d).sum(-1)
    r = m["radius_m"]
    color = torch.tensor(m["color"], device=device)
    light = torch.tensor((0.0, -0.1, -0.9), device=device)
    rgbs, depths = [], []
    for s in range(0, poses.shape[0], block):
        P = poses[s:s + block]
        c = P[:, :3, 3][:, None, None, :]                          # (b,1,1,3)
        dc = (d * c).sum(-1)
        disc = dc * dc - dd * ((c * c).sum(-1) - r * r)
        hit = disc > 0
        z = (dc - disc.clamp(min=0).sqrt()) / dd                   # ray length
        p = z[..., None] * d
        n_cam = (p - c) / r
        n_obj = torch.einsum("bhwi,bij->bhwj", n_cam, P[:, :3, :3])
        band = 0.5 + 0.5 * torch.sin(n_obj * 6.0 + torch.arange(
            3, device=device))
        albedo = 0.3 * color + 0.7 * band
        l = light - p
        l = l / l.norm(dim=-1, keepdim=True)
        ndotl = (n_cam * l).sum(-1).clamp(min=0)
        lit = albedo * (0.65 + 0.4 * ndotl)[..., None]
        rgb = torch.where(hit[..., None], lit.clamp(0, 1) * 255.0, tex)
        depth = torch.where(hit, z, bg_depth) * 1000.0
        rgbs.append(rgb.round().to(torch.uint8))
        depths.append(depth.round().to(torch.int32))
    return torch.cat(rgbs), torch.cat(depths)


# --- the draws of a training step -------------------------------------------

def _direction_draws(gen, n):
    """Two uniforms in [0, 1) a sample: theta = 2 pi u_theta, cos(phi) =
    2 u_phi - 1."""
    return {"u_theta": uniform(gen, (n,)), "u_phi": uniform(gen, (n,))}


def _direction(d):
    th = d["u_theta"] * (2 * math.pi)
    cphi = 2.0 * d["u_phi"] - 1.0
    sphi = (1 - cphi * cphi).clamp(min=0).sqrt()
    return torch.stack([sphi * torch.cos(th), sphi * torch.sin(th), cphi], -1)


def _truncated_normal(gen, n):
    """Standard normal truncated to [-1, 1], by the inverse CDF."""
    lo, hi = (0.5 * (1 + math.erf(x / math.sqrt(2))) for x in (-1.0, 1.0))
    u = uniform(gen, (n,), lo, hi).double()
    return torch.special.ndtri(u).clamp(-1, 1).float()


def _pose(R, t):
    P = torch.zeros(R.shape[:-2] + (4, 4), device=R.device)
    P[..., :3, :3], P[..., :3, 3], P[..., 3, 3] = R, t, 1.0
    return P


def train_draws(cfg: dict, seed: int, step: int, device) -> dict:
    """Every random number of one training step: the pair's pose draws in
    the layout of the program's sampler (``synth``: B's rotation direction
    and angle in [0, pi), B's translation as uniforms over the view ranges,
    and a perturbation P of a uniform direction and a [-1, 1]-truncated
    normal magnitude of max_translation and max_rotation; the domain
    randomisation of B under ``synth["dr"]``), the B augmentation
    (``aug``), and the poses that the draws give (B, and A = B inv(P)),
    worked out here for the reference."""
    tr, res = cfg["train"], cfg["resolution"]
    n = tr["batch_size"]
    gen = generator(device, seed, "train", step)
    synth = {"dir_B": _direction_draws(gen, n),
             "angle_B": uniform(gen, (n, 1), 0.0, math.pi),
             "t_B": uniform(gen, (n, 3)),
             "pert": {"dir_t": _direction_draws(gen, n),
                      "mag_t": _truncated_normal(gen, n),
                      "dir_r": _direction_draws(gen, n),
                      "mag_r": _truncated_normal(gen, n)}}
    lo = torch.tensor([r[0] for r in tr["xyz_range_m"]], device=device)
    hi = torch.tensor([r[1] for r in tr["xyz_range_m"]], device=device)
    B = _pose(so3_exp(_direction(synth["dir_B"]) * synth["angle_B"]),
              synth["t_B"] * (hi - lo) + lo)
    pert = synth["pert"]
    pt = _direction(pert["dir_t"]) * (pert["mag_t"]
                                      * cfg["max_translation_m"])[:, None]
    max_rot = math.radians(cfg["max_rotation_deg"])
    pr = _direction(pert["dir_r"]) * (pert["mag_r"] * max_rot)[:, None]
    Rp = so3_exp(pr)
    inv = _pose(Rp.transpose(-1, -2), -(Rp.transpose(-1, -2) @ pt[..., None])[
        ..., 0])
    A = B @ inv

    def smooth(ch):
        return {"lo": uniform(gen, (n, 6, 6, ch)),
                "hi": uniform(gen, (n, 24, 24, ch))}

    drc = cfg["dr"]
    dr = {"bg_noise": smooth(3), "u_base": uniform(gen, (n,)),
          "grad": uniform(gen, (n, 2), -1.5, 1.5), "depth_noise": smooth(1),
          "use_bg": uniform(gen, (n,)) < drc["bg_prob"],
          "centre": uniform(gen, (n, 2), 0.2 * res, 0.8 * res),
          "radii": uniform(gen, (n, 2), 0.10 * res, 0.30 * res),
          "occ_scale": uniform(gen, (n,), 0.5, 0.85),
          "occ_colour": uniform(gen, (n, 3)), "occ_noise": smooth(3),
          "use_occ": uniform(gen, (n,)) < drc["occluder_prob"]}
    a = cfg["augment"]
    T = a["black_cover_tries"]
    k = a["blur_max_kernel"] // 2

    def randint(high, shape):
        return torch.randint(0, high, shape, generator=gen, device=device)

    aug = {
        "hsv": {"shifts": uniform(gen, (n, 3), -1.0, 1.0)
                * torch.tensor(a["hsv_noise"], device=device),
                "gates": uniform(gen, (n, 3)) < a["hsv_prob"]},
        "bright": {"mag": uniform(gen, (n,), *a["bright_mag"])},
        "noise": {"std_rgb": uniform(gen, (n,), 0.0, a["rgb_noise"]),
                  "noise_rgb": torch.randn((n, res, res, 3), generator=gen,
                                           device=device),
                  "gate_rgb": uniform(gen, (n,)) < a["noise_prob"],
                  "std_d": uniform(gen, (n,), 0.0, a["depth_noise"]),
                  "noise_d": torch.randn((n, res, res), generator=gen,
                                         device=device),
                  "gate_d": uniform(gen, (n,)) < a["noise_prob"]},
        "blur": {"idx_rgb": randint(k, (n,)), "idx_d": randint(k, (n,)),
                 "gate_rgb": uniform(gen, (n,)) < a["blur_prob"],
                 "gate_d": uniform(gen, (n,)) < a["blur_prob"]},
        "black_cover": {"apply": uniform(gen, (n,)) < a["black_cover_prob"],
                        "cu": randint(res, (n, T)), "cv": randint(res, (n, T)),
                        "quad": randint(4, (n, T))},
    }
    synth["dr"] = dr
    return {"synth": synth, "A_in_cam": A, "B_in_cam": B, "dr": dr, "aug": aug}
