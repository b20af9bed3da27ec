"""FoundationPose's refiner (RefineNet; Wen et al., CVPR, 2024,
arXiv:2312.08344; NVlabs/FoundationPose ``learning/models/
refine_network.py``, ``network_modules.py``), plain: the network as
functions of a parameter dict, NHWC in, and its tracking step, two
render-and-compare rounds a frame (``track_one``, ``track_refine_iter``
2), the render and the crop taken from ``render.py`` and ``track.py``.

  ConvBNReLU(cin, cout, k, s): conv (bias, zero pad (k-1)//2) + BN + ReLU
  ResBlock(c): relu(bn(conv3x3)) -> bn(conv3x3) + x -> relu
  encodeA, shared by A and B: ConvBNReLU(6, 64, 7, 2),
    ConvBNReLU(64, 128, 3, 2), ResBlock(128) x 2
  encodeAB on cat(a, b): ResBlock(256) x 2, ConvBNReLU(256, 512, 3, 2),
    ResBlock(512) x 2
  tokens (N, h w, 512) + the sinusoidal embedding (max_len 400)
  trans, rot heads: post-norm encoder layer (4 heads of 128, feed-forward
    512, ReLU, LayerNorm eps 1e-5), Linear(512, 3) a token, token mean
  decode: t_B = t_A + trans d / 2, R_B = exp(tanh(rot) 20 deg) R_A

Inputs: rgb / 255 and the camera-frame XYZ map less t_A over d / 2, 0 where
z < 1 mm or any |coordinate| >= 2; A's points from the rendered depth at
the window's pixel centres, B's from the cropped depth at the crop's source
pixels. The ROI is ``track.roi_bbox``'s at 1.2 d (the configuration's
20% pad), so d = width / 1.2.

Departures from the published description, each an assumption: zero
padding; the whole point zeroed where any coordinate is out of bounds; RGB
and depth cropped nearest by cv2's integer floor (published: a perspective
warp); the published fp16 autocast is not modelled (this is float32).
``precision`` as in ``cnn.py``: "float32" (TF32 off) or "fp8" (every
convolution's, linear layer's and attention product's operands through
float8 e4m3), the network's only.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from . import cnn, render, track

BN_EPS = 1e-5
LN_EPS = 1e-5
EMBED = 512
HEADS = 4
MAX_TOKENS = 400
ROT_NORMALIZER = math.radians(20.0)
CROP_RATIO = 1.2
XYZ_BOUND = 2.0
ROUNDS = 2

# (kind, cin, cout, kernel, stride); "res" blocks keep their width
ENCODE_A = (("cbr", 6, 64, 7, 2), ("cbr", 64, 128, 3, 2),
            ("res", 128, 128, 3, 1), ("res", 128, 128, 3, 1))
ENCODE_AB = (("res", 256, 256, 3, 1), ("res", 256, 256, 3, 1),
             ("cbr", 256, 512, 3, 2), ("res", 512, 512, 3, 1),
             ("res", 512, 512, 3, 1))
STAGES = (("encodeA", ENCODE_A), ("encodeAB", ENCODE_AB))


def _convs(prefix, kind):
    """(conv prefix, bn prefix) pairs of one block."""
    if kind == "cbr":
        return [(f"{prefix}.net.0", f"{prefix}.net.1")]
    return [(f"{prefix}.conv1", f"{prefix}.bn1"),
            (f"{prefix}.conv2", f"{prefix}.bn2")]


def param_shapes() -> dict:
    """Trainable parameters, name -> shape, in the module's order."""
    out = {}
    for stage, spec in STAGES:
        for i, (kind, cin, cout, k, _) in enumerate(spec):
            for j, (conv, bn) in enumerate(_convs(f"{stage}.{i}", kind)):
                out[f"{conv}.weight"] = (cout, cin if j == 0 else cout, k, k)
                out[f"{conv}.bias"] = (cout,)
                out[f"{bn}.weight"] = (cout,)
                out[f"{bn}.bias"] = (cout,)
    for head in ("trans_head", "rot_head"):
        e = f"{head}.0"
        out[f"{e}.self_attn.in_proj_weight"] = (3 * EMBED, EMBED)
        out[f"{e}.self_attn.in_proj_bias"] = (3 * EMBED,)
        out[f"{e}.self_attn.out_proj.weight"] = (EMBED, EMBED)
        out[f"{e}.self_attn.out_proj.bias"] = (EMBED,)
        out[f"{e}.linear1.weight"] = (EMBED, EMBED)
        out[f"{e}.linear1.bias"] = (EMBED,)
        out[f"{e}.linear2.weight"] = (EMBED, EMBED)
        out[f"{e}.linear2.bias"] = (EMBED,)
        for ln in ("norm1", "norm2"):
            out[f"{e}.{ln}.weight"] = (EMBED,)
            out[f"{e}.{ln}.bias"] = (EMBED,)
        out[f"{head}.1.weight"] = (3, EMBED)
        out[f"{head}.1.bias"] = (3,)
    return out


def bn_names() -> list:
    return [bn for stage, spec in STAGES for i, (kind, *_) in enumerate(spec)
            for _, bn in _convs(f"{stage}.{i}", kind)]


def norm_layers() -> list:
    """Prefixes of the BatchNorm and LayerNorm layers (scale 1, shift 0)."""
    return bn_names() + [f"{h}.0.{ln}" for h in ("trans_head", "rot_head")
                         for ln in ("norm1", "norm2")]


def sinusoid(length: int, d: int = EMBED, device=None) -> torch.Tensor:
    """pe (length, d): sin(p w_i) at 2i, cos(p w_i) at 2i + 1, w_i =
    10000^(-2i/d)."""
    p = torch.arange(length, dtype=torch.float64, device=device)[:, None]
    w = torch.pow(10000.0, -torch.arange(0, d, 2, dtype=torch.float64,
                                         device=device) / d)
    pe = torch.zeros(length, d, dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(p * w)
    pe[:, 1::2] = torch.cos(p * w)
    return pe.float()


def _linear(ar, x, p, prefix):
    xw, w = ar.operands(x, p[f"{prefix}.weight"])
    return F.linear(xw, w, p[f"{prefix}.bias"])


def _conv(ar, x, p, prefix, stride, k):
    xw, w = ar.operands(x, p[f"{prefix}.weight"])
    return F.conv2d(xw, w, p[f"{prefix}.bias"], stride, (k - 1) // 2)


def _bn(x, p, b, prefix):
    return F.batch_norm(x, b[f"{prefix}.running_mean"],
                        b[f"{prefix}.running_var"], p[f"{prefix}.weight"],
                        p[f"{prefix}.bias"], False, 0.0, BN_EPS)


def _block(ar, x, p, b, prefix, kind, k, stride):
    if kind == "cbr":
        (c, n), = _convs(prefix, kind)
        return torch.relu(_bn(_conv(ar, x, p, c, stride, k), p, b, n))
    (c1, n1), (c2, n2) = _convs(prefix, kind)
    y = torch.relu(_bn(_conv(ar, x, p, c1, 1, 3), p, b, n1))
    y = _bn(_conv(ar, y, p, c2, 1, 3), p, b, n2)
    return torch.relu(y + x)


def _attention(ar, x, p, prefix):
    n, length, d = x.shape
    hd = d // HEADS
    qkv = F.linear(*ar.operands(x, p[f"{prefix}.in_proj_weight"]),
                   p[f"{prefix}.in_proj_bias"])
    q, k, v = qkv.reshape(n, length, 3, HEADS, hd).permute(2, 0, 3, 1, 4)
    qa, ka = ar.operands(q, k)
    s = qa @ ka.transpose(-1, -2) / math.sqrt(hd)
    pa, va = ar.operands(torch.softmax(s, dim=-1), v)
    o = (pa @ va).transpose(1, 2).reshape(n, length, d)
    return _linear(ar, o, p, f"{prefix}.out_proj")


def _encoder_layer(ar, x, p, prefix):
    def ln(v, name):
        return F.layer_norm(v, (EMBED,), p[f"{prefix}.{name}.weight"],
                            p[f"{prefix}.{name}.bias"], LN_EPS)

    x = ln(x + _attention(ar, x, p, f"{prefix}.self_attn"), "norm1")
    y = _linear(ar, torch.relu(_linear(ar, x, p, f"{prefix}.linear1")), p,
                f"{prefix}.linear2")
    return ln(x + y, "norm2")


@torch.no_grad()
def forward(params: dict, buffers: dict, A: torch.Tensor, B: torch.Tensor,
            precision: str = "float32") -> dict:
    """A, B: (N, H, W, 6) float32. Returns {"trans", "rot"} (N, 3), ``rot``
    before its tanh."""
    n = A.shape[0]
    with cnn.Arith(precision) as ar:
        x = torch.cat([A, B], 0).permute(0, 3, 1, 2)
        for i, (kind, _, _, k, s) in enumerate(ENCODE_A):
            x = _block(ar, x, params, buffers, f"encodeA.{i}", kind, k, s)
        x = torch.cat([x[:n], x[n:]], 1)
        for i, (kind, _, _, k, s) in enumerate(ENCODE_AB):
            x = _block(ar, x, params, buffers, f"encodeAB.{i}", kind, k, s)
        tokens = x.flatten(2).transpose(1, 2)
        tokens = tokens + sinusoid(tokens.shape[1], EMBED, tokens.device)
        out = {}
        for head in ("trans", "rot"):
            y = _encoder_layer(ar, tokens, params, f"{head}_head.0")
            out[head] = _linear(ar, y, params, f"{head}_head.1").mean(1)
    return out


# --- the tracking step ------------------------------------------------------

def xyz_map(depth_mm, us, vs, K):
    """(N, H, W, 3) camera-frame points (m) of ROI depths (N, H, W) whose
    pixel (i, j) samples the image at (vs[:, i], us[:, j])."""
    z = depth_mm / 1000.0
    x = (us[:, None, :] - K[0, 2]) * z / K[0, 0]
    y = (vs[:, :, None] - K[1, 2]) * z / K[1, 1]
    return torch.stack([x, y, z], -1)


def normalized(xyz, t, radius):
    n = (xyz - t[:, None, None, :]) / radius
    bad = (xyz[..., 2:] < 0.001) | (n.abs() >= XYZ_BOUND).any(-1,
                                                               keepdim=True)
    return torch.where(bad, 0.0, n)


def pair(mesh, poses, K, frames_rgb, frames_depth, width_mm, res, near, far):
    """The network's inputs (A, B) (N, res, res, 6) at each prior pose."""
    left, right, top, bottom = track.roi_bbox(poses, K, width_mm)
    win = torch.stack([left, right, top, bottom], -1).to(torch.float32)
    rgbA, depthA, _ = render.render(mesh, poses, K, win, (res, res), near,
                                    far)
    rgbB = track.crop_nearest(frames_rgb, left, right, top, bottom, res)
    depthB = track.crop_nearest(frames_depth, left, right, top, bottom, res)
    o = torch.arange(res, device=poses.device)
    c = (o[None] + 0.5).float()
    us = win[:, :1] + c * ((win[:, 1:2] - win[:, :1]) / res)
    vs = win[:, 2:3] + c * ((win[:, 3:] - win[:, 2:3]) / res)
    rows = top[:, None] + (o[None] * (bottom - top)[:, None]) // res
    cols = left[:, None] + (o[None] * (right - left)[:, None]) // res
    t = poses[:, :3, 3]
    radius = width_mm / 1000.0 / CROP_RATIO / 2.0
    xyzA = normalized(xyz_map(depthA, us, vs, K), t, radius)
    xyzB = normalized(xyz_map(depthB.float(), cols.float(), rows.float(), K),
                      t, radius)
    A = torch.cat([rgbA / 255.0, xyzA], -1)
    B = torch.cat([rgbB.float() / 255.0, xyzB], -1)
    return A, B


@torch.no_grad()
def step(params, buffers, mesh, K, poses, frames_rgb, frames_depth, cfg,
         precision="float32", block=32, rounds=ROUNDS):
    """The refiner's tracking update of N frames from their N prior poses
    (float32): ``rounds`` rounds, each from the last round's pose (in
    float32, as the program carries it), in blocks of ``block`` frames.
    Returns the new poses in float64."""
    width = cfg["object_width_mm"]
    radius = width / 1000.0 / CROP_RATIO / 2.0
    out = []
    for s in range(0, poses.shape[0], block):
        p = poses[s:s + block]
        for _ in range(rounds):
            A, B = pair(mesh, p, K, frames_rgb[s:s + block],
                        frames_depth[s:s + block], width,
                        cfg["resolution"], cfg["near_m"], cfg["far_m"])
            o = forward(params, buffers, A, B, precision)
            p64 = p.double()
            new = torch.zeros_like(p64)
            new[:, :3, 3] = p64[:, :3, 3] + o["trans"].double() * radius
            new[:, :3, :3] = track.so3_exp(
                torch.tanh(o["rot"].double()) * ROT_NORMALIZER) @ p64[:, :3,
                                                                     :3]
            new[:, 3, 3] = 1.0
            p = new.float()
        out.append(new)
    return torch.cat(out)
