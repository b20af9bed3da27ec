"""Photometric and geometric augmentation of the observed (B) branch, in
PyTorch, batched.

Counterpart of ``iros20_6d_pose_tracking_tpu/data/augment.py`` (reference
data_augmentation.py:48-267, train.py:85-92): the rendered prior (A) stays
clean, and B goes through

    HSV jitter -> brightness -> Gaussian noise -> Gaussian blur
    -> black cover [-> depth dropout, off in reference training]

Each transform is split in two (ROADMAP F7): ``draw_*(gen, n, hw, cfg,
device)`` makes every random number the transform needs for a batch of
``n`` samples on the generator's device and returns them as a dict of
tensors on ``device``; ``apply_*(draws, ...)`` applies them to (N, H, W, 3)
RGB, (N, H, W) depth and (N, H, W) bool mask tensors, with no per-sample
Python loop. A test can therefore feed the JAX package's own draws to the
port. :func:`augment_batch` draws for the whole batch on one generator and
applies the stack.

The JAX module's documented deviations from the reference are kept: noise
that leaves [0, 255] is clipped (not wrapped as uint8), and black cover
draws a fixed number of candidates and takes the first acceptable one.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.se3 import uniform
from ..ops import image as I

DEPTH_VALID_MIN = 100.0  # mm, reference data_augmentation.py:57


@dataclass(frozen=True)
class AugmentConfig:
    """Magnitudes from the reference config.yml:1-8."""

    hsv_noise: tuple = (15.0, 15.0, 15.0)
    hsv_prob: float = 0.5
    bright_mag: tuple = (0.5, 1.5)
    rgb_noise: float = 2.0
    depth_noise: float = 5.0
    noise_prob: float = 0.5
    blur_max_kernel: int = 6
    blur_prob: float = 0.4
    black_cover_prob: float = 0.2
    black_cover_tries: int = 8
    depth_missing_prob: float = 0.0   # disabled in reference training
    depth_missing_percent: float = 0.4


def _gate(gen, shape, device, prob):
    return torch.rand(shape, generator=gen, device=gen.device).to(device) < prob


def _randint(gen, shape, device, high):
    return torch.randint(0, high, shape, generator=gen,
                         device=gen.device).to(device)


def _blur_sizes(cfg: AugmentConfig) -> tuple[int, ...]:
    """Odd kernel sizes {3, 5, ..., 2n + 1}, n = blur_max_kernel // 2."""
    return tuple(2 * i + 1 for i in range(1, cfg.blur_max_kernel // 2 + 1))


def _per_sample(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(N,) -> broadcastable against ``like`` (N, ...)."""
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


# -- HSV jitter (reference data_augmentation.py:48-70) ---------------------

def draw_hsv(gen, n, hw, cfg: AugmentConfig, device) -> dict:
    lim = torch.tensor(cfg.hsv_noise, dtype=torch.float32)
    u = torch.rand((n, 3), generator=gen, device=gen.device)
    shifts = (u * 2.0 - 1.0) * lim.to(gen.device)
    return {"shifts": shifts.to(device),
            "gates": _gate(gen, (n, 3), device, cfg.hsv_prob)}


def apply_hsv(d: dict, rgb, depth):
    """Per-channel HSV shift of the valid-depth pixels."""
    hsv = I.rgb_to_hsv(rgb)
    hsv = hsv + torch.where(d["gates"], d["shifts"], 0.0)[:, None, None, :]
    hsv = torch.clamp(hsv, 0.0, 255.0)
    out = torch.clamp(I.hsv_to_rgb(hsv), 0.0, 255.0)
    return torch.where((depth > DEPTH_VALID_MIN)[..., None], out, rgb)


# -- brightness (reference data_augmentation.py:73-81) ----------------------

def draw_bright(gen, n, hw, cfg: AugmentConfig, device) -> dict:
    return {"mag": uniform(gen, (n,), device, *cfg.bright_mag)}


def apply_bright(d: dict, rgb):
    """Global brightness scale (the reference applies it unconditionally)."""
    return torch.clamp(rgb * _per_sample(d["mag"], rgb), 0.0, 255.0)


# -- Gaussian noise (reference data_augmentation.py:85-102) -----------------

def draw_noise(gen, n, hw, cfg: AugmentConfig, device) -> dict:
    H, W = hw
    return {
        "std_rgb": uniform(gen, (n,), device, 0.0, cfg.rgb_noise),
        "noise_rgb": torch.randn((n, H, W, 3), generator=gen,
                                 device=gen.device).to(device),
        "gate_rgb": _gate(gen, (n,), device, cfg.noise_prob),
        "std_d": uniform(gen, (n,), device, 0.0, cfg.depth_noise),
        "noise_d": torch.randn((n, H, W), generator=gen,
                               device=gen.device).to(device),
        "gate_d": _gate(gen, (n,), device, cfg.noise_prob),
    }


def apply_noise(d: dict, rgb, depth):
    """Additive Gaussian noise on the valid-depth pixels, RGB and depth
    gated independently."""
    mask = depth > DEPTH_VALID_MIN
    noisy = torch.clamp(rgb + d["noise_rgb"] * _per_sample(d["std_rgb"], rgb),
                        0.0, 255.0)
    rgb = torch.where(_per_sample(d["gate_rgb"], rgb) & mask[..., None],
                      noisy, rgb)
    noisy_d = depth + d["noise_d"] * _per_sample(d["std_d"], depth)
    depth = torch.where(_per_sample(d["gate_d"], depth) & mask, noisy_d,
                        depth)
    return rgb, depth


# -- Gaussian blur (reference data_augmentation.py:105-121) -----------------

def draw_blur(gen, n, hw, cfg: AugmentConfig, device) -> dict:
    k = len(_blur_sizes(cfg))
    return {"idx_rgb": _randint(gen, (n,), device, k),
            "idx_d": _randint(gen, (n,), device, k),
            "gate_rgb": _gate(gen, (n,), device, cfg.blur_prob),
            "gate_d": _gate(gen, (n,), device, cfg.blur_prob)}


def apply_blur(d: dict, rgb, depth, cfg: AugmentConfig):
    """Blur of a per-sample random odd kernel size, sigma 2; RGB and depth
    with their own size and gate."""
    sizes = _blur_sizes(cfg)
    blurred = I.gaussian_blur_select(rgb, sizes, d["idx_rgb"], 2.0,
                                     channels_last=True)
    blurred_d = I.gaussian_blur_select(depth, sizes, d["idx_d"], 2.0)
    rgb = torch.where(_per_sample(d["gate_rgb"], rgb), blurred, rgb)
    depth = torch.where(_per_sample(d["gate_d"], depth), blurred_d, depth)
    return rgb, depth


# -- black cover (reference data_augmentation.py:217-267) -------------------

def draw_black_cover(gen, n, hw, cfg: AugmentConfig, device) -> dict:
    H, W = hw
    T = cfg.black_cover_tries
    return {"apply": _gate(gen, (n,), device, cfg.black_cover_prob),
            "cu": _randint(gen, (n, T), device, W),
            "cv": _randint(gen, (n, T), device, H),
            "quad": _randint(gen, (n, T), device, 4)}


def apply_black_cover(d: dict, rgb, depth, mask):
    """Quadrant occlusion that keeps >= 50% of the object visible: of the
    candidate (corner, quadrant) draws, the first acceptable one is used;
    none when no candidate is acceptable."""
    N, H, W = depth.shape
    num_valid = torch.clamp(mask.to(torch.float32).sum(dim=(1, 2)), min=1.0)
    ys = torch.arange(H, device=depth.device)[None, None, :, None]
    xs = torch.arange(W, device=depth.device)[None, None, None, :]
    above = ys < d["cv"][..., None, None]           # (N, T, H, 1)
    left = xs < d["cu"][..., None, None]            # (N, T, 1, W)
    quad = d["quad"][..., None, None]
    want_above = (quad == 0) | (quad == 1)
    want_left = (quad == 0) | (quad == 2)
    covers = (above == want_above) & (left == want_left)  # (N, T, H, W)
    remain = (mask[:, None] & ~covers).to(torch.float32).sum(dim=(2, 3)) \
        / num_valid[:, None]
    oks = remain >= 0.5
    # the first acceptable candidate (0 if none)
    first = torch.argmax(oks.to(torch.int32), dim=1)
    cover = covers[torch.arange(N, device=depth.device), first]
    cover = cover & _per_sample(d["apply"] & oks.any(dim=1), cover)
    rgb = torch.where(cover[..., None], 0.0, rgb)
    depth = torch.where(cover, -9999.0, depth)
    return rgb, depth, mask & ~cover


# -- depth dropout (reference data_augmentation.py:200-214) -----------------

def draw_depth_missing(gen, n, hw, cfg: AugmentConfig, device) -> dict:
    return {"apply": _gate(gen, (n,), device, cfg.depth_missing_prob),
            "frac": uniform(gen, (n,), device, 0.0, cfg.depth_missing_percent),
            "u": uniform(gen, (n,) + tuple(hw), device)}


def apply_depth_missing(d: dict, depth):
    drop = (d["u"] < _per_sample(d["frac"], depth)) & (depth > DEPTH_VALID_MIN)
    return torch.where(_per_sample(d["apply"], depth) & drop, 0.0, depth)


# -- the stack (reference train.py:85-92) -----------------------------------

_DRAWS = (("hsv", draw_hsv), ("bright", draw_bright), ("noise", draw_noise),
          ("blur", draw_blur), ("black_cover", draw_black_cover),
          ("depth_missing", draw_depth_missing))


def draw_augment(gen: torch.Generator, n: int, hw, cfg: AugmentConfig,
                 device) -> dict:
    """Every draw of the B-branch stack for ``n`` samples of size ``hw``,
    made on ``gen``'s device in a fixed order and moved to ``device``.
    Depth dropout is drawn only when ``cfg.depth_missing_prob > 0``."""
    out = {}
    for name, draw in _DRAWS:
        if name == "depth_missing" and cfg.depth_missing_prob <= 0:
            continue
        out[name] = draw(gen, n, tuple(hw), cfg, device)
    return out


def apply_augment(d: dict, rgbB, depthB, maskB, cfg: AugmentConfig):
    """The B-branch stack on a batch, from :func:`draw_augment`'s draws."""
    rgbB = apply_hsv(d["hsv"], rgbB, depthB)
    rgbB = apply_bright(d["bright"], rgbB)
    rgbB, depthB = apply_noise(d["noise"], rgbB, depthB)
    rgbB, depthB = apply_blur(d["blur"], rgbB, depthB, cfg)
    rgbB, depthB, maskB = apply_black_cover(d["black_cover"], rgbB, depthB,
                                            maskB)
    if cfg.depth_missing_prob > 0:
        depthB = apply_depth_missing(d["depth_missing"], depthB)
    return rgbB, depthB, maskB


def sample_draws(d, i: int):
    """Row ``i`` of a batch's draws, as the draws of a batch of one."""
    if isinstance(d, dict):
        return {k: sample_draws(v, i) for k, v in d.items()}
    return d[i:i + 1]


def augment_b(draws: dict, rgbB, depthB, maskB, cfg: AugmentConfig):
    """One sample, (H, W, 3), (H, W), (H, W): the stack with the draws of a
    batch of one (``draw_augment(gen, 1, ...)``)."""
    r, d, m = apply_augment(draws, rgbB[None], depthB[None], maskB[None], cfg)
    return r[0], d[0], m[0]


def augment_batch(gen: torch.Generator, rgbB, depthB, maskB,
                  cfg: AugmentConfig):
    """Augment a batch (N, H, W, 3), (N, H, W), (N, H, W): draw for the
    whole batch on ``gen`` and apply the stack batched. Sample i gets the
    same result as :func:`augment_b` with ``sample_draws(draws, i)``."""
    draws = draw_augment(gen, rgbB.shape[0], depthB.shape[1:], cfg,
                         rgbB.device)
    return apply_augment(draws, rgbB, depthB, maskB, cfg)
