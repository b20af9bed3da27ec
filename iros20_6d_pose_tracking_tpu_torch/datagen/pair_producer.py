"""Procedural textures for synthetic scenes, in numpy and PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/datagen/pair_producer.py``,
of which only :func:`_procedural_texture` is ported: the hard test videos of
``eval/synthetic_benchmark.py`` put one behind the object. The JAX module
imports jax at the top, so it cannot be re-exported. The pair factory
(``PairProducer``, ``render_dr_scene``, ``DRSceneGenerator``,
``produce_dataset``, ``complete_blender``) is ROADMAP.md P15.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _upsample_linear(small: np.ndarray, height: int, width: int) -> np.ndarray:
    """(h, w, 3) -> (height, width, 3) float32 by bilinear interpolation with
    half-pixel centres and clamped edges: ``jax.image.resize(..., "linear")``
    when it enlarges, as it does here."""
    x = torch.from_numpy(small.astype(np.float32)).permute(2, 0, 1)[None]
    up = F.interpolate(x, size=(height, width), mode="bilinear",
                       align_corners=False)
    return up[0].permute(1, 2, 0).numpy()


def _procedural_texture(rng: np.random.RandomState, height: int,
                        width: int) -> np.ndarray:
    """A random texture from one of four families (multi-octave noise,
    checker, stripes, gradient+noise) — richer stand-ins for the
    reference's texture files when no pool is provided. The draws from
    ``rng`` are the JAX function's, in the same order."""
    fam = rng.randint(4)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    c0 = rng.uniform(0, 255, 3).astype(np.float32)
    c1 = rng.uniform(0, 255, 3).astype(np.float32)
    if fam == 0:  # multi-octave noise
        img = np.zeros((height, width, 3), np.float32)
        for scale in (8, 32, 128):
            small = rng.uniform(0, 1, (max(height // scale, 1),
                                       max(width // scale, 1), 3))
            img += _upsample_linear(small, height, width)
        img = img / 3.0 * 255.0
    elif fam == 1:  # checker
        period = rng.randint(16, 96)
        mask = ((yy // period + xx // period) % 2)[..., None]
        img = mask * c0 + (1 - mask) * c1
    elif fam == 2:  # stripes at a random angle
        theta = rng.uniform(0, np.pi)
        period = rng.uniform(12, 80)
        phase = np.sin((xx * np.cos(theta) + yy * np.sin(theta))
                       * (2 * np.pi / period))
        mask = (phase > 0)[..., None]
        img = mask * c0 + (1 - mask) * c1
    else:  # smooth two-color gradient + noise
        t = (xx / width * rng.uniform(-1, 1)
             + yy / height * rng.uniform(-1, 1) + 1) / 2
        img = t[..., None] * c0 + (1 - t[..., None]) * c1
        img += rng.uniform(-20, 20, (height, width, 1))
    return np.clip(img, 0, 255).astype(np.float32)
