"""The refiner's weights (``reference/refiner.py``'s parameter layout), made
from ``--seed`` on the device, as ``scene.make_weights`` makes
Se3TrackNet's."""
from __future__ import annotations

import math

import numpy as np
import torch

from . import scene
from .reference import refiner


def make_weights(cfg: dict, seed: int, device):
    """(params, buffers) float32 on ``device``: convolution, linear and
    attention-projection weights and biases uniform in +-1/sqrt(fan_in)
    (torch's default range), BatchNorm and LayerNorm scale 1 and shift 0,
    BatchNorm running means uniform in [-0.5, 0.5] and variances in [0.5,
    2], the heads' Linear(512, 3) weights scaled by ``head_scale`` and
    their biases 0. One draw for all."""
    shapes = refiner.param_shapes()
    norms = set(refiner.norm_layers())
    bns = refiner.bn_names()
    channels = [shapes[f"{b}.weight"][0] for b in bns]
    sizes = [int(np.prod(s)) for s in shapes.values()]
    gen = scene.generator(device, seed, "refiner-weights")
    u = scene.uniform(gen, (sum(sizes) + 2 * sum(channels),), -1.0, 1.0)
    params, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        layer, kind = name.rsplit(".", 1)
        if layer in norms:
            val = torch.full(shape, 1.0 if kind == "weight" else 0.0,
                             device=device)
        else:
            weight = name[:-4] + "weight" if name.endswith("bias") else name
            val = u[at:at + n].reshape(shape) / math.sqrt(
                int(np.prod(shapes[weight][1:])))
            if layer.endswith("_head.1"):
                val = val * cfg["weights"]["head_scale"] \
                    if kind == "weight" else torch.zeros_like(val)
        params[name] = val.contiguous()
        at += n
    buffers = {}
    for b, c in zip(bns, channels):
        buffers[f"{b}.running_mean"] = (u[at:at + c] * 0.5).contiguous()
        buffers[f"{b}.running_var"] = (u[at + c:at + 2 * c] * 0.75 + 1.25
                                       ).contiguous()
        at += 2 * c
    return params, buffers
