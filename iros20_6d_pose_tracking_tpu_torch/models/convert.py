"""Weights carried across from the JAX package.

Counterpart of ``iros20_6d_pose_tracking_tpu/models/torch_import.py``,
whose numpy-only ``variables_to_state_dict`` does the layout work (HWIO ->
OIHW kernels, (I, O) -> (O, I) dense weights, Flax BatchNorm scale/bias and
batch stats -> the reference's BatchNorm keys).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from iros20_6d_pose_tracking_tpu.models import torch_import


def state_dict_from_jax(variables: Mapping[str, Any]) -> dict:
    """Flax ``{"params", "batch_stats"}`` of the JAX Se3TrackNet (numpy
    arrays, or anything ``np.asarray`` takes) -> a state_dict that
    :class:`~.tracknet.Se3TrackNet` loads with ``strict=True``.

    The Flax variables hold no BatchNorm step count, so every
    ``num_batches_tracked`` buffer starts at 0."""
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
          for k, v in torch_import.variables_to_state_dict(variables).items()}
    for k in [k for k in sd if k.endswith(".running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd
