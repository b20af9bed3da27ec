"""Weights carried across from the JAX package.

Counterpart of ``iros20_6d_pose_tracking_tpu/models/torch_import.py``: the
port keeps its own copy of that module's ``variables_to_state_dict``,
``state_dict_to_variables`` and key tables (numpy only), so it imports
nothing of the JAX package. The layout work: HWIO <-> OIHW kernels, (I, O)
<-> (O, I) dense weights, Flax BatchNorm scale/bias and batch stats <-> the
reference's BatchNorm keys.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

# Sequential-module key prefixes in the reference model and the Flax names.
_CONV_BN_BLOCKS = ("convA1", "convB1", "convAB1", "trans_conv1", "rot_conv1")
_RES_BLOCKS = ("convA2", "convB2", "convB3", "convAB2", "trans_conv2",
               "rot_conv2")
_DENSE_HEADS = ("trans_out", "rot_out")


def variables_to_state_dict(variables: Mapping[str, Any]) -> dict:
    """Flax ``{"params", "batch_stats"}`` -> reference-format numpy
    state_dict (the JAX package's conversion, key for key)."""
    params = variables["params"]
    stats = variables["batch_stats"]
    out: dict = {}

    def oihw(kernel):
        return np.transpose(np.asarray(kernel), (3, 2, 0, 1))

    for blk in _CONV_BN_BLOCKS:
        p, s = params[blk], stats[blk]["bn"]
        out[f"{blk}.0.weight"] = oihw(p["conv"]["kernel"])
        out[f"{blk}.0.bias"] = np.asarray(p["conv"]["bias"])
        out[f"{blk}.1.weight"] = np.asarray(p["bn"]["scale"])
        out[f"{blk}.1.bias"] = np.asarray(p["bn"]["bias"])
        out[f"{blk}.1.running_mean"] = np.asarray(s["mean"])
        out[f"{blk}.1.running_var"] = np.asarray(s["var"])

    for blk in _RES_BLOCKS:
        for i in (1, 2):
            conv, bn = params[blk][f"conv{i}"], params[blk][f"bn{i}"]
            st = stats[blk][f"bn{i}"]
            out[f"{blk}.conv{i}.weight"] = oihw(conv["kernel"])
            if "bias" in conv:
                out[f"{blk}.conv{i}.bias"] = np.asarray(conv["bias"])
            out[f"{blk}.bn{i}.weight"] = np.asarray(bn["scale"])
            out[f"{blk}.bn{i}.bias"] = np.asarray(bn["bias"])
            out[f"{blk}.bn{i}.running_mean"] = np.asarray(st["mean"])
            out[f"{blk}.bn{i}.running_var"] = np.asarray(st["var"])

    for head in _DENSE_HEADS:
        out[f"{head}.0.weight"] = np.asarray(params[head]["kernel"]).T
        out[f"{head}.0.bias"] = np.asarray(params[head]["bias"])
    return out


def state_dict_to_variables(state_dict: Mapping[str, Any]) -> dict:
    """Reference-format state_dict (tensors or ndarrays) -> Flax
    ``{"params", "batch_stats"}`` of numpy float32 arrays (the JAX
    package's conversion, key for key): the weights a Flax checkpoint of
    this network holds (``train.checkpoint.save_flax_checkpoint``)."""

    def arr(key):
        v = state_dict[key]
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        return np.asarray(v, dtype=np.float32)

    def hwio(w):
        return np.transpose(w, (2, 3, 1, 0))

    params: dict = {}
    stats: dict = {}
    for blk in _CONV_BN_BLOCKS:
        params[blk] = {
            "conv": {"kernel": hwio(arr(f"{blk}.0.weight")),
                     "bias": arr(f"{blk}.0.bias")},
            "bn": {"scale": arr(f"{blk}.1.weight"),
                   "bias": arr(f"{blk}.1.bias")}}
        stats[blk] = {"bn": {"mean": arr(f"{blk}.1.running_mean"),
                             "var": arr(f"{blk}.1.running_var")}}
    for blk in _RES_BLOCKS:
        p, s = {}, {}
        for i in (1, 2):
            p[f"conv{i}"] = {"kernel": hwio(arr(f"{blk}.conv{i}.weight"))}
            if f"{blk}.conv{i}.bias" in state_dict:
                p[f"conv{i}"]["bias"] = arr(f"{blk}.conv{i}.bias")
            p[f"bn{i}"] = {"scale": arr(f"{blk}.bn{i}.weight"),
                           "bias": arr(f"{blk}.bn{i}.bias")}
            s[f"bn{i}"] = {"mean": arr(f"{blk}.bn{i}.running_mean"),
                           "var": arr(f"{blk}.bn{i}.running_var")}
        params[blk], stats[blk] = p, s
    for head in _DENSE_HEADS:
        params[head] = {"kernel": arr(f"{head}.0.weight").T,
                        "bias": arr(f"{head}.0.bias")}
    return {"params": params, "batch_stats": stats}


def state_dict_from_jax(variables: Mapping[str, Any]) -> dict:
    """Flax ``{"params", "batch_stats"}`` of the JAX Se3TrackNet (numpy
    arrays, or anything ``np.asarray`` takes) -> a state_dict that
    :class:`~.tracknet.Se3TrackNet` loads with ``strict=True``.

    The Flax variables hold no BatchNorm step count, so every
    ``num_batches_tracked`` buffer starts at 0."""
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
          for k, v in variables_to_state_dict(variables).items()}
    for k in [k for k in sd if k.endswith(".running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd
