"""Checkpoint save and load with full train-state resume, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/train/checkpoint.py``. A
checkpoint is one ``torch.save`` file holding the model's state_dict, the
optimizer's, the step and epoch counters, the 8-channel normalization
statistics and the best losses so far, plus a JSON sidecar
(``<path>.json``) of human-readable metadata. It loads with
``torch.load(weights_only=True)``: tensors, numbers and containers only.
The artifact names follow the reference (reference problems.py:143,150):
``model_best_train.pt``, ``model_best_val.pt``, ``checkpoint_last.pt``.
Reading the JAX package's Flax msgpack files is not ported (ROADMAP.md).
"""
from __future__ import annotations

import json
import os

import torch


def save_checkpoint(path: str, state: dict, metadata: dict | None = None):
    """``torch.save`` ``state`` to ``path`` (written to a temporary file and
    renamed, so a crash leaves the previous checkpoint whole), and
    ``metadata`` to ``path + ".json"``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f, indent=2, default=float)


def load_checkpoint(path: str, map_location="cpu") -> dict:
    """The state dict of a checkpoint, tensors on ``map_location``."""
    return torch.load(path, map_location=map_location, weights_only=True)


def load_metadata(path: str) -> dict:
    meta_path = path + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def latest_checkpoint(outdir: str) -> str | None:
    """The resume checkpoint of a training output directory, if any."""
    path = os.path.join(outdir, "checkpoint_last.pt")
    return path if os.path.exists(path) else None
