"""Config loading: the reference's config.yml and dataset_info.yml.

Counterpart of ``iros20_6d_pose_tracking_tpu/utils/config.py``, whose four
file-resolution helpers the port keeps its own copy of (numpy only), so it
imports nothing of the JAX package; :func:`train_config_from_yaml` builds
the port's own ``TrainConfig``. PyYAML is imported only when a file is
read.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def find_dataset_info(train_data_path: str) -> str:
    """dataset_info.yml lives one level above the data folder
    (reference train.py:76, predict.py:652), or beside it."""
    for cand in (os.path.join(train_data_path, "..", "dataset_info.yml"),
                 os.path.join(train_data_path, "dataset_info.yml")):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"dataset_info.yml near {train_data_path}")


def load_mean_std(path: str) -> tuple[np.ndarray, np.ndarray]:
    """mean.npy/std.npy artifacts (reference train.py:124-125)."""
    return (np.load(os.path.join(path, "mean.npy")),
            np.load(os.path.join(path, "std.npy")))


def normalizers_from_info(dataset_info: dict) -> tuple[float, float]:
    """(trans m, rot rad) training normalizers (dataset_info.yml:12-13)."""
    return (float(dataset_info["max_translation"]),
            float(dataset_info["max_rotation"]) * np.pi / 180.0)


def train_config_from_yaml(config: dict, dataset_info: dict,
                           **overrides: Any):
    """reference config.yml + dataset_info.yml -> ``train.trainer.TrainConfig``
    (the same fields and defaults as the JAX package's)."""
    from ..data.augment import AugmentConfig
    from ..train.trainer import TrainConfig

    aug_c = config.get("data_augmentation", {})
    t_norm, r_norm = normalizers_from_info(dataset_info)
    kw = dict(
        learning_rate=float(config.get("learning_rate", 1e-3)),
        weight_decay=float(config.get("weight_decay", 1e-6)),
        epochs=int(config.get("epochs", 300)),
        batch_size=int(config.get("batch_size", 200)),
        trans_loss_weight=float(config.get("loss_weights", {}).get("trans", 1)),
        rot_loss_weight=float(config.get("loss_weights", {}).get("rot", 1)),
        trans_normalizer=t_norm,
        rot_normalizer=r_norm,
        resolution=int(dataset_info["resolution"]),
        aug=AugmentConfig(
            hsv_noise=tuple(aug_c.get("hsv_noise", (15, 15, 15))),
            bright_mag=tuple(aug_c.get("bright_mag", (0.5, 1.5))),
            rgb_noise=float(aug_c.get("gaussian_noise", {}).get("rgb", 2)),
            depth_noise=float(aug_c.get("gaussian_noise", {}).get("depth", 5)),
            blur_max_kernel=int(aug_c.get("gaussian_blur_kernel", 6)),
            black_cover_prob=0.2,  # reference train.py:90
        ),
    )
    kw.update(overrides)
    return TrainConfig(**kw)
