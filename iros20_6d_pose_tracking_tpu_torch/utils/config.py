"""Config loading: the reference's config.yml and dataset_info.yml.

Counterpart of ``iros20_6d_pose_tracking_tpu/utils/config.py``. Its
file-resolution helpers are numpy only and are re-exported, not copied;
:func:`train_config_from_yaml` builds the port's own ``TrainConfig``.
PyYAML is imported only when a file is read.
"""
from __future__ import annotations

from typing import Any

from iros20_6d_pose_tracking_tpu.utils.config import (  # noqa: F401
    find_dataset_info,
    load_mean_std,
    load_yaml,
    normalizers_from_info,
)


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
