"""Training CLI, config-file driven like reference train.py:56-165.

Counterpart of ``iros20_6d_pose_tracking_tpu/apps/train.py``:

    python -m iros20_6d_pose_tracking_tpu_torch.apps.train \
        --config config.yml [--output_path DIR] [--resume] \
        [--synthetic [--dr] --model_path MESH] [--epochs N] [--device cuda]

Reads ``config.yml`` (hyperparameters and data paths, reference
config.yml:1-20) and the ``dataset_info.yml`` one level above
``data_path`` (reference train.py:76-79), then runs the reference's two
passes: the dataset mean/std statistics (reference train.py:94-127), and
training with the best-train / best-val / last checkpoints
(``model_best_train.pt``, ``model_best_val.pt``, ``checkpoint_last.pt``).

Beyond the reference: ``--resume`` continues from ``checkpoint_last.pt``
(optimizer state included); ``--synthetic`` trains from the pair renderer
(``data.dataset.SyntheticPairs``) on the device instead of files, ``--dr``
adds its randomized scenes. Everything runs on ``--device`` (default
``cuda``); there is no fallback to another device. ``--bf16`` runs the
network's activations in bfloat16; the parameters, Adam's state, BatchNorm's
statistics and the loss stay float32.
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np


def main(argv=None):
    import torch
    import yaml

    from ..core.camera import Camera
    from ..data.dataset import DRComposite, PairDataset, SyntheticPairs
    from ..models import tracknet
    from ..render import mesh as mesh_mod
    from ..render import rasterizer as rz
    from ..train import checkpoint as ck
    from ..train import trainer as tr
    from ..utils.config import train_config_from_yaml

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="config.yml")
    parser.add_argument("--output_path", default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--synthetic", action="store_true",
                        help="train from the pair renderer on the device")
    parser.add_argument("--dr", action="store_true",
                        help="with --synthetic: composite the observed "
                             "branch over randomized valid-depth "
                             "backgrounds and occluders "
                             "(data/dataset.py::DRComposite)")
    parser.add_argument("--model_path", default=None,
                        help="mesh for --synthetic mode")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 activations (float32 parameters)")
    args = parser.parse_args(argv)
    if args.dr and not args.synthetic:
        parser.error("--dr requires --synthetic (DR compositing happens in "
                     "the pair sampler; disk datasets carry their own "
                     "backgrounds)")
    device = torch.device(args.device)

    with open(args.config) as f:
        config = yaml.safe_load(f)
    data_path = config["data_path"]
    validation_path = config["validation_path"]
    output_path = args.output_path or os.path.join(
        os.path.dirname(os.path.abspath(args.config)), "train_output")
    os.makedirs(output_path, exist_ok=True)

    info_path = os.path.join(data_path, "..", "dataset_info.yml")
    with open(info_path) as f:
        dataset_info = yaml.safe_load(f)
    shutil.copy(info_path, os.path.join(output_path, "dataset_info.yml"))
    with open(os.path.join(output_path, "config_backup.yml"), "w") as f:
        yaml.dump(config, f)

    res = int(dataset_info["resolution"])
    overrides = {"epochs": int(args.epochs)} if args.epochs else {}
    cfg = train_config_from_yaml(config, dataset_info, **overrides)

    # -- data sources --------------------------------------------------
    if args.synthetic:
        mesh = mesh_mod.load_mesh(
            args.model_path or dataset_info["models"][0]["model_path"])
        cam = Camera.from_dict(dataset_info["camera"])
        width = mesh.diameter * 1000 * (
            1 + dataset_info.get("boundingbox", 10) / 100)
        synth = SyntheticPairs(
            rz.upload(mesh, device), cam.K, resolution=res,
            object_width_mm=width, max_trans=cfg.trans_normalizer,
            max_rot_deg=float(dataset_info["max_rotation"]),
            dr=DRComposite() if args.dr else None)
        spe = int(dataset_info.get("train_samples", 200000)) // cfg.batch_size
        val_batches_n = max(1, int(dataset_info.get("val_samples", 2000))
                            // cfg.batch_size)

        def train_batches(epoch):
            for i in range(spe):
                yield synth.sample_batch(
                    tr.step_generator(device, epoch, i), cfg.batch_size)

        def val_batches(epoch):
            for i in range(val_batches_n):
                yield synth.sample_batch(
                    tr.step_generator(device, 10_000_019, i), cfg.batch_size)

        mean_src = train_batches(999)
        steps_per_epoch = spe
    else:
        train_ds = PairDataset(data_path, resolution=res)
        val_ds = PairDataset(validation_path, resolution=res)
        print(f"#train={len(train_ds)} #val={len(val_ds)}")
        steps_per_epoch = max(1, len(train_ds) // cfg.batch_size)

        def train_batches(epoch):
            return train_ds.batches(cfg.batch_size, shuffle=True, seed=epoch)

        def val_batches(epoch):
            # the epoch-tail batch is padded; eval_step masks the padding
            return val_ds.batches(cfg.batch_size, shuffle=False,
                                  drop_last=False, pad_to_batch=True)

        mean_src = train_ds.batches(cfg.batch_size, shuffle=False)

    # -- pass 1: mean/std (reference train.py:94-127) --------------------
    mean_npy = os.path.join(output_path, "mean.npy")
    if os.path.exists(mean_npy) and args.resume:
        mean = np.load(mean_npy)
        std = np.load(os.path.join(output_path, "std.npy"))
    else:
        print("Computing mean/std ...")
        mean, std = tr.compute_mean_std(mean_src, cfg, device)
        print("images_mean", mean)
        print("images_std", std)

    # -- pass 2: train ----------------------------------------------------
    model = tracknet.Se3TrackNet(
        image_size=res, dtype=torch.bfloat16 if args.bf16 else torch.float32)
    trainer = tr.Trainer(model, cfg, output_path, steps_per_epoch, mean, std,
                         device)
    if args.resume:
        last = ck.latest_checkpoint(output_path)
        if last:
            print("Resuming from", last)
            trainer.resume(last)

    print("Training Begins:")
    trainer.loop(cfg.epochs, train_batches, val_batches)
    print("Training Complete")


if __name__ == "__main__":
    main()
