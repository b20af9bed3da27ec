"""Synthetic data generation CLI, in PyTorch: flag-compatible with the JAX
package's ``apps/datagen.py``, plus ``--device`` (default ``cuda``; ``cpu``
runs the kernels' plain versions).

Two modes, the reference's two-stage pipeline (reference blender_main.py +
produce_train_pair_data.py):

  --mode dr        domain-randomized scenes rendered by the port's rasterizer
                   (full-frame layers through K3) -> perturbation pairs (A
                   rendered through K1) -> the reference's train/val folder
                   layout; no Blender.
  --mode blender   consume an existing Blender ``generated_data/`` folder
                   (the reference's stage 1 output, or
                   ``datagen/blender_gen.py``'s) and produce pairs, as
                   produce_train_pair_data.py completeBlender does.

    python -m iros20_6d_pose_tracking_tpu_torch.apps.datagen --device cpu \\
        --dataset_info dataset_info.yml --out_root out --train_samples 8

PyYAML and Pillow are imported when a file is read or written.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    import yaml

    from ..core.camera import Camera
    from ..datagen import pair_producer as pp
    from ..render import mesh as mesh_mod
    from ..render import rasterizer as rz

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--mode", choices=["dr", "blender"], default="dr")
    parser.add_argument("--dataset_info", required=True)
    parser.add_argument("--out_root", required=True)
    parser.add_argument("--generated_dir", default=None,
                        help="Blender stage-1 output (--mode blender)")
    parser.add_argument("--model_path", default=None)
    parser.add_argument("--train_samples", type=int, default=None)
    parser.add_argument("--val_samples", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the renders (cuda, or cpu for "
                             "the kernels' plain versions)")
    args = parser.parse_args(argv)

    with open(args.dataset_info) as f:
        dataset_info = yaml.safe_load(f)
    model_path = args.model_path or dataset_info["models"][0]["model_path"]
    tm = mesh_mod.load_mesh(model_path)
    mesh = rz.upload(tm, args.device)

    if "object_width" not in dataset_info:
        width = mesh_mod.compute_obj_max_width(tm.verts)
        pad = dataset_info.get("boundingbox", 0)
        dataset_info["object_width"] = float(width * (1 + pad / 100.0))
        print("object_width =", dataset_info["object_width"])
        os.makedirs(args.out_root, exist_ok=True)
        with open(os.path.join(args.out_root, "dataset_info.yml"), "w") as f:
            yaml.dump(dataset_info, f)

    if args.mode == "blender":
        if not args.generated_dir:
            parser.error("--mode blender needs --generated_dir")
        train_dir, val_dir = pp.complete_blender(
            args.generated_dir, args.out_root, dataset_info, mesh=mesh,
            seed=args.seed)
    else:
        cam = Camera.from_dict(dataset_info["camera"])
        cfg = pp.ProducerConfig(
            resolution=int(dataset_info["resolution"]),
            object_width_mm=float(dataset_info["object_width"]),
            max_translation=float(dataset_info["max_translation"]),
            max_rotation_deg=float(dataset_info["max_rotation"]),
            width=cam.width, height=cam.height,
        )
        blender_cfg = dataset_info.get("blender", {})
        xyz_range = (
            tuple(blender_cfg.get("range_x", (-0.2, 0.2))),
            tuple(blender_cfg.get("range_y", (-0.15, 0.15))),
            tuple(blender_cfg.get("range_z", (0.4, 0.9))),
        )
        stats = {}
        train_dir, val_dir = pp.produce_dataset(
            mesh, cam.K, args.out_root, cfg,
            train_samples=(args.train_samples
                           or int(dataset_info["train_samples"])),
            val_samples=(args.val_samples
                         or int(dataset_info["val_samples"])),
            xyz_range=xyz_range, seed=args.seed, stats=stats)
        print(f"dr: {stats['scenes']} scenes, {stats['layers']} layers, "
              f"{stats['pairs']} pairs")
    print("train pairs:", train_dir)
    print("val pairs:", val_dir)


if __name__ == "__main__":
    main()
