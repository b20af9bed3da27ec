"""Generate a tiny synthetic YCB-style tree for driving the predict CLI
without any real dataset.

Counterpart of ``examples/make_ycb_fixture.py``: the same icosphere video
(K, 160x120 frames, poses), rendered by the port's rasterizer (full frames
through the work-list pass 1, K3, as the port's other full-frame renders),
written as the tree ``apps/predict.py --mode ycbv`` reads:

  <root>/0048/color/%06d.png          uint8 RGB
  <root>/0048/depth_filled/%06d.png   uint16 mm
  <root>/0048/pose_gt/<class>/%06d.txt
  <root>/object.obj                   CAD model
  <root>/dataset_info.yml             camera/normalizers/resolution
  <root>/mean.npy, std.npy            normalization stats
  <root>/train_data/                  (dataset_info discovery dir)

Usage:
    python -m iros20_6d_pose_tracking_tpu_torch.apps.make_ycb_fixture \\
      --root /tmp/ycbfix [--frames 8] [--device cpu]
    python -m iros20_6d_pose_tracking_tpu_torch.apps.predict --mode ycbv \\
      --seq_id 48 --class_id 4 --ycb_dir /tmp/ycbfix \\
      --train_data_path /tmp/ycbfix/train_data --mean_std_path /tmp/ycbfix \\
      --model_path /tmp/ycbfix/object.obj --outdir /tmp/out/seq0048

PyYAML and Pillow are imported by ``main``, not with the module.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core import se3
from ..render import mesh as M
from ..render import rasterizer as rz

# The fixture's camera and frame size (the JAX script's).
K = np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1.0]], np.float32)
IMG_W, IMG_H = 160, 120


def write_obj(tm, path: str) -> None:
    """The mesh's vertices and real faces as a Wavefront OBJ."""
    with open(path, "w") as f:
        for v in tm.verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for fc in tm.faces[: tm.num_faces]:
            f.write(f"f {fc[0] + 1} {fc[1] + 1} {fc[2] + 1}\n")


def render_frame(mesh, pose: np.ndarray, K_dev, width: int, height: int):
    """Full-frame render at ``pose`` through K3: (uint8 RGB, uint16 depth)
    host arrays, each value cast as the JAX script casts it."""
    rgb, depth = rz.render(
        mesh, torch.as_tensor(pose, dtype=torch.float32).to(K_dev.device),
        K_dev, rz.full_frame_window(width, height), out_hw=(height, width),
        worklist=True)
    return (rgb.cpu().numpy().astype(np.uint8),
            depth.cpu().numpy().astype(np.uint16))


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default="/tmp/ycbfix")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--class_id", type=int, default=4)
    p.add_argument("--seq_id", type=int, default=48)
    p.add_argument("--res", type=int, default=64,
                   help="network crop resolution written to dataset_info")
    p.add_argument("--device", default="cuda",
                   help="torch device of the renders (cuda, or cpu for the "
                        "kernels' plain versions)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import yaml
    from PIL import Image

    dev = torch.device(args.device)
    root = args.root
    seq = os.path.join(root, f"{args.seq_id:04d}")
    for d in ("color", "depth_filled", f"pose_gt/{args.class_id}"):
        os.makedirs(os.path.join(seq, d), exist_ok=True)

    tm = M.make_icosphere(subdiv=2, radius=0.05)
    write_obj(tm, os.path.join(root, "object.obj"))

    mesh = rz.upload(tm, dev)
    K_dev = torch.from_numpy(K).to(dev)
    for i in range(args.frames):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.004 * i, -0.002 * i, 0.5 + 0.002 * i]
        pose[:3, :3] = se3.so3_exp(
            torch.tensor([0.0, 0.03 * i, 0.0])).numpy()
        rgb, depth = render_frame(mesh, pose, K_dev, IMG_W, IMG_H)
        Image.fromarray(rgb).save(os.path.join(seq, "color", f"{i:06d}.png"))
        Image.fromarray(depth).save(
            os.path.join(seq, "depth_filled", f"{i:06d}.png"))
        np.savetxt(os.path.join(seq, "pose_gt", str(args.class_id),
                                f"{i:06d}.txt"), pose)

    os.makedirs(os.path.join(root, "train_data"), exist_ok=True)
    info = {
        "camera": {"focalX": 300.0, "focalY": 300.0, "centerX": 80.0,
                   "centerY": 60.0, "width": IMG_W, "height": IMG_H},
        "resolution": args.res, "boundingbox": 10,
        "max_translation": 0.02, "max_rotation": 15,
        "train_samples": 8, "val_samples": 4,
        "models": {0: {"model_path": os.path.join(root, "object.obj")}},
    }
    with open(os.path.join(root, "dataset_info.yml"), "w") as f:
        yaml.dump(info, f)
    np.save(os.path.join(root, "mean.npy"), np.zeros(8))
    np.save(os.path.join(root, "std.npy"), np.full(8, 100.0))
    print(f"fixture ready: {root} ({args.frames} frames, "
          f"class {args.class_id}, seq {args.seq_id:04d})")


if __name__ == "__main__":
    main()
