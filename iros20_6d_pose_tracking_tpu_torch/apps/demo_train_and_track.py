"""End-to-end demo: train se(3)-TrackNet on synthetic pairs rendered on the
device, then track a moving synthetic RGB-D video: the whole loop (datagen
-> train -> track -> eval) with no external data.

Counterpart of ``examples/demo_train_and_track.py``, with its flags and
defaults plus ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions). A thin CLI over ``eval/synthetic_benchmark.py``
(``train_object``, ``make_gt_trajectory``, ``render_test_video``,
``evaluate_tracking``).

    python -m iros20_6d_pose_tracking_tpu_torch.apps.demo_train_and_track \\
        [--steps N] [--frames T] [--hard]

Prints the metrics and ``DEMO clean|hard PASS|FAIL`` (tracked mean ADD
under 0.25, hard 0.35, of the hold-init mean), writes the per-frame ADD to
``<outdir>/add_per_frame.txt`` and exits 0 on PASS, 1 on FAIL.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.dataset import DRComposite
from ..eval import synthetic_benchmark as SB


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=None,
                        help="default 2500 (clean) / 5000 (--hard)")
    parser.add_argument("--batch", type=int, default=None,
                        help="default 32 (clean) / 200 (--hard): hard "
                             "mode needs ~1M DR pairs to converge")
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--outdir", default="demo_out_torch")
    parser.add_argument("--hard", action="store_true",
                        help="hard-mode test video: textured valid-depth "
                             "background, a moving partial occluder, depth "
                             "dropout, and DR-composited training "
                             "(data/dataset.py::DRComposite)")
    parser.add_argument("--object", default="cube",
                        help="any eval/synthetic_benchmark.py OBJECTS "
                             "name (cube, box, lshape, icosahedron, "
                             "cylinder, sphere, plate, textured_box)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda, or cpu for the kernels' "
                             "plain versions)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    steps = args.steps if args.steps is not None else (
        5000 if args.hard else 2500)
    batch = args.batch if args.batch is not None else (
        200 if args.hard else 32)

    # Default: a face-coloured cube, whose rotation shows in RGB and in
    # depth (a sphere's rotation is invisible in depth and drifts).
    obj = SB.train_object(
        SB.OBJECTS[args.object](), name=args.object, steps=steps,
        batch=batch, dr=DRComposite() if args.hard else None,
        aug=SB.hard_aug() if args.hard else None, device=args.device)
    gt = SB.make_gt_trajectory(args.frames)
    frames_rgb, frames_depth = SB.render_test_video(obj.mesh, gt,
                                                    hard=args.hard)
    # The JAX demo tracks the float frames as rendered (no quantization).
    r = SB.evaluate_tracking(obj, gt, frames_rgb.cpu().numpy(),
                             frames_depth.cpu().numpy())

    np.savetxt(os.path.join(args.outdir, "add_per_frame.txt"), r["add"])
    print(f"\ntracked   ADD: mean={r['add_mean_mm']:.2f}mm "
          f"max={r['add_max_mm']:.2f}mm AUC={r['add_auc']:.2f}")
    print(f"hold-init ADD: mean={r['baseline_add_mean_mm']:.2f}mm "
          f"AUC={r['baseline_add_auc']:.2f}")
    print(f"final-frame translation err: {r['final_trans_err_mm']:.2f}mm")
    # Hard mode allows more absolute error (partial occlusion, sensor
    # holes) but must still track far better than holding the init pose.
    ratio = 0.35 if args.hard else 0.25
    ok = r["add_mean_mm"] < ratio * r["baseline_add_mean_mm"]
    print("DEMO", "hard" if args.hard else "clean", "PASS" if ok else "FAIL",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
