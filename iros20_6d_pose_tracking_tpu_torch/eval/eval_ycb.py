"""YCB-Video benchmark scorer (CLI-compatible with reference eval_ycb.py).

Counterpart of ``iros20_6d_pose_tracking_tpu/eval/eval_ycb.py``, on the
port's metrics (``eval/metrics.py``); the file protocol is the same.

File protocol preserved exactly (reference eval_ycb.py:67-162):
  - predictions: ``<res_dir>/**/<frame>.txt`` 4x4 poses, sequence id from
    a ``seqNNNN``-style folder component, frame id = filename stem + 1;
  - scored on KEYFRAMES only, from
    ``<ycb_dir>/YCB_Video_toolbox/keyframe.txt``;
  - ground truth at
    ``<ycb_dir>/data_organized/%04d/pose_gt/<class_id>/%06d.txt``;
  - models from ``<ycb_dir>/CADmodels/<class_name>/points.xyz``;
  - per-class ADD/ADI VOCap x100, then pooled over 21 classes with the
    14025-keyframe total assertion (reference eval_ycb.py:154).

Error computation runs batched (eval/metrics.py, on the card unless
``--device cpu`` asks for the CPU) instead of a per-frame cKDTree loop.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from .metrics import batch_errors, load_points_xyz, vocap


def _load_keyframes(ycb_dir: str) -> set[str]:
    with open(os.path.join(ycb_dir, "YCB_Video_toolbox", "keyframe.txt")) as f:
        return {line.strip() for line in f if line.strip()}


def eval_one_class(res_dir: str, ycb_dir: str, class_id: int,
                   verbose: bool = True, device="cuda"):
    """Score one class on ``device``; returns (adi_errs, add_errs) sorted
    ascending (reference eval_ycb.py:67-119)."""
    pose_files = sorted(glob.glob(os.path.join(res_dir, "**", "*.txt"),
                                  recursive=True))
    assert len(pose_files) > 0, f"no predictions under {res_dir}"

    model_files = sorted(
        glob.glob(os.path.join(ycb_dir, "CADmodels", "**", "points.xyz"),
                  recursive=True)
    )
    points = load_points_xyz(model_files[class_id - 1])
    keyframes = _load_keyframes(ycb_dir)

    preds, gts = [], []
    for pose_file in pose_files:
        rel = os.path.relpath(pose_file, res_dir)
        seq_part = rel.split(os.sep)[0].replace("seq", "")
        stem = os.path.basename(pose_file).split(".")[0]
        if not (seq_part.isdigit() and stem.isdigit()):
            continue  # e.g. the %05dgt.txt ground-truth copies predict writes
        seq_id = int(seq_part)
        frame_id = int(stem) + 1
        if f"{seq_id:04d}/{frame_id:06d}" not in keyframes:
            continue
        gt_file = os.path.join(
            ycb_dir, "data_organized", f"{seq_id:04d}", "pose_gt",
            str(class_id), f"{frame_id:06d}.txt",
        )
        preds.append(np.loadtxt(pose_file))
        gts.append(np.loadtxt(gt_file))

    assert len(preds) > 0, "no keyframe predictions matched"
    add_errs, adi_errs = batch_errors(np.stack(preds), np.stack(gts), points,
                                      device=device)
    add_errs = np.sort(add_errs)
    adi_errs = np.sort(adi_errs)
    if verbose:
        class_names = sorted(os.listdir(os.path.join(ycb_dir, "CADmodels")))
        print(f">>> class {class_id} ({class_names[class_id - 1]})")
        print("add:", vocap(add_errs) * 100)
        print("adi:", vocap(adi_errs) * 100)
    return adi_errs, add_errs


def eval_all(root: str, ycb_dir: str, expect_total: int | None = 14025,
             device="cuda"):
    """All 21 classes on ``device``; result folders laid out one-per-class
    under ``root`` (reference eval_ycb.py:121-162)."""
    class_folders = sorted(os.listdir(root))
    res_dirs = []
    for cf in class_folders:
        sub = os.path.join(root, cf)
        for folder in sorted(os.listdir(sub)):
            cand = os.path.join(sub, folder)
            if os.path.isdir(cand):
                res_dirs.append(cand)
                break
    class_ids = np.arange(1, 22)
    assert len(res_dirs) == len(class_ids), f"{len(res_dirs)} result dirs"

    adi_all, add_all = [], []
    for class_id, res_dir in zip(class_ids, res_dirs):
        adi, add = eval_one_class(res_dir, ycb_dir, int(class_id),
                                  device=device)
        adi_all.extend(adi)
        add_all.extend(add)

    n = len(adi_all)
    if expect_total is not None:
        assert n == expect_total, f"scored {n} keyframes, expected {expect_total}"
    add_auc = vocap(np.array(add_all)) * 100
    adi_auc = vocap(np.array(adi_all)) * 100
    print()
    print("add:", add_auc)
    print("adi:", adi_auc)
    print("Total res num:", n)
    return {"add": add_auc, "adi": adi_auc, "n": n}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ycb_dir", required=True)
    parser.add_argument("--class_id", type=int, default=None,
                        help="score a single class from --res_dir")
    parser.add_argument("--res_dir", type=str, default=None)
    parser.add_argument("--root", type=str, default=None,
                        help="per-class results root for eval_all")
    parser.add_argument("--no_total_check", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the error computation")
    args = parser.parse_args(argv)

    if args.class_id is not None and args.res_dir is not None:
        eval_one_class(args.res_dir, args.ycb_dir, args.class_id,
                       device=args.device)
    else:
        eval_all(args.root, args.ycb_dir,
                 None if args.no_total_check else 14025, device=args.device)


if __name__ == "__main__":
    main()
