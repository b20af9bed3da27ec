"""YCBInEOAT benchmark scorer (CLI-compatible with reference
eval_ycbineoat.py:49-122).

Counterpart of ``iros20_6d_pose_tracking_tpu/eval/eval_ycbineoat.py``, on
the port's metrics (``eval/metrics.py``, on the card unless ``--device cpu``
asks for the CPU).

Protocol preserved:
  - 5 objects matched by substring in the result folder name
    ('cracker', 'bleach', 'sugar', 'tomato', 'mustard');
  - EVERY frame scored (not keyframes);
  - gt from ``<data_dir>/<video>/annotated_poses/*.txt`` with a
    pred/gt file-count assertion (reference eval_ycbineoat.py:86);
  - per-object and pooled ADD / ADD-S VOCap x100.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from .metrics import batch_errors, load_points_xyz, vocap

OBJECTS = ("cracker", "bleach", "sugar", "tomato", "mustard")


def _load_models(ycb_dir: str) -> dict[str, np.ndarray]:
    models = {}
    for path in glob.glob(os.path.join(ycb_dir, "CADmodels", "*", "points.xyz")):
        for obj in OBJECTS:
            if obj in path:
                models[obj] = load_points_xyz(path)
    return models


def eval_all(res_dir: str, ycbineoat_dir: str, ycb_dir: str,
             device="cuda"):
    """Score every result folder of the five objects on ``device``."""
    models = _load_models(ycb_dir)
    per_obj = {o: {"add": [], "add-s": []} for o in OBJECTS}

    for folder in sorted(os.listdir(res_dir)):
        if ".tar.gz" in folder:
            continue
        obj = next((o for o in OBJECTS if o in folder), None)
        if obj is None:
            continue
        pred_files = sorted(glob.glob(os.path.join(res_dir, folder, "*.txt")))
        gt_files = sorted(
            glob.glob(os.path.join(ycbineoat_dir, folder, "annotated_poses",
                                   "*.txt"))
        )
        assert len(pred_files) == len(gt_files), (
            f"{folder}: {len(pred_files)} preds vs {len(gt_files)} gts"
        )
        preds = np.stack([np.loadtxt(p) for p in pred_files])
        gts = np.stack([np.loadtxt(g) for g in gt_files])
        add, adi = batch_errors(preds, gts, models[obj], device=device)
        per_obj[obj]["add"].extend(add)
        per_obj[obj]["add-s"].extend(adi)

    adds, adis = [], []
    results = {}
    for obj, res in per_obj.items():
        if not res["add"]:
            continue
        add_auc = vocap(res["add"]) * 100
        adi_auc = vocap(res["add-s"]) * 100
        adds.extend(res["add"])
        adis.extend(res["add-s"])
        results[obj] = {"add": add_auc, "adi": adi_auc}
        print(f"{obj}: adi={adi_auc} add={add_auc}")

    overall_add = vocap(adds) * 100
    overall_adi = vocap(adis) * 100
    print("Total pose:", len(adis))
    print(f"\nOverall, adi={overall_adi} add={overall_add}")
    results["overall"] = {"add": overall_add, "adi": overall_adi,
                          "n": len(adis)}
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--YCBInEOAT_dir", required=True)
    parser.add_argument("--ycb_dir", required=True)
    parser.add_argument("--res_dir", required=True)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the error computation")
    args = parser.parse_args(argv)
    eval_all(args.res_dir, args.YCBInEOAT_dir, args.ycb_dir,
             device=args.device)


if __name__ == "__main__":
    main()
