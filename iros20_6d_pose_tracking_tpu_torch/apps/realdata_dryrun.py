"""One-command dry run of the whole real-data protocol chain, through the
port.

Counterpart of ``examples/realdata_dryrun.py``, plus ``--device`` (default
``cuda``; the JAX script forces its CPU backend). It drives the
docs/REALDATA.md pipeline: fixture tree -> ``predict --mode ycbv_all`` ->
``eval_ycb.eval_all`` (21-class pooling with its count assertion) ->
``predict --mode ycbineoat`` -> ``eval_ycbineoat.eval_all`` (the 5-object
substring protocol), on a synthetic YCB-style tree, and checks the outputs
against pinned expectations:

  - a zero-head checkpoint (tanh(0) = 0 delta), written by the port
    (``train/checkpoint.save_checkpoint``), makes the tracker hold its init
    pose, so every predicted pose file must equal the frame-0 gt: a binary
    end-to-end check of the CLI's crop, render, normalization, CNN, codec
    and file protocol;
  - the scorers' output must equal an AUC recomputed independently from
    the held-pose trajectory;
  - ``eval_all``'s default 14,025-keyframe assertion must fire on the
    fixture (the protocol guard guards).

    python -m iros20_6d_pose_tracking_tpu_torch.apps.realdata_dryrun \\
        [--frames 6] [--device cpu]

Exit 0: the whole real-data path is intact. A failed check raises (exit
1); a count guard that does not fire exits 1 with its message.
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil
import tempfile

import numpy as np
import torch

from ..eval import eval_ycb, eval_ycbineoat
from ..eval import metrics as ME
from ..models import tracknet
from ..render import mesh as M
from ..render import rasterizer as rz
from ..train import checkpoint as ck
from . import predict
from .make_ycb_fixture import IMG_H as H
from .make_ycb_fixture import IMG_W as W
from .make_ycb_fixture import K, render_frame, write_obj


def check(ok: bool, what) -> None:
    """Raise AssertionError unless ``ok`` (kept under ``python -O``)."""
    if not ok:
        raise AssertionError(what)


def zero_head_checkpoint(path: str) -> None:
    """The port's seeded network at 64^2 with both regression heads zeroed,
    written as the port's own training checkpoint."""
    net = tracknet.init_params(tracknet.create_model(64),
                               torch.Generator().manual_seed(0))
    with torch.no_grad():
        for head in (net.trans_out[0], net.rot_out[0]):
            head.weight.zero_()
            head.bias.zero_()
    ck.save_checkpoint(path, {"model": net.state_dict()})


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=None,
                   help="work dir (default: fresh temp dir, removed on "
                        "success)")
    p.add_argument("--frames", type=int, default=6)
    p.add_argument("--keep", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the renders, the tracker and the "
                        "scorers (cuda, or cpu for the kernels' plain "
                        "versions)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import yaml
    from PIL import Image

    dev = torch.device(args.device)
    root = args.root or tempfile.mkdtemp(prefix="realdata_dryrun_")
    os.makedirs(root, exist_ok=True)
    print(f"[dryrun] work dir: {root}")
    K_dev = torch.from_numpy(K).to(dev)
    n = args.frames
    rng = np.random.RandomState(7)

    ycb = os.path.join(root, "ycb")
    data = os.path.join(ycb, "data_organized")
    res_root = os.path.join(root, "results")
    class_names = [f"{i:03d}_obj" for i in range(1, 22)]
    # class 4 doubles as the YCBInEOAT 'mustard' object (substring
    # protocol), class 7 is a second real CLI run
    tracked = {4: M.make_icosphere(subdiv=2, radius=0.05),
               7: M.make_cube(0.08)}

    for cid, name in enumerate(class_names, start=1):
        d = os.path.join(ycb, "CADmodels", name)
        os.makedirs(d, exist_ok=True)
        pts = (tracked[cid].verts if cid in tracked
               else rng.randn(200, 3) * 0.04)
        np.savetxt(os.path.join(d, "points.xyz"), pts)
    # A separate CAD tree for the YCBInEOAT scorer: eval_ycb indexes
    # sorted(CADmodels) by class_id, so the substring-named clouds must not
    # perturb the 21-class order.
    ycb_eoat = os.path.join(root, "ycb_eoat")
    for name in ("003_cracker_box", "021_bleach_cleanser",
                 "004_sugar_box", "005_tomato_soup_can",
                 "006_mustard_bottle"):
        d = os.path.join(ycb_eoat, "CADmodels", name)
        os.makedirs(d, exist_ok=True)
        np.savetxt(os.path.join(d, "points.xyz"), tracked[4].verts)

    keyframes = []

    def write_seq(seq_id, cid, tm=None):
        seq = os.path.join(data, f"{seq_id:04d}")
        os.makedirs(os.path.join(seq, "pose_gt", str(cid)), exist_ok=True)
        mesh = rz.upload(tm, dev) if tm is not None else None
        if tm is not None:
            os.makedirs(os.path.join(seq, "color"), exist_ok=True)
            os.makedirs(os.path.join(seq, "depth_filled"), exist_ok=True)
        gts = []
        for i in range(n):
            pose = np.eye(4)
            pose[:3, 3] = [0.003 * i, -0.002 * i, 0.5 + 0.002 * i]
            np.savetxt(os.path.join(seq, "pose_gt", str(cid),
                                    f"{i + 1:06d}.txt"), pose)
            keyframes.append(f"{seq_id:04d}/{i + 1:06d}")
            if tm is not None:
                rgb, depth = render_frame(mesh, pose, K_dev, W, H)
                Image.fromarray(rgb).save(
                    os.path.join(seq, "color", f"{i + 1:06d}.png"))
                Image.fromarray(depth).save(
                    os.path.join(seq, "depth_filled", f"{i + 1:06d}.png"))
            gts.append(pose)
        return gts

    # -- artifacts the CLI reads (the reference's train-output layout) ---
    train_data = os.path.join(root, "train_data")
    os.makedirs(train_data, exist_ok=True)
    info = {
        "camera": {"focalX": 300.0, "focalY": 300.0, "centerX": 80.0,
                   "centerY": 60.0, "width": W, "height": H},
        "resolution": 64, "boundingbox": 10,
        "max_translation": 0.02, "max_rotation": 15,
        "train_samples": 8, "val_samples": 4, "models": {},
    }
    with open(os.path.join(root, "dataset_info.yml"), "w") as f:
        yaml.dump(info, f)
    np.save(os.path.join(root, "mean.npy"), np.zeros(8))
    np.save(os.path.join(root, "std.npy"), np.full(8, 100.0))
    ckpt = os.path.join(root, "zero_head.pt")
    zero_head_checkpoint(ckpt)

    # -- stage 1: real predict --mode ycbv_all runs (classes 4 and 7) ---
    gts_by_cid = {}
    for cid, seq_id in ((4, 48), (7, 49)):
        tm = tracked[cid]
        gts_by_cid[cid] = write_seq(seq_id, cid, tm)
        obj_path = os.path.join(root, f"obj{cid}.obj")
        write_obj(tm, obj_path)
        predict.main([
            "--mode", "ycbv_all", "--class_id", str(cid),
            "--ycb_dir", data,
            "--train_data_path", train_data,
            "--mean_std_path", root,
            "--ckpt_dir", ckpt,
            "--model_path", obj_path,
            "--outdir", os.path.join(res_root, class_names[cid - 1],
                                     "run0"),
            "--track_mode", "scan", "--chunk_size", "2",
            "--device", args.device,
        ])
        # pinned expectation: every predicted pose == the init gt
        pred_dir = os.path.join(res_root, class_names[cid - 1], "run0",
                                f"seq{seq_id:04d}")
        preds = sorted(f for f in glob.glob(os.path.join(pred_dir, "*.txt"))
                       if not f.endswith("gt.txt"))
        check(len(preds) == n, (len(preds), n))
        for f in preds:
            np.testing.assert_allclose(
                np.loadtxt(f), gts_by_cid[cid][0], atol=1e-4,
                err_msg=f"zero-head tracker failed to hold init: {f}")
        print(f"[dryrun] class {cid}: {n} predicted poses == init gt ✓")

    # -- stage 2: hand-written predictions for the other 19 classes ----
    for cid, name in enumerate(class_names, start=1):
        if cid in tracked:
            continue
        gts = write_seq(50, cid)
        d = os.path.join(res_root, name, "run0", "seq0050")
        os.makedirs(d, exist_ok=True)
        for i, gt in enumerate(gts):
            pred = gt.copy()
            pred[:3, 3] += rng.randn(3) * 0.002
            np.savetxt(os.path.join(d, f"{i:05d}.txt"), pred)

    os.makedirs(os.path.join(ycb, "YCB_Video_toolbox"), exist_ok=True)
    with open(os.path.join(ycb, "YCB_Video_toolbox", "keyframe.txt"),
              "w") as f:
        f.write("\n".join(keyframes) + "\n")

    # -- stage 3: the 21-class pooled scorer, protocol assertions on ---
    total = 21 * n
    out = eval_ycb.eval_all(res_root, ycb, expect_total=total,
                            device=args.device)
    check(out["n"] == total, out)
    check(np.isfinite(out["add"]) and np.isfinite(out["adi"]), out)
    # independent recomputation for the held-pose class: the scorer's
    # numbers must be a pure function of the files on disk
    gts4 = np.stack(gts_by_cid[4])
    held = np.tile(gts4[0][None], (n, 1, 1))
    add, _ = ME.batch_errors(held, gts4, tracked[4].verts,
                             device=args.device)
    exp_errs = np.sort(add)
    exp_auc = float(ME.vocap(exp_errs) * 100)
    _, add4 = eval_ycb.eval_one_class(
        os.path.join(res_root, class_names[3], "run0"), ycb, 4,
        verbose=False, device=args.device)
    np.testing.assert_allclose(add4, exp_errs, atol=1e-6)
    got = float(ME.vocap(add4) * 100)
    check(abs(got - exp_auc) < 0.05, (got, exp_auc))
    print(f"[dryrun] eval_all pooled over {total} keyframes ✓ "
          f"(class 4 ADD AUC {got:.2f} == recomputed {exp_auc:.2f})")
    # the real protocol's count guard must actually guard
    try:
        eval_ycb.eval_all(res_root, ycb, expect_total=14025,
                          device=args.device)
    except AssertionError:
        print("[dryrun] 14,025-keyframe count assertion fires ✓")
    else:
        raise SystemExit("count assertion did NOT fire — protocol guard "
                         "is broken")

    # -- stage 4: YCBInEOAT chain (5-object substring protocol) --------
    eoat = os.path.join(root, "eoat")
    res_eoat = os.path.join(root, "results_eoat")
    seq = os.path.join(data, "0048")
    vid_names = ["cracker_fix", "bleach_fix", "sugar_fix", "tomato_fix",
                 "mustard_fix"]
    for vn in vid_names:
        vd = os.path.join(eoat, vn)
        for sub in ("rgb", "depth_filled", "annotated_poses"):
            os.makedirs(os.path.join(vd, sub), exist_ok=True)
        for i in range(n):
            os.link(os.path.join(seq, "color", f"{i + 1:06d}.png"),
                    os.path.join(vd, "rgb", f"{i:06d}.png"))
            os.link(os.path.join(seq, "depth_filled", f"{i + 1:06d}.png"),
                    os.path.join(vd, "depth_filled", f"{i:06d}.png"))
            os.link(os.path.join(seq, "pose_gt", "4", f"{i + 1:06d}.txt"),
                    os.path.join(vd, "annotated_poses", f"{i:06d}.txt"))
    # one real CLI run (mustard); held-pose predictions for the rest
    predict.main([
        "--mode", "ycbineoat",
        "--YCBInEOAT_dir", os.path.join(eoat, "mustard_fix"),
        "--train_data_path", train_data,
        "--mean_std_path", root,
        "--ckpt_dir", ckpt,
        "--model_path", os.path.join(root, "obj4.obj"),
        "--outdir", os.path.join(res_eoat, "mustard_fix"),
        "--device", args.device,
    ])
    for vn in vid_names[:-1]:
        d = os.path.join(res_eoat, vn)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            np.savetxt(os.path.join(d, f"{i:05d}.txt"), gts_by_cid[4][0])
    out2 = eval_ycbineoat.eval_all(res_eoat, eoat, ycb_eoat,
                                   device=args.device)
    check(out2["overall"]["n"] == 5 * n, out2)
    # every video holds gt[0] on the same gt -> identical per-object AUC
    aucs = [out2[o]["add"] for o in eval_ycbineoat.OBJECTS]
    check(max(aucs) - min(aucs) < 0.05, aucs)
    check(abs(aucs[0] - exp_auc) < 0.05, (aucs[0], exp_auc))
    print(f"[dryrun] eval_ycbineoat 5-object protocol ✓ "
          f"(ADD AUC {aucs[0]:.2f} == recomputed {exp_auc:.2f})")

    print("[dryrun] REAL-DATA PIPELINE INTACT — swap in the real tree + "
          "a .pth.tar checkpoint per docs/REALDATA.md and the same "
          "commands produce the published tables.", flush=True)
    if not args.keep and args.root is None:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
