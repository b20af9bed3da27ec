#!/usr/bin/env python3
"""The cube's severity sweep over training seeds and initialization draws,
on one CUDA card: how much of the sweep's x3 and x4 ADD AUC is the one
noisy initialization each severity draws (ROADMAP F17).

    python3 accuracy_f17.py [--seeds 0,1,2] [--out accuracy_f17_torch_h100.json]

For each training seed k the cube trains as the accuracy suite trains it
(``eval/synthetic_benchmark.train_object``: 5,000 steps at batch 200,
176^2, the DR composite and the hard augmentation, float32 with TF32 off,
``seed_offset=k``; k = 0 is the suite's own seed). Then, for each severity
s of 2, 3 and 4, the 120-frame hard video of the cube is rendered under the
sensor model's lighting at s and shifted by it (noise seed 2000 + 100 s, as
the suite's sweep), and ``evaluate_tracking`` tracks it from six noisy
initializations of the scaled size:

  - ``jax``: JAX's own draw of the suite's sweep, ``PRNGKey(700 + 100 s)``,
    read from ``tests/data/jax_sweep_init_draws.json`` (this machine needs
    no JAX);
  - ``port``: the port's draw of the suite's sweep, a CPU generator seeded
    700 + 100 s;
  - ``port_j1`` .. ``port_j4``: the port's draws seeded 700 + 100 s +
    10000 j.

Every row (seed, severity, init, ADD and ADD-S AUC, ADD mean, final
translation error) goes to ``--out`` after each seed, with the card's name
and power limit and JAX's record of the sweep
(``benchmarks/accuracy_suite_results.json``). The last lines print the x3
rows' spread and the verdict of the rule in PERF.md: the spread is the
initialization draw's if the seed-0 net from JAX's x3 draw reads within
RULE_AUC of JAX's x3, or if JAX's x3 lies within the port's x3 range.

``--steps``, ``--batch``, ``--frames`` and ``--device cpu`` rehearse the
script at a toy size.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from iros20_6d_pose_tracking_tpu_torch.data.dataset import DRComposite
from iros20_6d_pose_tracking_tpu_torch.eval import domain_shift as DS
from iros20_6d_pose_tracking_tpu_torch.eval import synthetic_benchmark as SB

ROOT = os.path.dirname(os.path.abspath(__file__))
JAX_DRAWS = os.path.join(ROOT, "tests", "data", "jax_sweep_init_draws.json")
JAX_RECORD = os.path.join(ROOT, "benchmarks", "accuracy_suite_results.json")
SEVERITIES = (2.0, 3.0, 4.0)
EXTRA_DRAWS = 4
RULE_AUC = 7.0
KEYS = ("add_auc", "adi_auc", "add_mean_mm", "final_trans_err_mm")


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def jax_inits(gt0: np.ndarray) -> dict:
    """Severity -> JAX's init pose of the sweep, rebuilt by the port's
    ``noisy_init_pose`` from JAX's saved draws and held to JAX's saved pose
    (1e-6)."""
    with open(JAX_DRAWS) as f:
        saved = json.load(f)
    if not np.array_equal(np.asarray(saved["gt0"], np.float32), gt0):
        raise ValueError("the saved draws were made at another gt[0]")
    out = {}
    for s in SEVERITIES:
        row = saved["severities"][str(s)]
        draws = {name: {k: torch.tensor(v, dtype=torch.float32)
                        for k, v in row[name].items()}
                 for name in ("dir_t", "dir_r")}
        pose = DS.noisy_init_pose(draws, gt0,
                                  DS.SensorModel().scaled(s)).numpy()
        gap = float(np.abs(pose - np.asarray(row["init_pose"])).max())
        if gap > 1e-6:
            raise AssertionError(f"x{s}: JAX's init pose rebuilt {gap} off")
        out[s] = (row["key"], pose)
    return out


def jax_record() -> dict:
    """Severity -> JAX's sweep row of the cube in the repo's record."""
    with open(JAX_RECORD) as f:
        rec = json.load(f)
    cube = next(r for r in rec["results"] if r["name"] == "cube")
    return {float(r["severity"]): r for r in cube["shift_sweep"]}


def sweep_rows(obj, gt, seed: int, device) -> list[dict]:
    """The rows of one trained net: each severity's shifted video from the
    six initializations."""
    gt0 = gt[0]
    inits_jax = jax_inits(gt0)
    rows = []
    for s in SEVERITIES:
        sm = DS.SensorModel().scaled(s)
        sd = int(s * 100)  # the suite's sweep seed of the cube (index 0)
        rgb, dep = SB.render_test_video(obj.mesh, gt, K=SB.YCB_K, hard=True,
                                        lighting=sm.lighting(device))
        rgb_s, dep_s = SB._quantize(*DS.shift_video(rgb, dep, gt, SB.YCB_K,
                                                    sm, seed=2000 + sd))
        key, pose = inits_jax[s]
        inits = [("jax", key, pose), ("port", 700 + sd,
                                      SB._init_pose_np(700 + sd, gt0, sm))]
        inits += [(f"port_j{j}", 700 + sd + 10000 * j,
                   SB._init_pose_np(700 + sd + 10000 * j, gt0, sm))
                  for j in range(1, EXTRA_DRAWS + 1)]
        for name, init_seed, init in inits:
            r = SB.evaluate_tracking(obj, gt, rgb_s, dep_s, K=SB.YCB_K,
                                     init_pose=init)
            row = {"seed": seed, "severity": s, "init": name,
                   "init_seed": int(init_seed),
                   **{k: float(r[k]) for k in KEYS}}
            rows.append(row)
            print(f"seed {seed} x{s} init {name} ({init_seed}): ADD AUC "
                  f"{row['add_auc']:.2f} ADD-S {row['adi_auc']:.2f} mean "
                  f"{row['add_mean_mm']:.1f} mm final "
                  f"{row['final_trans_err_mm']:.1f} mm", flush=True)
    return rows


def verdict(rows: list[dict], record: dict) -> dict:
    """The x3 spread and the rule's verdict (module docstring)."""
    x3 = [r for r in rows if r["severity"] == 3.0]
    ref = float(record[3.0]["add_auc"])
    k0 = [r["add_auc"] for r in x3 if r["seed"] == 0 and r["init"] == "jax"]
    lo, hi = min(r["add_auc"] for r in x3), max(r["add_auc"] for r in x3)
    near = bool(k0) and abs(k0[0] - ref) <= RULE_AUC
    inside = lo <= ref <= hi
    return {"jax_x3_add_auc": ref, "seed0_jax_draw_x3_add_auc":
            k0[0] if k0 else None, "port_x3_add_auc_min": lo,
            "port_x3_add_auc_max": hi, "rule_auc": RULE_AUC,
            "seed0_jax_draw_within_rule": near, "jax_x3_inside_port_range":
            inside, "draw_dependence": near or inside}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--steps", type=int, default=5_000)
    p.add_argument("--batch", type=int, default=200)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="accuracy_f17_torch_h100.json")
    a = p.parse_args(argv)
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to rehearse")
    card = card_line(a.device)
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    gt = SB.make_gt_trajectory(a.frames)
    record = jax_record()
    out = {"card": card, "torch": torch.__version__,
           "recipe": {"object": "cube", "steps": a.steps, "batch": a.batch,
                      "res": 176, "frames": a.frames, "hard": True,
                      "severities": list(SEVERITIES),
                      "video_seed": "2000 + 100 s",
                      "port_init_seeds": "700 + 100 s + 10000 j, j = 0..4",
                      "jax_init_keys": "PRNGKey(700 + 100 s)"},
           "jax_record": {str(s): {k: record[s][k] for k in KEYS}
                          for s in SEVERITIES},
           "train": [], "rows": []}
    t0 = time.time()
    for k in (int(x) for x in a.seeds.split(",")):
        obj = SB.train_object(
            SB.OBJECTS["cube"](), SB.YCB_K, name=f"cube_seed{k}",
            steps=a.steps, batch=a.batch, res=176, dr=DRComposite(),
            aug=SB.hard_aug(), seed_offset=k, device=a.device)
        out["train"].append({"seed": k, "train_secs": obj.train_secs,
                             "last_loss": obj.losses[-1]})
        out["rows"] += sweep_rows(obj, gt, k, a.device)
        out["summary"] = verdict(out["rows"], record)
        out["wall_secs"] = time.time() - t0
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
        del obj
    print(f"x3 summary ({card}): {json.dumps(out['summary'])}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
