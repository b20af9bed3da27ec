"""What the video and on-track cells share: the inputs of a tracking run,
the choice of the frames whose poses are judged, and the judgement.

Every judged frame is one step: from the prior pose the program tracked it
from (the ground truth at a pass's first frame, else the program's own
pose of the frame before) and the frame, the reference computes the new
pose, and the program's new pose is compared with it. A drift, a wrong
carry of the pose from one frame to the next, a frame read at the wrong
index or an altered pose each changes the pose of a judged step.

The numbers compared are the medians over the judged steps, and the share
of judged steps whose gap (the larger of the two) exceeds the cell's
``over``. In a few steps of a run (0 to 12 of 258 on the card) a
silhouette pixel's centre lies within rounding of a face's edge, and the
kernel's edge test and the reference's, which round differently, disagree
on it: such a step reads 1e-5 to 4.4e-5 in float32, as much as the TF32
control's worst steps, while every other step reads under 7e-7. So no
single step is compared; the medians see a fault on most frames, and the
share one on a few frames of a run (a stale slot, a wrong render near the
border, a bad carry), provided it moves them by more than ``over``."""
from __future__ import annotations

import numpy as np
import torch

from . import check, config, counts, scene
from .reference import track as ref_track


def inputs(cfg_name: str, seed: int, device):
    """(cfg, mesh (numpy), weights, ground truth (T, 4, 4), rgb, depth)."""
    cfg0 = config.configuration(cfg_name)
    mesh = scene.make_mesh(cfg0)
    cfg = config.configuration(cfg_name, mesh["diameter_m"])
    weights = scene.make_weights(cfg, seed, device)
    gt = scene.trajectory(cfg, seed, cfg["video"]["frames"], device)
    rgb, depth = scene.make_video(cfg, seed, gt, device)
    return cfg, mesh, weights, gt, rgb, depth


def pick(seed: int, frames_per_pass: list, n: int) -> list:
    """(pass, frame) pairs to judge, drawn from the seed: the first frame
    of the first pass, the last frame tracked, and the rest uniform over
    every frame tracked."""
    total = sum(frames_per_pass)
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 7])
    flat = set(rng.choice(total, size=min(n, total), replace=False).tolist())
    flat |= {0, total - 1}
    out, base = [], 0
    for p, k in enumerate(frames_per_pass):
        out += [(p, f - base) for f in sorted(flat) if base <= f < base + k]
        base += k
    return out


def step_gaps(cfg, prog, ref) -> torch.Tensor:
    """Per judged step, the larger of the translation and rotation gaps."""
    dt, dr = check.pose_gaps(prog, ref, cfg["trans_normalizer"],
                             cfg["rot_normalizer"])
    return torch.maximum(dt, dr)


def readings(cfg, prog, ref, over: float) -> dict:
    """The judged steps' pose gaps: the medians over the steps and the
    share of steps over ``over`` (the numbers compared), and the worst."""
    dt, dr = check.pose_gaps(prog, ref, cfg["trans_normalizer"],
                             cfg["rot_normalizer"])
    worst = torch.maximum(dt, dr)
    return {"trans_gap_median": float(dt.median()),
            "rot_gap_median": float(dr.median()),
            "steps_off_share": float((worst > over).double().mean()),
            "trans_gap": float(dt.max()), "rot_gap": float(dr.max()),
            "steps": int(dt.numel())}


def numbers(read: dict, limits: dict) -> list:
    return [(k, read[k], limits[k]) for k in limits]


def bounds(cfg, mesh_t, priors, K, winners) -> tuple[float, float]:
    """Mean least time (s) of one K1 and of one pass2_shade launch over the
    renders at ``priors`` (winners: the reference's, per render)."""
    res = (cfg["resolution"],) * 2
    left, right, top, bottom = ref_track.roi_bbox(priors, K,
                                                  cfg["object_width_mm"])
    win = torch.stack([left, right, top, bottom], -1).float()
    k1 = [counts.pass1_bound_s(mesh_t, p, K, w, res, cfg["near_m"])
          for p, w in zip(priors, win)]
    p2 = [counts.pass2_bound_s(w, res) for w in winners]
    return float(np.mean(k1)), float(np.mean(p2))
