"""Multi-hypothesis tracking and track-health scoring, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/tracking/hypotheses.py``. The
reference scaffolds a ``samples`` parameter but only ever evaluates
hypothesis 0 (reference predict.py:229-231,293-296); here, as in the JAX
package, the N hypotheses are refined and scored:

  - :func:`track_step_multi`: the prior and N - 1 perturbations of it go
    through one batched tracking step (``tracker.track_step`` over (N, 4, 4)
    poses: one culled N-view render, the CNN at batch N), then one batched
    :func:`depth_agreement` at the scoring resolution picks the winner. A
    frame makes two K1 and two ``pass2_shade`` launches, whatever N is (JAX
    runs the same two renders per hypothesis under ``vmap``).
  - :func:`depth_agreement`: the soft share of rendered pixels whose
    observed depth agrees within a tolerance, the per-frame track-health
    score; :class:`ReinitPolicy` turns a run of low scores into a re-init.

Random draws come from an explicit ``torch.Generator`` (ROADMAP F7): torch
cannot replay ``jax.random``, so the tests hand both packages the same
perturbations. :func:`track_video_multi` seeds one generator per frame with
the frame's index, as ``Tracker.on_track`` seeds with ``frame_cnt``, so the
video and the per-frame modes draw the same hypotheses (the JAX scan splits
one key stream instead: ROADMAP F8).
"""
from __future__ import annotations

import torch

from ..core import se3
from ..ops import roi as roi_ops
from ..render import rasterizer as rz
from . import tracker as trk


@torch.no_grad()
def depth_agreement(mesh: rz.MeshArrays, pose, K, frame_depth_mm,
                    cfg: trk.TrackerConfig, tol_mm: float = 20.0,
                    frame_offset_vu=None, score_res: int | None = None):
    """Render-vs-observed depth consistency in the pose's ROI.

    Returns a score in [0, 1] (a 0-d tensor, or (N,) for N poses (N, 4, 4),
    rendered as one culled batch): over pixels where the render says the
    object is, the soft share (1 at zero depth error, 0 at ``tol_mm``) whose
    observed depth agrees. Occluded pixels (observed nearer than rendered by
    more than ``tol_mm``) leave the denominator, but only up to 75% of the
    silhouette; 16 or fewer silhouette pixels score 0.
    ``frame_offset_vu``: (row, col) of the frame's origin in full-image
    coordinates when only a window of it was uploaded. ``score_res``: ROI
    resolution of the scoring render and crop (default ``cfg.resolution``).
    """
    r = int(score_res or cfg.resolution)
    res = (r, r)
    bbox = roi_ops.compute_bbox(pose, K, cfg.object_width_mm,
                                (1000.0, 1000.0, 1000.0))
    bbox_local = bbox if frame_offset_vu is None else (
        bbox - frame_offset_vu.to(torch.int32))
    _, depth_r = rz.render(mesh, pose, K, rz.window_from_bbox(bbox),
                           out_hw=res, near=cfg.near, far=cfg.far,
                           cull_backfaces=cfg.cull_backfaces)
    left, right, top, bottom = roi_ops.bbox_window(bbox_local)
    depth_o = roi_ops.crop_resize_nearest(
        frame_depth_mm, top, left, bottom - top, right - left, res).to(
            torch.float32)
    rendered = depth_r > 0
    observed = depth_o > 100.0
    sil = rendered & observed  # silhouette pixels with a valid observation
    occluded = sil & (depth_o < depth_r - tol_mm)
    denom_mask = sil & ~occluded
    w = torch.clamp(1.0 - torch.abs(depth_r - depth_o) / tol_mm, 0.0, 1.0)

    def total(x):
        return x.to(torch.float32).sum(dim=(-2, -1))

    n_sil = total(sil)
    denom = torch.maximum(total(denom_mask), 0.25 * n_sil)
    score = torch.where(denom_mask, w, 0.0).sum(dim=(-2, -1)) / torch.clamp(
        denom, min=1.0)
    return torch.where(n_sil > 16.0, score, 0.0)


def scoring_resolution(cfg: trk.TrackerConfig) -> int:
    """Half the tracking resolution, floored at 88 px (and never above it):
    the pixel-share score only shifts at silhouette edges, and the scoring
    render costs about a quarter."""
    return min(cfg.resolution, max(88, cfg.resolution // 2))


@torch.no_grad()
def track_step_multi(model, cfg: trk.TrackerConfig, mesh: rz.MeshArrays, K,
                     mean, std, prev_pose, frame_rgb, frame_depth_mm,
                     generator: torch.Generator | None = None,
                     samples: int = 4, perturb_trans: float = 0.01,
                     perturb_rot_deg: float = 5.0, frame_offset_vu=None,
                     perturb=None):
    """Multi-hypothesis update: hypothesis 0 is ``prev_pose``, the other
    ``samples - 1`` are ``prev_pose @ perturb``; all N are refined in one
    batched step and scored in one batched :func:`depth_agreement` at
    :func:`scoring_resolution`, and the best score wins (the first on
    ties).

    ``perturb``: (N - 1, 4, 4) perturbation poses; by default drawn from
    ``generator`` (``se3.draw_gaussian_magnitude`` and
    ``apply_gaussian_magnitude``: a direction and a truncated-normal
    magnitude of at most ``perturb_trans`` m and ``perturb_rot_deg``
    degrees). Returns (pose (4, 4), score, {"scores": (N,), "poses": (N, 4,
    4)}), all on the device.
    """
    if samples > 1:
        if perturb is None:
            draws = se3.draw_gaussian_magnitude(generator, (samples - 1,),
                                                prev_pose.device)
            perturb = se3.apply_gaussian_magnitude(draws, perturb_trans,
                                                   perturb_rot_deg)
        hypo = torch.cat([prev_pose[None], prev_pose[None] @ perturb])
    else:
        hypo = prev_pose[None]
    new_poses, _ = trk.track_step(model, cfg, mesh, K, mean, std, hypo,
                                  frame_rgb, frame_depth_mm,
                                  frame_offset_vu=frame_offset_vu)
    scores = depth_agreement(mesh, new_poses, K, frame_depth_mm, cfg,
                             frame_offset_vu=frame_offset_vu,
                             score_res=scoring_resolution(cfg))
    # index_select keeps the pick on the device: indexing with a 0-d
    # tensor would read it to the host (an .item()) and wait for the step.
    best = torch.argmax(scores).reshape(1)
    return (new_poses.index_select(0, best)[0],
            scores.index_select(0, best)[0],
            {"scores": scores, "poses": new_poses})


@torch.no_grad()
def track_video_multi(model, cfg: trk.TrackerConfig, mesh: rz.MeshArrays, K,
                      mean, std, init_pose, frames_rgb, frames_depth_mm,
                      samples: int = 4, first_frame: int = 0):
    """Multi-hypothesis tracking over preloaded frames ((T, H, W, 3), (T, H,
    W) on the device), carrying the winner on the device. Frame i draws its
    perturbations from a generator on the device seeded with ``first_frame
    + i``, the seed ``Tracker.on_track`` gives it. Returns (poses (T, 4, 4),
    health scores (T,))."""
    T = frames_rgb.shape[0]
    dev = init_pose.device
    poses = torch.empty((T, 4, 4), dtype=torch.float32, device=dev)
    scores = torch.empty((T,), dtype=torch.float32, device=dev)
    pose = init_pose
    for i in range(T):
        gen = torch.Generator(dev).manual_seed(first_frame + i)
        pose, scores[i], _ = track_step_multi(
            model, cfg, mesh, K, mean, std, pose, frames_rgb[i],
            frames_depth_mm[i], gen, samples=samples)
        poses[i] = pose
    return poses, scores


class ReinitPolicy:
    """Automatic drift handling: when health drops below ``threshold`` for
    ``patience`` consecutive frames, report tracking lost so the caller can
    re-initialize (the reference's only recovery is manual
    --reinit_frames, predict.py:539-541)."""

    def __init__(self, threshold: float = 0.3, patience: int = 3):
        self.threshold = threshold
        self.patience = patience
        self.bad_streak = 0

    def update(self, score: float) -> bool:
        """Returns True when tracking should be re-initialized."""
        if score < self.threshold:
            self.bad_streak += 1
        else:
            self.bad_streak = 0
        return self.bad_streak >= self.patience


@torch.no_grad()
def track_video_with_health(model, cfg: trk.TrackerConfig,
                            mesh: rz.MeshArrays, K, mean, std, init_pose,
                            frames_rgb, frames_depth_mm):
    """``track_video`` plus each frame's :func:`depth_agreement` at the
    tracking resolution, for automatic drift detection (apply
    :class:`ReinitPolicy` to the scores on the host). Returns (poses (T, 4,
    4), scores (T,))."""
    T = frames_rgb.shape[0]
    dev = init_pose.device
    poses = torch.empty((T, 4, 4), dtype=torch.float32, device=dev)
    scores = torch.empty((T,), dtype=torch.float32, device=dev)
    pose = init_pose
    for i in range(T):
        pose, _ = trk.track_step(model, cfg, mesh, K, mean, std, pose,
                                 frames_rgb[i], frames_depth_mm[i])
        scores[i] = depth_agreement(mesh, pose, K, frames_depth_mm[i], cfg)
        poses[i] = pose
    return poses, scores
