"""Pose-error metrics: ADD, ADD-S (ADI), VOCap AUC, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/eval/metrics.py``:

  - ADD: mean L2 between correspondingly transformed model points
    (reference Utils.py:72-82).
  - ADD-S / ADI: mean distance from each gt-transformed point to its
    nearest pred-transformed point (reference Utils.py:84-98), brute force
    through ``|a|^2 + |b|^2 - 2ab``, as the JAX module computes it.
  - VOCap: area under the error-recall curve with a 0.1 m cutoff
    (reference eval_ycb.py:45-64), in numpy, line for line the JAX
    module's.

The JAX module pins HIGHEST precision on its contractions. Here the point
transform and the ADD-S products are written out elementwise, so no matmul
runs and TF32 cannot apply (ROADMAP F1). The three sums of the ADD-S
expansion take their terms in one order, so a point against itself gives
exactly 0: a matmul for ``g.p`` rounds differently from ``|g|^2`` and left
3e-5 m at 0.6 m. :func:`adi_err` chunks over the gt points and
:func:`batch_errors` over frames, so the (frames, points, points) distance
tensor never exists whole: memory stays bounded on any device, and the
minimum does not depend on the chunking.
"""
from __future__ import annotations

import numpy as np
import torch

# Distances evaluated at a time by adi_err: 16M float32 values, 64 MB each
# for the few temporaries of a chunk.
_ADI_CHUNK = 1 << 24


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over a last axis of 3, as a0 b0 + a1 b1 + a2 b2 in that order
    (broadcasting)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def transform_points(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) x (N, 3) -> (..., N, 3): R p + t."""
    R = pose[..., :3, :3]
    t = pose[..., :3, 3]
    return _dot3(R[..., None, :, :], points[:, None, :]) + t[..., None, :]


def add_err(pred: torch.Tensor, gt: torch.Tensor,
            points: torch.Tensor) -> torch.Tensor:
    """ADD error (reference Utils.py:72-82), over any batch of poses."""
    p = transform_points(pred, points)
    g = transform_points(gt, points)
    return torch.linalg.vector_norm(p - g, dim=-1).mean(dim=-1)


def adi_err(pred: torch.Tensor, gt: torch.Tensor,
            points: torch.Tensor) -> torch.Tensor:
    """ADD-S error (reference Utils.py:84-98): for each gt point, the
    distance to the nearest pred point; mean over gt points. Brute force
    through ``|g|^2 + |p|^2 - 2 g.p``, in chunks of gt points."""
    p = transform_points(pred, points)  # (..., N, 3)
    g = transform_points(gt, points)
    p2, g2 = _dot3(p, p), _dot3(g, g)
    n = points.shape[0]
    batch = max(1, int(np.prod(p.shape[:-2])))
    rows = max(1, _ADI_CHUNK // (batch * n))
    nearest = []
    for s in range(0, n, rows):
        gc = g[..., s:s + rows, None, :]
        cross = _dot3(gc, p[..., None, :, :])  # (..., rows, N)
        d2 = g2[..., s:s + rows, None] + p2[..., None, :] - 2.0 * cross
        nearest.append(torch.sqrt(torch.clamp(d2.amin(dim=-1), min=0.0)))
    return torch.cat(nearest, dim=-1).mean(dim=-1)


def batch_errors(preds: np.ndarray, gts: np.ndarray, points: np.ndarray,
                 chunk: int = 256, device="cuda"):
    """ADD and ADD-S (float32 numpy, (T,)) for (T, 4, 4) pose arrays,
    computed on ``device`` (the card unless the caller asks for the CPU)
    ``chunk`` frames at a time."""
    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device)

    adds, adis = [], []
    pts = put(points)
    for s in range(0, len(preds), chunk):
        pr, gt = put(preds[s:s + chunk]), put(gts[s:s + chunk])
        adds.append(add_err(pr, gt, pts).cpu().numpy())
        adis.append(adi_err(pr, gt, pts).cpu().numpy())
    return np.concatenate(adds), np.concatenate(adis)


def vocap(errors, max_val: float = 0.1) -> float:
    """VOCap AUC (reference eval_ycb.py:45-64), exact reimplementation:
    sort errors, precision_i = i/n, truncate at ``max_val``, rectangle-sum
    the running-max precision over recall gaps, scale by 1/max_val."""
    rec = np.sort(np.asarray(errors, dtype=np.float64))
    n = len(rec)
    if n == 0:
        return 0.0
    prec = np.arange(1, n + 1) / float(n)
    keep = rec < max_val
    rec = rec[keep]
    prec = prec[keep]
    mrec = np.concatenate([[0.0], rec, [max_val]])
    mpre = np.concatenate([[0.0], prec, [prec[-1] if len(prec) else 0.0]])
    for i in range(1, len(mpre)):
        mpre[i] = max(mpre[i], mpre[i - 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    ap = np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]) * (1.0 / max_val)
    return float(ap)


def load_points_xyz(path: str) -> np.ndarray:
    """Read a YCB ``points.xyz`` model file (reference eval_ycb.py:72-80)."""
    return np.loadtxt(path, dtype=np.float64).reshape(-1, 3)
