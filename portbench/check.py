"""The comparisons that decide ``correct``: each number the program's
outputs give against the reference's, beside its limit."""
from __future__ import annotations

import torch


def pose_gaps(prog: torch.Tensor, ref: torch.Tensor, trans_norm: float,
              rot_norm: float):
    """Per frame, the distance between the program's and the reference's
    new pose, in the network's output units: translation over the
    translation normaliser, rotation angle over the rotation normaliser."""
    p, r = prog.double(), ref.double()
    dt = (p[:, :3, 3] - r[:, :3, 3]).norm(dim=1) / trans_norm
    M = p[:, :3, :3] @ r[:, :3, :3].transpose(1, 2)
    vee = torch.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0],
                       M[:, 1, 0] - M[:, 0, 1]], 1)
    ang = torch.asin((vee.norm(dim=1) / 2).clamp(max=1.0))
    return dt, ang / rot_norm


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the larger of the reference's norm of that leaf
    and the median leaf's; ``keep`` names the leaves that count."""
    names = [k for k in ref if keep is None or k in keep]
    rn = torch.stack([ref[k].double().norm() for k in names])
    pn = torch.stack([prog[k].double().norm() for k in names])
    med = rn.median()
    return float(((pn - rn).abs() / torch.maximum(rn, med)).max())


def verdict(numbers: list) -> bool:
    """True when every (name, value, limit) lies within its limit; a
    number that is not finite fails."""
    return all(v == v and v <= lim for _, v, lim in numbers)


def report(numbers: list) -> dict:
    return {n: {"value": v, "limit": lim} for n, v, lim in numbers}
