"""so(3)/se(3) maps and the relative-pose codec, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/core/se3.py``: the same
formulas, the same small-angle Taylor blends and near-pi branch, float32
throughout.

The random poses of the training sampler are split in two (ROADMAP F7):
``draw_*`` takes a ``torch.Generator`` and returns the raw draws,
``apply_*`` turns draws into directions or poses. torch cannot replay
``jax.random``, so a test hands both packages the same draws.

The JAX module pins HIGHEST precision on every contraction, because pose
math is tiny 3x3/4x4 algebra whose error compounds over thousands of
tracked frames. The torch counterpart of that pin is to keep TF32 off:
:func:`pin_full_fp32` sets it off for cuBLAS matmuls and cuDNN convolutions
(the CNN's float32 parity needs the latter), and the tracker calls it.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-8


def pin_full_fp32() -> None:
    """Run float32 matmuls and convolutions in full float32 on the card.

    cuDNN convolutions default to TF32 on Hopper (about three decimal
    digits), and the JAX reference is full float32. Both switches are
    process-wide torch settings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew matrices."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: rotation vector (..., 3) -> matrix (..., 3, 3),
    with series blends of sin(t)/t and (1-cos t)/t^2 near t = 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    K = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4) pose."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # Made on the device: a torch.tensor() constant would be a host copy
    # that waits for the stream.
    bottom = torch.zeros(batch + (1, 4), dtype=top.dtype, device=top.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def pose_inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform (..., 4, 4)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_pose(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def decode_delta(A_in_cam: torch.Tensor, trans_pred: torch.Tensor,
                 rot_pred: torch.Tensor, trans_normalizer: float,
                 rot_normalizer: float) -> torch.Tensor:
    """Network output -> absolute pose B_in_cam:
    t_B = t_A + tau * trans, R_B = exp(rho * rot) R_A."""
    t_B = A_in_cam[..., :3, 3] + trans_pred * trans_normalizer
    R_B = so3_exp(rot_pred * rot_normalizer) @ A_in_cam[..., :3, :3]
    return make_pose(R_B, t_B)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> rotation vector (..., 3), theta in
    [0, pi] (cv2.Rodrigues semantics). Near pi the axis comes from the
    diagonal of (R + I) / 2, its signs fixed from the off-diagonal sums and
    then made to agree with vee(R - R^T)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = theta < 1e-5
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / torch.clamp(2.0 * torch.sin(theta), min=_EPS))
    w_generic = scale[..., None] * vee

    near_pi = theta > (math.pi - 1e-3)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    a = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    s12 = R[..., 1, 2] + R[..., 2, 1]

    def sgn(x):
        return torch.where(x >= 0, 1.0, -1.0)

    sx, sy, sz = a[..., 0], a[..., 1], a[..., 2]
    candidates = torch.stack([  # axis signs relative to the largest entry
        torch.stack([sx, sy * sgn(s01), sz * sgn(s02)], dim=-1),
        torch.stack([sx * sgn(s01), sy, sz * sgn(s12)], dim=-1),
        torch.stack([sx * sgn(s02), sy * sgn(s12), sz], dim=-1)], dim=-2)
    largest = torch.argmax(a, dim=-1)
    axis_pi = torch.take_along_dim(
        candidates, largest[..., None, None].expand(a.shape[:-1] + (1, 3)),
        dim=-2)[..., 0, :]
    dot_vee = torch.sum(axis_pi * vee, dim=-1, keepdim=True)
    axis_pi = torch.where(dot_vee < 0, -axis_pi, axis_pi)
    return torch.where(near_pi[..., None], theta[..., None] * axis_pi,
                       w_generic)


def normalize_rotation_matrix(R: torch.Tensor) -> torch.Tensor:
    """Column-wise L2 normalization of a near-rotation matrix (reference
    Utils.py:363-367: no re-orthogonalization)."""
    norms = torch.linalg.vector_norm(R, dim=-2, keepdim=True)
    return R / torch.clamp(norms, min=_EPS)


def encode_delta(A_in_cam: torch.Tensor, B_in_cam: torch.Tensor,
                 trans_normalizer: float, rot_normalizer: float):
    """A -> B relative pose as normalized network labels (reference
    datasets.py:141-150): trans = (t_B - t_A) / tau,
    rot = log(colnorm(R_B R_A^T)) / rho. Poses (..., 4, 4)."""
    t_label = (B_in_cam[..., :3, 3] - A_in_cam[..., :3, 3]) / trans_normalizer
    rel = B_in_cam[..., :3, :3] @ A_in_cam[..., :3, :3].transpose(-1, -2)
    r_label = so3_log(normalize_rotation_matrix(rel)) / rot_normalizer
    return t_label, r_label


def uniform(generator, shape, device, lo=0.0, hi=1.0) -> torch.Tensor:
    """Uniform draws in [lo, hi) made on the generator's device, moved to
    ``device`` (the draw half of every random step of the port, F7)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u * (hi - lo) + lo).to(device)


def truncated_normal(shape, generator, device, lo: float = -1.0,
                     hi: float = 1.0) -> torch.Tensor:
    """Standard normal truncated to [lo, hi] (``jax.random.truncated_normal``'s
    distribution), by the exact inverse CDF of a uniform in
    [Phi(lo), Phi(hi)]: no rejection loop."""
    cdf = [0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (lo, hi)]
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float64)
    z = torch.special.ndtri(cdf[0] + u * (cdf[1] - cdf[0]))
    return z.clamp(lo, hi).to(torch.float32).to(device)


def draw_direction(generator, shape, device) -> dict:
    """Draws of :func:`apply_direction`: two uniforms in [0, 1)."""
    return {"u_theta": uniform(generator, shape, device),
            "u_phi": uniform(generator, shape, device)}


def apply_direction(d: dict) -> torch.Tensor:
    """Uniform direction on S^2 (reference Utils.py:394-404) from its draws:
    theta = 2 pi u_theta, cos(phi) = 2 u_phi - 1. Returns (..., 3)."""
    theta = d["u_theta"] * 2.0 * math.pi
    cos_phi = 2.0 * d["u_phi"] - 1.0
    sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
    return torch.stack([sin_phi * torch.cos(theta), sin_phi * torch.sin(theta),
                        cos_phi], dim=-1)


def draw_gaussian_magnitude(generator, shape, device) -> dict:
    """Draws of :func:`apply_gaussian_magnitude`: a direction and a
    [-1, 1]-truncated standard normal for the translation, the same for the
    rotation."""
    return {"dir_t": draw_direction(generator, shape, device),
            "mag_t": truncated_normal(shape, generator, device),
            "dir_r": draw_direction(generator, shape, device),
            "mag_r": truncated_normal(shape, generator, device)}


def apply_gaussian_magnitude(d: dict, max_trans: float,
                             max_rot_deg: float) -> torch.Tensor:
    """Random se(3) perturbation pose (reference Utils.py:372-390) from its
    draws: direction uniform on the sphere, magnitude a [-max, max]
    truncated normal (the stationary distribution of the reference's
    rejection loop). Returns (..., 4, 4)."""
    t = apply_direction(d["dir_t"]) * (d["mag_t"] * max_trans)[..., None]
    mag_r = d["mag_r"] * max_rot_deg
    w = apply_direction(d["dir_r"]) * (mag_r[..., None] * math.pi / 180.0)
    return make_pose(so3_exp(w), t)
