"""so(3)/se(3) maps and the relative-pose decode, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/core/se3.py``: the same
formulas, the same small-angle Taylor blends, float32 throughout.

The JAX module pins HIGHEST precision on every contraction, because pose
math is tiny 3x3/4x4 algebra whose error compounds over thousands of
tracked frames. The torch counterpart of that pin is to keep TF32 off:
:func:`pin_full_fp32` sets it off for cuBLAS matmuls and cuDNN convolutions
(the CNN's float32 parity needs the latter), and the tracker calls it.
"""
from __future__ import annotations

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
