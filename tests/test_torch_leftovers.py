"""The port's counterparts of the JAX functions no JAX module calls:
``core/se3`` ``se3_exp`` / ``se3_log``, ``core/camera`` ``project_points`` /
``project_points_f``, ``ops/image.resize_nearest`` and
``render/rasterizer.render_at_bbox``, each against the JAX function on the
same numpy inputs made from a seed."""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.core import camera as jcam
from iros20_6d_pose_tracking_tpu.core import se3 as jse3
from iros20_6d_pose_tracking_tpu.ops import image as jimage
from iros20_6d_pose_tracking_tpu.render import mesh as JM
from iros20_6d_pose_tracking_tpu.render import rasterizer as JRz
from iros20_6d_pose_tracking_tpu_torch.core import camera, se3
from iros20_6d_pose_tracking_tpu_torch.ops import image
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

torch.set_num_threads(2)

K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]], np.float32)


def _xi(rng):
    """Twists (rho, w): generic rotations, rotations near 0 (both sides of
    the 1e-8 switch on theta^2) and within 1e-3 of pi."""
    axes = rng.randn(48, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([rng.uniform(0.1, 3.0, 16),
                             [1e-9, 1e-6, 5e-5, 1e-4, 2e-4, 1e-3, 1e-2, 0],
                             np.pi - rng.uniform(1e-5, 1e-3, 24)])
    rho = rng.randn(48, 3) * 0.3
    return np.concatenate([rho, axes * angles[:, None]], 1).astype(np.float32)


def test_se3_exp_and_log_match_jax():
    """The exp within 1e-6 of JAX's (the bar of the other se3 maps,
    tests/test_torch_se3_roi.py; measured 2.4e-7). The log, fed JAX's exp,
    within 1e-6 plus 1e-6 relative: its rotation part is ``so3_log``, whose
    arccos multiplies an ulp of the trace by 1 / sin(theta) (3.5 at theta
    2.85; measured 2.4e-6 on a component of 2.61, 5.6e-7 on rho)."""
    xi = _xi(np.random.RandomState(3))
    T_j = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    T = se3.se3_exp(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(T, T_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(se3.se3_log(torch.from_numpy(T_j.copy())),
                               np.asarray(jse3.se3_log(jnp.asarray(T_j))),
                               atol=1e-6, rtol=1e-6)


# Distances from pi of the near-pi round trips, and their bars. In float32
# the log is ill-conditioned just outside the near-pi branch (theta > pi -
# 1e-3): theta / sin(theta) comes from an arccos of a trace within a few
# ulps of -1. Measured over 200 random axes, JAX's own round trip loses
# 0.94 at 9e-4 from pi, 0.23 at 2e-3, 9.5e-3 at 1e-2 and 8.2e-5 at 0.1 (the
# port: 0.74, 0.17, 7.4e-3, 7.9e-5); inside the branch, 6.3e-4 (port
# 6.1e-4) from an axis read off sqrt((diag + 1) / 2). Those angles are held
# against JAX by test_se3_exp_and_log_match_jax. Near 0 the same holds just
# above the series switch (theta^2 < 1e-8): (1 - cos theta) / theta^2
# cancels in float32, and both packages lose 1.3e-4 at theta 1e-4 to 2e-4
# (the same bits), so the round trip near 0 takes the angles either side.
NEAR_ZERO = [0, 1e-9, 1e-6, 5e-5, 1e-3, 1e-2]
NEAR_PI = {"branch": ([1e-6, 1e-5, 1e-4, 3e-4], 1e-3),
           "generic": ([0.1, 0.2, 0.3], 1e-4)}


@pytest.mark.parametrize("near", ["generic", "zero", "pi_branch",
                                  "pi_generic"])
def test_se3_exp_log_roundtrip(near):
    """tests/test_se3.py's round trip (64 twists of scale 0.5, within
    1e-4), the same near 0 (``NEAR_ZERO``, both sides of the 1e-8 switch on
    theta^2), and near pi at the bars of ``NEAR_PI``."""
    rng = np.random.RandomState(4)
    if near == "generic":
        xi, bar = rng.randn(64, 6).astype(np.float32) * 0.5, 1e-4
    else:
        dist, bar = ((None, 1e-4) if near == "zero"
                     else NEAR_PI[near.split("_")[1]])
        axes = rng.randn(64, 3)
        axes /= np.linalg.norm(axes, axis=1, keepdims=True)
        angles = (rng.choice(NEAR_ZERO, 64) if dist is None
                  else np.pi - rng.choice(dist, 64))
        xi = np.concatenate([rng.randn(64, 3) * 0.5,
                             axes * angles[:, None]], 1).astype(np.float32)
    xi2 = se3.se3_log(se3.se3_exp(torch.from_numpy(xi))).numpy()
    np.testing.assert_allclose(xi2, xi, atol=bar)


def test_project_points_match_jax():
    """int32 pixels equal to JAX's away from .5 ties; at exact ties both
    round half to even; the float projection within 1 ulp."""
    rng = np.random.RandomState(5)
    pts = np.stack([rng.uniform(-0.2, 0.2, 400), rng.uniform(-0.2, 0.2, 400),
                    rng.uniform(0.3, 1.5, 400)], 1).astype(np.float32)
    uv64 = pts[:, :2].astype(np.float64) * K[[0, 1], [0, 1]] / \
        pts[:, 2:].astype(np.float64) + K[[0, 1], [2, 2]]
    away = (np.abs(uv64 - np.floor(uv64) - 0.5) > 1e-3).all(1)
    assert away.sum() > 390
    got_f = camera.project_points_f(torch.from_numpy(pts),
                                    torch.from_numpy(K)).numpy()
    ref_f = np.asarray(jcam.project_points_f(jnp.asarray(pts),
                                             jnp.asarray(K)))
    np.testing.assert_array_max_ulp(got_f, ref_f, maxulp=1)
    got = camera.project_points(torch.from_numpy(pts[away]),
                                torch.from_numpy(K)).numpy()
    ref = np.asarray(jcam.project_points(jnp.asarray(pts[away]),
                                         jnp.asarray(K)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    # exact ties: u = 2 x / 1 + 100, v = 2 y / 1 + 50 in float32
    K_tie = np.array([[2.0, 0, 100.0], [0, 2.0, 50.0], [0, 0, 1.0]],
                     np.float32)
    ties = np.array([[0.25, -0.25, 1.0], [0.75, 0.25, 1.0],
                     [-0.25, -0.75, 1.0]], np.float32)
    got = camera.project_points(torch.from_numpy(ties),
                                torch.from_numpy(K_tie)).numpy()
    ref = np.asarray(jcam.project_points(jnp.asarray(ties),
                                         jnp.asarray(K_tie)))
    np.testing.assert_array_equal(got, [[100, 50], [102, 50], [100, 48]])
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("size", [(64, 64), (176, 176), (37, 53)])
@pytest.mark.parametrize("channels", [3, 0])
def test_resize_nearest_matches_jax_and_cv2(size, channels):
    """tests/test_cv2_parity.py's sizes: equal to JAX's and to cv2
    INTER_NEAREST, on a uint8 RGB image and a single-channel float one."""
    rng = np.random.RandomState(3)
    if channels:
        img = rng.randint(0, 255, (120, 160, channels)).astype(np.uint8)
    else:
        img = (rng.rand(120, 160) * 1000).astype(np.float32)
    got = image.resize_nearest(torch.from_numpy(img), size).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jimage.resize_nearest(jnp.asarray(img), size)))
    np.testing.assert_array_equal(got, cv2.resize(
        img, (size[1], size[0]), interpolation=cv2.INTER_NEAREST))


def _pose(t, w):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(jse3.so3_exp(jnp.asarray(w, jnp.float32)))
    T[:3, 3] = t
    return T


@pytest.mark.parametrize("cull", [False, True])
def test_render_at_bbox_matches_jax(cull, monkeypatch):
    """tests/test_rasterizer.py's ROI render (a subdiv-3 icosphere at 0.55
    m, 176^2): bbox equal; rgb and depth within tests/test_torch_raster.py's
    op-by-op bars against JAX's Pallas path (interpret mode, ``jax.
    disable_jit``): coverage equal, depth within 0.01 mm, rgb within 2.0 on
    all but 0.1% of pixels. One K1 and one ``pass2_shade`` call."""
    pose = _pose([0.05, 0.03, 0.55], (0.3, 0.2, 0.1))
    width_mm = 0.08 * 1.1 * 1000
    with jax.disable_jit():
        rgb_j, d_j, bbox_j = JRz.render_at_bbox(
            JRz.upload(JM.make_icosphere(subdiv=3, radius=0.04)),
            jnp.asarray(pose), jnp.asarray(K), width_mm, out_hw=(176, 176),
            impl="pallas_interpret", cull_backfaces=cull)
    calls = []
    for name in ("pass1_winners", "pass2_shade", "pass1_worklist"):
        fn = getattr(rk, name)
        monkeypatch.setattr(rk, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    rgb, d, bbox = rz.render_at_bbox(
        rz.upload(M.make_icosphere(subdiv=3, radius=0.04), "cpu"),
        torch.from_numpy(pose), torch.from_numpy(K), width_mm,
        out_hw=(176, 176), cull_backfaces=cull)
    assert calls == ["pass1_winners", "pass2_shade"]
    np.testing.assert_array_equal(bbox.numpy(), np.asarray(bbox_j))
    d, d_j = d.numpy(), np.asarray(d_j)
    assert (d_j > 0).sum() > 5000
    np.testing.assert_array_equal(d > 0, d_j > 0)
    np.testing.assert_allclose(d, d_j, atol=0.01, rtol=0)
    assert (np.abs(rgb.numpy() - np.asarray(rgb_j)).max(-1) > 2.0).mean() \
        < 1e-3
