"""se3, roi and depthproc of the PyTorch port against the JAX package, on
the same numpy inputs made from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.core import se3 as jse3
from iros20_6d_pose_tracking_tpu.ops import depthproc as jdepth
from iros20_6d_pose_tracking_tpu.ops import roi as jroi
from iros20_6d_pose_tracking_tpu.tracking import tracker as jtrk
from iros20_6d_pose_tracking_tpu_torch.core import se3
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.ops import depthproc, roi
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

torch.set_num_threads(2)

K = np.array([[600.0, 0, 320.0], [0, 610.0, 240.0], [0, 0, 1.0]], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rotvecs(rng, n):
    """Random rotation vectors, half of them near zero (the Taylor blend)."""
    w = rng.randn(n, 3) * 0.8
    w[: n // 2] *= rng.choice([1e-9, 1e-6, 1e-5, 1e-3], (n // 2, 1))
    return w.astype(np.float32)


def _poses(rng, n):
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = np.asarray(jse3.so3_exp(jnp.asarray(_rotvecs(rng, n))))
    T[:, :3, 3] = rng.uniform([-0.1, -0.1, 0.3], [0.1, 0.1, 1.2], (n, 3))
    return T


def test_so3_exp_and_hat_match_jax():
    w = _rotvecs(np.random.RandomState(0), 64)
    np.testing.assert_allclose(se3.so3_exp(_t(w)).numpy(),
                               np.asarray(jse3.so3_exp(jnp.asarray(w))),
                               atol=1e-6)
    np.testing.assert_array_equal(se3.hat(_t(w)).numpy(),
                                  np.asarray(jse3.hat(jnp.asarray(w))))
    assert torch.equal(se3.so3_exp(torch.zeros(3)), torch.eye(3))


def test_decode_delta_make_pose_pose_inv_match_jax():
    rng = np.random.RandomState(1)
    A = _poses(rng, 32)
    trans = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
    rot = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
    rot[:8] *= 1e-6
    tau, rho = 0.03, 5 * np.pi / 180
    ours = se3.decode_delta(_t(A), _t(trans), _t(rot), tau, rho).numpy()
    ref = np.asarray(jse3.decode_delta(jnp.asarray(A), jnp.asarray(trans),
                                       jnp.asarray(rot), tau, rho))
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    np.testing.assert_allclose(se3.pose_inv(_t(A)).numpy(),
                               np.asarray(jse3.pose_inv(jnp.asarray(A))),
                               atol=1e-6)
    np.testing.assert_array_equal(
        se3.make_pose(_t(A[:, :3, :3]), _t(A[:, :3, 3])).numpy(), A)


def test_compute_bbox_equal_ints():
    rng = np.random.RandomState(2)
    for pose in _poses(rng, 40):
        width = float(rng.uniform(60, 300))
        ref = np.asarray(jroi.compute_bbox(jnp.asarray(pose), jnp.asarray(K),
                                           width, (1000.0, 1000.0, 1000.0)))
        ours = roi.compute_bbox(_t(pose), _t(K), width,
                                (1000.0, 1000.0, 1000.0))
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), ref)


# (top, left, bottom, right) windows: inside, running off every edge,
# larger than the image, and upsampled.
BBOXES = [(40, 60, 140, 180), (-30, -50, 60, 40), (100, 200, 230, 300),
          (-20, -20, 200, 300), (10, 10, 30, 20)]


@pytest.mark.parametrize("box", BBOXES)
def test_crop_bbox_bit_exact(box):
    rng = np.random.RandomState(3)
    rgb = rng.randint(0, 256, (192, 256, 3)).astype(np.uint8)
    depth = rng.randint(0, 65536, (192, 256)).astype(np.uint16)
    top, left, bottom, right = box
    bbox = np.array([[top, left], [top, right], [bottom, left],
                     [bottom, right]], np.int32)
    rgb_j, d_j = jroi.crop_bbox(jnp.asarray(rgb), jnp.asarray(depth),
                                jnp.asarray(bbox), (64, 48))
    rgb_t, d_t = roi.crop_bbox(_t(rgb), trk.upload_depth(depth, "cpu"),
                               _t(bbox), (64, 48))
    assert rgb_t.dtype == torch.uint8 and rgb_t.shape == (48, 64, 3)
    np.testing.assert_array_equal(rgb_t.numpy(), np.asarray(rgb_j))
    np.testing.assert_array_equal(d_t.numpy(),
                                  np.asarray(d_j).astype(np.int32))


def test_upload_depth_widens_uint16_exactly():
    d = np.array([[0, 1, 32767], [32768, 40000, 65535]], np.uint16)
    up = trk.upload_depth(d, "cpu")
    assert up.dtype == torch.int32
    np.testing.assert_array_equal(up.numpy(), d.astype(np.int32))
    assert trk.upload_depth(d.astype(np.float64), "cpu").dtype == \
        torch.float32


def test_offset_depth_and_normalize_pair_match_jax():
    rng = np.random.RandomState(4)
    pose = _poses(rng, 1)[0]
    rgbA, rgbB = (rng.uniform(0, 255, (2, 32, 40, 3)).astype(np.float32))
    depthA, depthB = rng.uniform(0, 2500, (2, 32, 40)).astype(np.float32)
    depthA[:3] = 0.0
    depthB[:, :2] = 2000.0
    mean = rng.rand(8).astype(np.float32) * 10
    std = rng.rand(8).astype(np.float32) * 20 + 80
    np.testing.assert_allclose(
        depthproc.offset_depth(_t(depthA), _t(pose)).numpy(),
        np.asarray(jdepth.offset_depth(jnp.asarray(depthA),
                                       jnp.asarray(pose))), atol=1e-6)
    ours = tracknet.normalize_pair(_t(rgbA), _t(depthA), _t(rgbB),
                                   _t(depthB), _t(pose), _t(mean), _t(std))
    ref = jtrk.normalize_pair(*map(jnp.asarray, (rgbA, depthA, rgbB, depthB,
                                                 pose, mean, std)))
    for o, r in zip(ours, ref):
        assert o.shape == (32, 40, 4)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)
