"""The port's grayscale morphology, median and bilateral filters and
``fill_depth`` (``ops/image.py``, ``ops/depthproc.py``) against the JAX
functions on the same seeded numpy inputs, and against cv2 as
tests/test_cv2_parity.py holds the JAX ones.

Bars: ``dilate``, ``erode``, ``morph_close`` and ``median_blur`` are max, min
and sort, so they equal JAX's values exactly. ``bilateral_filter`` and
``fill_depth`` go through ``exp`` (the range weights, and the Gaussian taps
of ``blur_type="gaussian"``), which torch and XLA round differently by an
ulp or two: within BAR_M metres on depths of up to 3 m (measured 4.8e-7)."""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.ops import depthproc as JD
from iros20_6d_pose_tracking_tpu.ops import image as JI
from iros20_6d_pose_tracking_tpu_torch.ops import depthproc as D
from iros20_6d_pose_tracking_tpu_torch.ops import image as I

BAR_M = 1e-6
KERNELS = {"cross5": JD._CROSS_KERNEL_5, "ones5": np.ones((5, 5), np.uint8),
           "ones7": np.ones((7, 7), np.uint8),
           "ones31": np.ones((31, 31), np.uint8)}


def _depth_with_holes(seed, hw=(40, 52)):
    """Depth in metres in [0, 3) with 30% holes (0) and a hole-rich band."""
    rng = np.random.RandomState(seed)
    depth = (rng.rand(*hw) * 3).astype(np.float32)
    depth[rng.rand(*hw) < 0.3] = 0.0
    depth[:5] = 0.0
    depth[20:26, 10:20] = 0.0
    return depth


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_morphology_equals_jax(kernel):
    k = KERNELS[kernel]
    img = _depth_with_holes(1)
    for name in ("dilate", "erode", "morph_close"):
        got = getattr(I, name)(torch.from_numpy(img), k).numpy()
        want = np.asarray(getattr(JI, name)(jnp.asarray(img), k))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("ksize", [3, 5])
def test_median_blur_equals_jax(ksize):
    img = _depth_with_holes(2)
    img[3, 4] = np.nan  # sorts last in both
    got = I.median_blur(torch.from_numpy(img), ksize).numpy()
    want = np.asarray(JI.median_blur(jnp.asarray(img), ksize))
    np.testing.assert_array_equal(got, want)
    ints = np.random.RandomState(3).randint(0, 60000, (17, 23)).astype(
        np.int32)  # any dtype: the taps are sorted, not computed
    np.testing.assert_array_equal(
        I.median_blur(torch.from_numpy(ints), ksize).numpy(),
        np.asarray(JI.median_blur(jnp.asarray(ints), ksize)))


@pytest.mark.parametrize("d,sc,ss", [(5, 1.5, 2.0), (3, 0.5, 1.0),
                                     (1, 1.0, 1.0)])
def test_bilateral_filter_within_bar(d, sc, ss):
    img = _depth_with_holes(4)
    got = I.bilateral_filter(torch.from_numpy(img), d, sc, ss).numpy()
    want = np.asarray(JI.bilateral_filter(jnp.asarray(img), d, sc, ss))
    np.testing.assert_allclose(got, want, rtol=0, atol=BAR_M)


@pytest.mark.parametrize("kw", [{}, {"blur_type": "gaussian"},
                                {"extrapolate": True},
                                {"blur_type": "none", "max_depth": 3.5}])
def test_fill_depth_within_bar(kw):
    img = _depth_with_holes(5, (48, 64))
    got = D.fill_depth(torch.from_numpy(img), **kw).numpy()
    want = np.asarray(JD.fill_depth(jnp.asarray(img), **kw))
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=BAR_M)
    if kw.get("blur_type") == "none":  # max, min, sort and subtractions
        np.testing.assert_array_equal(got, want)


def test_fill_depth_fills_holes():
    """tests/test_cv2_parity.py's case: a square hole in a flat 1 m plane is
    filled from its border."""
    depth = np.full((48, 48), 1.0, np.float32)
    depth[20:26, 20:26] = 0.0
    depth[:4] = 0.0
    out = D.fill_depth(torch.from_numpy(depth)).numpy()
    assert (out[21:25, 21:25] > 0.5).all()
    np.testing.assert_allclose(out[30:40, 30:40], 1.0, atol=1e-6)


def test_dilate_matches_cv2():
    rng = np.random.RandomState(7)
    img = (rng.rand(24, 24) * 10).astype(np.float32)
    for k in (np.ones((5, 5), np.uint8), JD._CROSS_KERNEL_5):
        np.testing.assert_allclose(I.dilate(torch.from_numpy(img), k).numpy(),
                                   cv2.dilate(img, k), atol=1e-6)


def test_median_blur_matches_cv2_interior():
    """cv2's 2 px rim differs (its border handling), the interior is
    exact."""
    img = np.random.RandomState(5).rand(32, 40).astype(np.float32)
    got = I.median_blur(torch.from_numpy(img), 5).numpy()
    want = cv2.medianBlur(img, 5)
    np.testing.assert_array_equal(got[2:-2, 2:-2], want[2:-2, 2:-2])
