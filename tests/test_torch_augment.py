"""The port's image ops and B-branch augmentation against the JAX package.

torch cannot replay ``jax.random`` (ROADMAP F7), so :func:`jax_draws`
rebuilds the JAX module's own draws from its key, mirroring the splits of
``data/augment.py`` (hsv_jitter, change_bright, gaussian_noise,
gaussian_blur_aug, black_cover, depth_missing, augment_b), and feeds them
to the port's ``apply_*``. The JAX side runs op by op (no jit), so float32
ops round as the port's do; the bar is 1e-4 of 255 (the transforms agree
to the bit on this machine).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.data import augment as JA
from iros20_6d_pose_tracking_tpu.ops import image as JI
from iros20_6d_pose_tracking_tpu_torch.data import augment as A
from iros20_6d_pose_tracking_tpu_torch.ops import image as I

torch.set_num_threads(2)

HW = (36, 44)
ATOL = 1e-4
ALWAYS = dict(hsv_prob=1.0, noise_prob=1.0, blur_prob=1.0,
              black_cover_prob=1.0, depth_missing_prob=1.0)


def _cfg(jax_side: bool, **kw):
    return (JA.AugmentConfig if jax_side else A.AugmentConfig)(**kw)


def _scene(seed, n=1):
    """RGB in [0, 255], depth with an object disk and invalid pixels, and
    the object mask (numpy, leading batch axis)."""
    rng = np.random.RandomState(seed)
    H, W = HW
    yy, xx = np.mgrid[:H, :W]
    disk = ((yy - H / 2) ** 2 + (xx - W / 2) ** 2) < (0.3 * H) ** 2
    rgb = rng.uniform(0, 255, (n, H, W, 3)).astype(np.float32)
    depth = np.where(disk, rng.uniform(400, 700, (n, H, W)), 0.0)
    depth[:, : H // 4] = rng.uniform(50, 2500, (n, H // 4, W))
    return rgb, depth.astype(np.float32), np.broadcast_to(disk, (n, H, W))


def _u(key, lo=0.0, hi=1.0, shape=()):
    return np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi))


def jax_draws(key, cfg):
    """The JAX module's draws of one sample for ``augment_b(key, ...)``,
    as the port's draw dicts (leading axis 1)."""
    H, W = HW
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    out = {}
    ks = jax.random.split(k1, 6)
    out["hsv"] = {
        "shifts": np.array([[_u(ks[i], -cfg.hsv_noise[i], cfg.hsv_noise[i])
                             for i in range(3)]], np.float32),
        "gates": np.array([[_u(ks[3 + i]) < cfg.hsv_prob for i in range(3)]])}
    out["bright"] = {"mag": np.array([_u(k2, *cfg.bright_mag)], np.float32)}
    ks = jax.random.split(k3, 6)
    out["noise"] = {
        "std_rgb": np.array([_u(ks[0], 0.0, cfg.rgb_noise)], np.float32),
        "noise_rgb": np.asarray(jax.random.normal(ks[1], (H, W, 3)))[None],
        "gate_rgb": np.array([_u(ks[2]) < cfg.noise_prob]),
        "std_d": np.array([_u(ks[3], 0.0, cfg.depth_noise)], np.float32),
        "noise_d": np.asarray(jax.random.normal(ks[4], (H, W)))[None],
        "gate_d": np.array([_u(ks[5]) < cfg.noise_prob])}
    n_sizes = cfg.blur_max_kernel // 2
    ks = jax.random.split(k4, 4)
    out["blur"] = {
        "idx_rgb": np.array([int(jax.random.randint(ks[0], (), 0, n_sizes))]),
        "idx_d": np.array([int(jax.random.randint(ks[1], (), 0, n_sizes))]),
        "gate_rgb": np.array([_u(ks[2]) < cfg.blur_prob]),
        "gate_d": np.array([_u(ks[3]) < cfg.blur_prob])}
    kg, kc = jax.random.split(k5)
    cand = [jax.random.split(k, 3)
            for k in jax.random.split(kc, cfg.black_cover_tries)]
    out["black_cover"] = {
        "apply": np.array([_u(kg) < cfg.black_cover_prob]),
        "cu": np.array([[int(jax.random.randint(c[0], (), 0, W))
                         for c in cand]]),
        "cv": np.array([[int(jax.random.randint(c[1], (), 0, H))
                         for c in cand]]),
        "quad": np.array([[int(jax.random.randint(c[2], (), 0, 4))
                           for c in cand]])}
    ks = jax.random.split(k6, 3)
    out["depth_missing"] = {
        "apply": np.array([_u(ks[0]) < cfg.depth_missing_prob]),
        "frac": np.array([_u(ks[1], 0.0, cfg.depth_missing_percent)],
                         np.float32),
        "u": _u(ks[2], shape=HW)[None]}
    return _torch(out)


def _torch(d):
    if isinstance(d, dict):
        return {k: _torch(v) for k, v in d.items()}
    return torch.from_numpy(np.ascontiguousarray(d))


def _keys(key):
    return jax.random.split(key, 6)


@pytest.mark.parametrize("ksize", [3, 5, 7, 9])
def test_gaussian_blur_matches_jax(ksize):
    """RGB (channels last) and depth, sigma 2 and cv2's sigma-0 rule."""
    rgb, depth, _ = _scene(ksize, n=2)
    for sigma in (2.0, 0.0):
        ref = np.stack([np.asarray(JI.gaussian_blur(jnp.asarray(x), ksize,
                                                    sigma)) for x in rgb])
        got = I.gaussian_blur(torch.from_numpy(rgb), ksize, sigma,
                              channels_last=True).numpy()
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
        ref = np.stack([np.asarray(JI.gaussian_blur(jnp.asarray(x), ksize,
                                                    sigma)) for x in depth])
        got = I.gaussian_blur(torch.from_numpy(depth), ksize, sigma).numpy()
        np.testing.assert_allclose(got, ref, atol=ATOL * 10, rtol=0)


def test_hsv_round_trip_matches_jax():
    """rgb_to_hsv and hsv_to_rgb, including grey pixels (S = 0) and each
    hue sector."""
    rgb, _, _ = _scene(3)
    rgb[0, 0, :3] = [[10, 10, 10], [255, 0, 0], [0, 255, 0]]
    hsv_j = np.asarray(JI.rgb_to_hsv(jnp.asarray(rgb)))
    hsv = I.rgb_to_hsv(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(hsv, hsv_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(I.hsv_to_rgb(torch.from_numpy(hsv_j)).numpy(),
                               np.asarray(JI.hsv_to_rgb(jnp.asarray(hsv_j))),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_each_transform_matches_jax(seed):
    """Every transform, fed the JAX module's draws, on one sample: HSV
    jitter, brightness, noise, blur, black cover and depth dropout, with
    the gates on."""
    cfg_j, cfg = _cfg(True, **ALWAYS), _cfg(False, **ALWAYS)
    rgb, depth, mask = _scene(10 + seed)
    key = jax.random.PRNGKey(seed)
    d = jax_draws(key, cfg_j)
    k1, k2, k3, k4, k5, k6 = _keys(key)
    r_j, d_j, m_j = jnp.asarray(rgb[0]), jnp.asarray(depth[0]), \
        jnp.asarray(mask[0])
    r_t, d_t, m_t = (torch.from_numpy(rgb), torch.from_numpy(depth),
                     torch.from_numpy(np.ascontiguousarray(mask)))

    def close(got, ref, atol=ATOL):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref),
                                   atol=atol, rtol=0)

    close(A.apply_hsv(d["hsv"], r_t, d_t), JA.hsv_jitter(k1, r_j, d_j, cfg_j))
    close(A.apply_bright(d["bright"], r_t), JA.change_bright(k2, r_j, cfg_j))
    got = A.apply_noise(d["noise"], r_t, d_t)
    ref = JA.gaussian_noise(k3, r_j, d_j, cfg_j)
    close(got[0], ref[0])
    close(got[1], ref[1])
    got = A.apply_blur(d["blur"], r_t, d_t, cfg)
    ref = JA.gaussian_blur_aug(k4, r_j, d_j, cfg_j)
    close(got[0], ref[0])
    close(got[1], ref[1], ATOL * 10)
    got = A.apply_black_cover(d["black_cover"], r_t, d_t, m_t)
    ref = JA.black_cover(k5, r_j, d_j, m_j, cfg_j)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))
    close(A.apply_depth_missing(d["depth_missing"], d_t),
          JA.depth_missing(k6, d_j, cfg_j))


@pytest.mark.parametrize("cfg_kw", [{}, ALWAYS, dict(depth_missing_prob=0.15)],
                         ids=["reference", "always", "hard_aug"])
def test_augment_b_matches_jax(cfg_kw):
    """The whole stack on mirrored draws, over 4 keys."""
    cfg_j, cfg = _cfg(True, **cfg_kw), _cfg(False, **cfg_kw)
    rgb, depth, mask = _scene(20)
    for i in range(4):
        key = jax.random.PRNGKey(100 + i)
        ref = JA.augment_b(key, jnp.asarray(rgb[0]), jnp.asarray(depth[0]),
                           jnp.asarray(mask[0]), cfg_j)
        got = A.augment_b(jax_draws(key, cfg_j), torch.from_numpy(rgb[0]),
                          torch.from_numpy(depth[0]),
                          torch.from_numpy(np.ascontiguousarray(mask[0])),
                          cfg)
        for g, r, atol in zip(got, ref, (ATOL, ATOL * 10, 0)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol,
                                       rtol=0)


def test_augment_batch_equals_per_sample():
    """augment_batch on one generator equals augment_b of each sample with
    its row of the batch's draws, bit for bit, and draws differ between
    samples."""
    cfg = _cfg(False)
    rgb, depth, mask = (torch.from_numpy(np.ascontiguousarray(a))
                        for a in _scene(30, n=5))
    out = A.augment_batch(torch.Generator().manual_seed(0), rgb, depth, mask,
                          cfg)
    draws = A.draw_augment(torch.Generator().manual_seed(0), 5, HW, cfg,
                           "cpu")
    assert len(set(draws["bright"]["mag"].tolist())) == 5
    for i in range(5):
        one = A.augment_b(A.sample_draws(draws, i), rgb[i], depth[i],
                          mask[i], cfg)
        for g, r in zip(out, one):
            assert torch.equal(g[i], r), i


def test_draws_follow_the_configured_distributions():
    """Gates open at their probabilities and magnitudes stay in range over
    a batch of 4000."""
    cfg = _cfg(False)
    d = A.draw_augment(torch.Generator().manual_seed(1), 4000, (8, 8), cfg,
                       "cpu")
    assert abs(d["hsv"]["gates"].float().mean() - cfg.hsv_prob) < 0.03
    assert abs(d["blur"]["gate_rgb"].float().mean() - cfg.blur_prob) < 0.03
    assert abs(d["black_cover"]["apply"].float().mean()
               - cfg.black_cover_prob) < 0.03
    assert d["hsv"]["shifts"].abs().max() <= 15.0
    mag = d["bright"]["mag"]
    assert 0.5 <= mag.min() and mag.max() < 1.5 and abs(mag.mean() - 1) < 0.02
    assert set(d["blur"]["idx_rgb"].tolist()) == {0, 1, 2}
    assert "depth_missing" not in d
