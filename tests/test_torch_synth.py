"""The port's synthetic pair sampler against the JAX package, and the batch
axis of pass 1 and of the rasterizer.

The JAX sampler runs op by op (``jax.disable_jit`` around
``_synth_batch_impl(..., impl="pallas_interpret")``): inside jit XLA
contracts products into FMAs (ROADMAP F9). Even op by op, JAX's sampler
renders its views under ``jax.vmap``, whose batched contractions round
differently from a single view's: on these inputs its depth differs from
JAX's own single-view render by up to 5.7e-5 relative. So the port's batch
is held bit for bit against JAX's single-view renders of the same poses and
windows, and within 1e-4 relative against JAX's batch. The port is fed
JAX's own poses (they are in the batch dict) and, for ``DRComposite``,
JAX's own draws, rebuilt from its key by :func:`jax_dr_draws` (ROADMAP F7).
The pose draws themselves are compared statistically.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.core import se3 as jse3
from iros20_6d_pose_tracking_tpu.data import dataset as JD
from iros20_6d_pose_tracking_tpu.ops import roi as jroi
from iros20_6d_pose_tracking_tpu.render import mesh as M
from iros20_6d_pose_tracking_tpu.render import rasterizer as Rz
from iros20_6d_pose_tracking_tpu_torch.core import se3
from iros20_6d_pose_tracking_tpu_torch.data import dataset as D
from iros20_6d_pose_tracking_tpu_torch.ops import roi
from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as TRz

torch.set_num_threads(2)

RES = 48
N = 2
K = np.array([[250.0, 0, 24.0], [0, 250.0, 24.0], [0, 0, 1.0]], np.float32)
XYZ = ((-0.05, 0.05), (-0.05, 0.05), (0.45, 0.65))
WIDTH = 110.0
KEY = jax.random.PRNGKey(3)


def _mesh():
    return M.make_icosphere(subdiv=2, radius=0.05)


@pytest.fixture(scope="module")
def jax_batches():
    """JAX's sampler batches of N at RES^2, op by op, without and with
    DRComposite, from one key (numpy); and under "single", JAX's single-view
    renders of the plain batch's poses, both branches in A's window."""
    jm = Rz.upload(_mesh())
    out = {}
    for name, dr in (("plain", None), ("dr", JD.DRComposite())):
        with jax.disable_jit():
            raw = JD._synth_batch_impl(jm, jnp.asarray(K), KEY, N, RES, WIDTH,
                                       0.02, 15.0, XYZ, dr,
                                       "pallas_interpret")
        out[name] = {k: np.asarray(v) for k, v in raw.items()}
    single = {}
    for branch in "AB":
        views = []
        for b in range(N):
            pose_A = jnp.asarray(out["plain"]["A_in_cam"][b])
            window = Rz.window_from_bbox(jroi.compute_bbox(
                pose_A, jnp.asarray(K), WIDTH, (1000.0, 1000.0, 1000.0)))
            with jax.disable_jit():
                views.append(Rz.render(
                    jm, jnp.asarray(out["plain"][f"{branch}_in_cam"][b]),
                    jnp.asarray(K), window, out_hw=(RES, RES),
                    impl="pallas_interpret"))
        single["rgb" + branch] = np.stack([np.asarray(v[0]) for v in views])
        single["depth" + branch] = np.stack([np.asarray(v[1]) for v in views])
    out["single"] = single
    return out


def _smooth_noise_draws(key, channels):
    k1, k2 = jax.random.split(key)
    return {"lo": np.asarray(jax.random.uniform(k1, (6, 6, channels))),
            "hi": np.asarray(jax.random.uniform(k2, (24, 24, channels)))}


def jax_dr_draws(key, n, dr):
    """The draws of JAX's ``_dr_composite_one`` for each of the n samples
    of ``_synth_batch_impl(key, ...)``, as the port's ``draw_dr`` dict."""
    per = []
    for k in jax.random.split(jax.random.fold_in(key, 3), n):
        kbg, kbp, kbd, kocc, kop, koc = jax.random.split(k, 6)
        per.append({
            "bg_noise": _smooth_noise_draws(kbg, 3),
            "u_base": np.asarray(jax.random.uniform(kbd, ())),
            "grad": np.asarray(jax.random.uniform(
                jax.random.fold_in(kbd, 1), (2,), minval=-1.5, maxval=1.5)),
            "depth_noise": _smooth_noise_draws(jax.random.fold_in(kbd, 2), 1),
            "use_bg": np.asarray(jax.random.bernoulli(kbp, dr.bg_prob)),
            "centre": np.asarray(jax.random.uniform(
                kop, (2,), minval=0.2 * RES, maxval=0.8 * RES)),
            "radii": np.asarray(jax.random.uniform(
                jax.random.fold_in(kop, 1), (2,), minval=0.10 * RES,
                maxval=0.30 * RES)),
            "occ_scale": np.asarray(jax.random.uniform(
                jax.random.fold_in(kocc, 1), (), minval=0.5, maxval=0.85)),
            "occ_colour": np.asarray(jax.random.uniform(koc, (3,))),
            "occ_noise": _smooth_noise_draws(jax.random.fold_in(koc, 1), 3),
            "use_occ": np.asarray(jax.random.bernoulli(kocc,
                                                       dr.occluder_prob)),
        })

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return torch.from_numpy(np.ascontiguousarray(np.stack(items)))

    return stack(per)


def _port_batch(ref, dr=None, dr_draws=None, calls=None):
    mesh = TRz.upload(_mesh(), "cpu")
    return D.render_pairs(mesh, torch.from_numpy(K),
                          torch.from_numpy(ref["A_in_cam"]),
                          torch.from_numpy(ref["B_in_cam"]), RES, WIDTH, dr,
                          dr_draws)


def _assert_render_close(ours, ref, keys, single=None):
    """Against JAX's batch: coverage equal, depth within 1e-4 relative
    (measured 5.7e-5: JAX's vmapped renders, see the module docstring), RGB
    within 0.02 (of 255; measured 0.0035). Against JAX's single-view
    renders (``single``): depth bit-equal, RGB within 0.02 (measured 0.0171
    at one pixel near the window's edge: the attribute forms are a float32
    einsum in JAX and a product-sum here)."""
    for k in keys:
        got = ours[k].numpy()
        if k.startswith("depth"):
            np.testing.assert_array_equal(got > 0, ref[k] > 0, err_msg=k)
            np.testing.assert_allclose(got, ref[k], rtol=1e-4, atol=0,
                                       err_msg=k)
            if single is not None:
                np.testing.assert_array_equal(got, single[k], err_msg=k)
        else:
            for want in (ref, single or {}):
                if k in want:
                    np.testing.assert_allclose(got, want[k], atol=0.02,
                                               rtol=0, err_msg=k)


def test_pass1_batched_equals_views():
    """The plain K1 on a batch of views equals the per-view calls bit for
    bit, and the builders batch elementwise."""
    rng = np.random.RandomState(0)
    views = []
    for _ in range(3):
        F, (H, W) = 700, (37, 53)
        cx, cy = rng.uniform(-10, W + 10, (F, 1)), rng.uniform(-10, H + 10,
                                                               (F, 1))
        size = rng.uniform(1.0, 20.0, (F, 1))
        views.append((cx + rng.uniform(-1, 1, (F, 3)) * size,
                      cy + rng.uniform(-1, 1, (F, 3)) * size,
                      rng.uniform(0.5, 3.0, (F, 3)), rng.rand(F) > 0.05))
    fx, fy, fiz, fv = (torch.as_tensor(np.stack(a)) for a in zip(*views))
    fx, fy, fiz = fx.float(), fy.float(), fiz.float()
    coef, _ = rk.build_face_coefficients(fx, fy, fiz, fv)
    bbox = rk.build_block_bboxes(fx, fy, fv, 256)
    assert coef.shape == (3, 12, 700) and bbox.shape == (3, 3, 4)
    iz, win = rk.pass1_winners(coef, bbox, (37, 53), 256)
    for b in range(3):
        c1, _ = rk.build_face_coefficients(fx[b], fy[b], fiz[b], fv[b])
        b1 = rk.build_block_bboxes(fx[b], fy[b], fv[b], 256)
        assert torch.equal(c1, coef[b]) and torch.equal(b1, bbox[b])
        iz1, win1 = rk.pass1_winners_ref(c1, b1, (37, 53), 256)
        assert torch.equal(iz1.view(torch.int32), iz[b].view(torch.int32))
        assert torch.equal(win1, win[b])
    assert (iz > 0).sum() > 1000
    with pytest.raises(ValueError):
        rk.pass1_worklist(coef, bbox, (37, 53), 256)


def test_batched_render_equals_render_per_view():
    """View b of render over B poses is render of pose b alone, bit for
    bit, with one call of each kernel wrapper for the batch, unculled and
    culled (each view compacted along its own face axis); the work list
    takes one pose."""
    mesh = TRz.upload(M.make_cube(0.08), "cpu")
    Kt = torch.from_numpy(K)
    w = torch.as_tensor(np.random.RandomState(1).randn(5, 3),
                        dtype=torch.float32)
    t = torch.tensor([[0.01 * i, -0.01, 0.45 + 0.03 * i] for i in range(5)])
    poses = se3.make_pose(se3.so3_exp(w), t)
    windows = TRz.window_from_bbox(roi.compute_bbox(poses, Kt, WIDTH,
                                                    (1000.0,) * 3))
    for cull in (False, True):
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            for name in ("pass1_winners", "pass2_shade", "gather_rows"):
                fn = getattr(rk, name)
                mp.setattr(rk, name, lambda *a, _f=fn, _n=name, **k: (
                    calls.append(_n), _f(*a, **k))[1])
            rgb, depth = TRz.render(mesh, poses, Kt, windows, (RES, RES),
                                    cull_backfaces=cull)
        assert sorted(calls) == ["pass1_winners", "pass2_shade"]
        assert rgb.shape == (5, RES, RES, 3) and depth.shape == (5, RES, RES)
        for b in range(5):
            bbox = roi.compute_bbox(poses[b], Kt, WIDTH, (1000.0,) * 3)
            r1, d1 = TRz.render(mesh, poses[b], Kt,
                                TRz.window_from_bbox(bbox), (RES, RES),
                                cull_backfaces=cull)
            assert torch.equal(r1, rgb[b]) and torch.equal(d1, depth[b]), b
            assert (d1 > 0).sum() > 100
    with pytest.raises(ValueError):
        TRz.render(mesh, poses, Kt, windows, (RES, RES), worklist=True)


def test_synth_batch_matches_jax(jax_batches):
    """JAX's poses rendered by the port (both branches in A's window):
    depth bit-equal to JAX's single-view renders and within 1e-4 relative of
    JAX's batch, RGB within 0.02, mask equal."""
    ref = jax_batches["plain"]
    ours = _port_batch(ref)
    _assert_render_close(ours, ref, ("rgbA", "depthA", "rgbB", "depthB"),
                         single=jax_batches["single"])
    np.testing.assert_array_equal(ours["maskB"].numpy(), ref["maskB"])
    assert (ref["depthA"] > 0).mean() > 0.1


def test_synth_batch_dr_matches_jax(jax_batches):
    """With DRComposite and JAX's own DR draws: the A branch as above; the
    visibility mask equal; the B branch's object pixels bit-equal to JAX's
    single-view render; the composited depth (object, background and
    occluder, the last two set from the object's mean depth) within 1e-4
    relative of JAX's batch and RGB within 0.02."""
    ref = jax_batches["dr"]
    dr = JD.DRComposite()
    ours = _port_batch(ref, D.DRComposite(), jax_dr_draws(KEY, N, dr))
    _assert_render_close(ours, ref, ("rgbA", "depthA", "depthB", "rgbB"))
    np.testing.assert_array_equal(ours["maskB"].numpy(), ref["maskB"])
    obj = ref["maskB"]
    np.testing.assert_array_equal(ours["depthB"].numpy()[obj],
                                  jax_batches["single"]["depthB"][obj])
    plain = jax_batches["plain"]
    assert (ref["depthB"] > 100).mean() > (plain["depthB"] > 100).mean()


def test_smooth_noise_matches_jax_resize():
    """Bilinear upsampling by F.interpolate (align_corners=False) against
    jax.image.resize: within 1e-6."""
    key = jax.random.PRNGKey(9)
    for channels, res in ((3, 48), (1, 37)):
        ref = np.asarray(JD._smooth_noise(key, res, channels))
        d = {k: torch.from_numpy(v)[None]
             for k, v in _smooth_noise_draws(key, channels).items()}
        got = D.apply_smooth_noise(d, res)[0].numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_pose_draws_match_jax_statistically():
    """4000 draws of the port's sampler poses against 4000 of JAX's: B's
    translation uniform in the view ranges, B's rotation angle uniform in
    [0, pi), and the A-from-B perturbation (translation and angle
    magnitudes of a [-1, 1]-truncated normal times 0.02 m and 15 deg): the
    means agree within 3% and nothing leaves its range."""
    n = 4000
    d = D.draw_synth(torch.Generator().manual_seed(0), n, RES, None, "cpu")
    A_in_cam, B_in_cam = D.sample_poses(d, XYZ, 0.02, 15.0)
    kr, kt, kp = jax.random.split(jax.random.PRNGKey(0), 3)
    pert_j = np.asarray(jse3.random_gaussian_magnitude(kp, 0.02, 15.0, (n,)))
    pert = (se3.pose_inv(B_in_cam) @ A_in_cam).numpy()  # inv(B_in_A)
    t = B_in_cam[:, :3, 3].numpy()
    for i, (lo, hi) in enumerate(XYZ):
        assert lo <= t[:, i].min() and t[:, i].max() <= hi
        assert abs(t[:, i].mean() - (lo + hi) / 2) < 0.03 * (hi - lo)

    def angle(R):
        return np.arccos(np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2,
                                 -1, 1))

    ang_B = angle(B_in_cam[:, :3, :3].numpy().astype(np.float64))
    assert abs(ang_B.mean() / (np.pi / 2) - 1) < 0.03
    for ours, ref, top in (
            (np.linalg.norm(pert[:, :3, 3], axis=1),
             np.linalg.norm(pert_j[:, :3, 3], axis=1), 0.02),
            (angle(pert[:, :3, :3].astype(np.float64)),
             angle(pert_j[:, :3, :3].astype(np.float64)), np.deg2rad(15.0))):
        assert ours.max() <= top * (1 + 1e-4)
        assert abs(ours.mean() / ref.mean() - 1) < 0.03
        assert abs(ours.mean() / top - 0.4599) < 0.02  # E|Z|, Z ~ TN(-1, 1)


def test_sample_batch_is_one_launch_per_kernel():
    """SyntheticPairs.sample_batch renders its 2N views through one call of
    each kernel wrapper, and labels stay within the normalizers."""
    synth = D.SyntheticPairs(TRz.upload(_mesh(), "cpu"), K, resolution=RES,
                             object_width_mm=WIDTH, xyz_range=XYZ,
                             dr=D.DRComposite())
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for name in ("pass1_winners", "pass2_shade", "gather_rows",
                     "pass1_worklist"):
            fn = getattr(rk, name)
            mp.setattr(rk, name, lambda *a, _f=fn, _n=name, **k: (
                calls.append(_n), _f(*a, **k))[1])
        raw = synth.sample_batch(torch.Generator().manual_seed(5), 3)
    assert sorted(calls) == ["pass1_winners", "pass2_shade"]
    assert raw["rgbA"].shape == (3, RES, RES, 3)
    assert raw["maskB"].dtype == torch.bool
    t, r = se3.encode_delta(raw["A_in_cam"], raw["B_in_cam"], 0.02,
                            15 * np.pi / 180)
    assert t.abs().max() <= 1.0 + 1e-4 and r.abs().max() <= 1.0 + 1e-3
    again = synth.sample_batch(torch.Generator().manual_seed(5), 3)
    assert all(torch.equal(raw[k], again[k]) for k in raw)
