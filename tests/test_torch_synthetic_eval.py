"""The PyTorch port's closed-loop synthetic evaluation against the JAX
package: trajectory, background texture, the rendered test video (clean
and hard), the scores and the tracked trajectory, on a 96x128 frame.

The JAX renders run the Pallas kernels in interpret mode, op by op
(``jax.disable_jit``): inside jit XLA contracts products into FMAs
(ROADMAP F9), which on the hard video moved one pixel's depth by 3.8e-3
relative. Op by op, float32 ops round as the port's do. The port runs on
the CPU, so its kernel wrappers take their plain versions (K3 for the
video's full-frame renders, K1 and K2 for the tracker's ROI renders).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.datagen import pair_producer as jpp
from iros20_6d_pose_tracking_tpu.eval import synthetic_benchmark as JSB
from iros20_6d_pose_tracking_tpu.models import tracknet as jnet
from iros20_6d_pose_tracking_tpu.render import mesh as M
from iros20_6d_pose_tracking_tpu.render import rasterizer as Rz
from iros20_6d_pose_tracking_tpu.tracking import tracker as jtrk
from iros20_6d_pose_tracking_tpu_torch.datagen import pair_producer as pp
from iros20_6d_pose_tracking_tpu_torch.eval import synthetic_benchmark as SB
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.models.convert import (
    state_dict_from_jax)
from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as TRz
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
from iros20_6d_pose_tracking_tpu_torch.utils import profiling

torch.set_num_threads(2)

HW = (96, 128)
K = np.array([[200.0, 0, 64.0], [0, 200.0, 48.0], [0, 0, 1.0]], np.float32)
T_FRAMES = 5
RES = 48


def _rot_angle(Ra, Rb):
    """Angle (rad) of Ra^T Rb from its skew part."""
    R = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arcsin(min(np.linalg.norm(w) / 2.0, 1.0)))


def _jax_drop_masks(T, hw):
    return np.stack([np.asarray(jax.random.bernoulli(
        jax.random.PRNGKey(1000 + i), 0.03, hw)) for i in range(T)])


@pytest.fixture(scope="module")
def scene():
    """A subdiv-3 icosphere (1280 faces padded to 2048: two face blocks of
    1024) on the gt trajectory, and both packages' hard videos."""
    tm = M.make_icosphere(subdiv=3, radius=0.05)
    gt = SB.make_gt_trajectory(T_FRAMES)
    masks = _jax_drop_masks(T_FRAMES, HW)
    jmesh = Rz.upload(tm)
    with jax.disable_jit():
        rgb_j, dep_j = JSB.render_test_video(jmesh, gt, K=K, hw=HW, hard=True,
                                             impl="pallas_interpret")
    return dict(tm=tm, gt=gt, masks=masks, jmesh=jmesh,
                tmesh=TRz.upload(tm, "cpu"),
                rgb_j=np.asarray(rgb_j), dep_j=np.asarray(dep_j))


def test_gt_trajectory_equals_jax():
    for T, seed in ((60, 5), (40, 1)):
        ours = SB.make_gt_trajectory(T, seed=seed)
        ref = JSB.make_gt_trajectory(T, seed=seed)
        assert ours.dtype == np.float32 and ours.shape == (T, 4, 4)
        np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("family,seed", [(0, 0), (1, 1), (2, 3), (3, 5)])
def test_procedural_texture_matches_jax(family, seed):
    """One seed per family (multi-octave noise, checker, stripes, gradient):
    within 1e-3 of 255. The noise family's bilinear upsampling is
    ``F.interpolate`` against ``jax.image.resize``."""
    assert np.random.RandomState(seed).randint(4) == family
    for hw in ((48, 64), (37, 53)):
        ours = pp._procedural_texture(np.random.RandomState(seed), *hw)
        ref = jpp._procedural_texture(np.random.RandomState(seed), *hw)
        assert ours.dtype == np.float32 and ours.shape == hw + (3,)
        np.testing.assert_allclose(ours, ref, atol=1e-3, rtol=0)


def _assert_frames_close(rgb, dep, rgb_j, dep_j):
    """The bars of tests/test_torch_raster.py against JAX run op by op:
    depth coverage equal and depth within 0.01 mm everywhere, rgb within
    2.0 (of 255) on all but 0.1% of pixels."""
    assert rgb.shape == rgb_j.shape and dep.shape == dep_j.shape
    np.testing.assert_array_equal(dep > 0, dep_j > 0)
    np.testing.assert_allclose(dep, dep_j, atol=0.01, rtol=0)
    assert (np.abs(rgb - rgb_j).max(-1) > 2.0).mean() < 1e-3


def _launches(*wrappers):
    c = profiling.counters()
    return tuple(c[f"launches.{w}"] for w in wrappers)


def test_clean_video_matches_jax(scene):
    s = scene
    with jax.disable_jit():
        rgb_j, dep_j = JSB.render_test_video(s["jmesh"], s["gt"][:3], K=K,
                                             hw=HW, impl="pallas_interpret")
    n3, n1 = _launches("pass1_worklist", "pass1_winners")
    rgb, dep = SB.render_test_video(s["tmesh"], s["gt"][:3], K=K, hw=HW)
    assert _launches("pass1_worklist", "pass1_winners") == (n3, n1)
    dep_j = np.asarray(dep_j)
    assert (dep_j > 0).sum() > 3 * 500 and (dep_j == 0).mean() > 0.5
    _assert_frames_close(rgb.numpy(), dep.numpy(), np.asarray(rgb_j), dep_j)


def test_hard_video_matches_jax(scene, monkeypatch):
    """Background, occluder and dropout (JAX's own dropout masks passed
    in); every full-frame render goes through the K3 wrapper."""
    s = scene
    calls = []
    for name in ("pass1_winners", "pass1_worklist"):
        fn = getattr(rk, name)
        monkeypatch.setattr(rk, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    rgb, dep = SB.render_test_video(s["tmesh"], s["gt"], K=K, hw=HW,
                                    hard=True, drop_masks=s["masks"])
    assert calls == ["pass1_worklist"] * (2 * T_FRAMES)
    rgb, dep = rgb.numpy(), dep.numpy()
    _assert_frames_close(rgb, dep, s["rgb_j"], s["dep_j"])
    assert ((dep == 1500.0) & (s["dep_j"] == 1500.0)).mean() > 0.5
    assert ((dep > 0) & (dep < 1200)).sum() > T_FRAMES * 500
    dropped = s["masks"] & (s["dep_j"] == 0)
    assert dropped.sum() > 0.02 * dep.size and not dep[dropped].any()


def test_default_dropout_is_seeded_per_frame():
    """Without masks, frame i's dropout comes from a CPU generator seeded
    1000 + i: the same on every call and every device, about 3%."""
    m0, m0b, m1 = SB.dropout_mask(0, HW), SB.dropout_mask(0, HW), \
        SB.dropout_mask(1, HW)
    assert torch.equal(m0, m0b) and not torch.equal(m0, m1)
    assert 0.02 < m0.float().mean() < 0.04


def test_quantize_matches_jax(scene):
    s = scene
    rgb_q, dep_q = SB._quantize(torch.from_numpy(s["rgb_j"]),
                                torch.from_numpy(s["dep_j"]))
    rgb_qj, dep_qj = JSB._quantize(jnp.asarray(s["rgb_j"]),
                                   jnp.asarray(s["dep_j"]))
    assert rgb_q.dtype == np.uint8 and dep_q.dtype == np.uint16
    np.testing.assert_array_equal(rgb_q, rgb_qj)
    np.testing.assert_array_equal(dep_q, dep_qj)


def _objects(scene):
    """The JAX BenchObject and the port's, with the same weights
    (``state_dict_from_jax``), BatchNorm statistics randomised and the
    regression heads scaled by 0.05, as tests/test_torch_tracker.py does."""
    rng = np.random.RandomState(0)
    tm = scene["tm"]
    mean = (rng.rand(8) * 10).astype(np.float32)
    std = (rng.rand(8) * 20 + 80).astype(np.float32)
    model = jnet.create_model(RES)
    variables = jnet.init_variables(model, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    for blk in stats.values():
        for bn in blk.values():
            bn["mean"] = rng.uniform(-0.5, 0.5, bn["mean"].shape).astype(
                np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(
                np.float32)
    for head in ("trans_out", "rot_out"):
        params[head]["kernel"] = params[head]["kernel"] * 0.05
        params[head]["bias"] = params[head]["bias"] * 0.0
    variables = {"params": params, "batch_stats": stats}
    width = tm.diameter * 1000 * 1.1
    tau, rho = 0.02, 15 * np.pi / 180
    jobj = JSB.BenchObject(
        name="icosphere", tm=tm, mesh=scene["jmesh"], model=model,
        variables=variables, mean=jnp.asarray(mean), std=jnp.asarray(std),
        width_mm=width, tcfg=jtrk.TrackerConfig(
            resolution=RES, trans_normalizer=tau, rot_normalizer=rho,
            object_width_mm=width, render_impl="pallas_interpret",
            fuse_pass2=True))
    net = tracknet.create_model(RES)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    obj = SB.BenchObject(
        name="icosphere", tm=tm, mesh=scene["tmesh"], model=net.eval(),
        mean=torch.from_numpy(mean), std=torch.from_numpy(std),
        width_mm=width, tcfg=trk.TrackerConfig(
            resolution=RES, trans_normalizer=tau, rot_normalizer=rho,
            object_width_mm=width))
    return jobj, obj


def test_score_poses_matches_jax(scene):
    s = scene
    jobj, obj = _objects(s)
    rng = np.random.RandomState(6)
    poses = s["gt"].copy()
    poses[1:, :3, 3] += rng.randn(T_FRAMES - 1, 3).astype(np.float32) * 0.004
    ours = SB._score_poses(obj, s["gt"], poses)
    ref = JSB._score_poses(jobj, s["gt"], poses)
    assert ours.keys() == ref.keys()
    for key in ("add", "adi"):
        np.testing.assert_allclose(ours[key], ref[key], atol=1e-6, rtol=0)
    for key in ("add_mean_mm", "add_max_mm", "final_trans_err_mm",
                "baseline_add_mean_mm"):
        assert abs(ours[key] - ref[key]) < 1e-3, key  # 1e-6 m in mm
    for key in ("add_auc", "adi_auc", "baseline_add_auc"):
        assert abs(ours[key] - ref[key]) < 1e-3, key
    assert ours["add_mean_mm"] > 1.0


def test_evaluate_tracking_follows_jax(scene):
    """Both packages track the same quantized hard video with the same
    weights at a 48^2 ROI: every tracked frame within 5e-4 m and 5e-3 rad
    of JAX's, and the scores agree."""
    s = scene
    jobj, obj = _objects(s)
    rgb_q, dep_q = JSB._quantize(jnp.asarray(s["rgb_j"]),
                                 jnp.asarray(s["dep_j"]))
    ref = JSB.evaluate_tracking(jobj, s["gt"], rgb_q, dep_q, K=K)
    n1 = _launches("pass1_winners")
    ours = SB.evaluate_tracking(obj, s["gt"], rgb_q, dep_q, K=K)
    assert _launches("pass1_winners") == n1  # CPU: plain versions
    poses, ref_poses = ours["poses"], np.asarray(ref["poses"])
    assert poses.shape == (T_FRAMES, 4, 4) and np.isfinite(poses).all()
    assert np.abs(poses[1:, :3, 3] - s["gt"][:1, :3, 3]).max() > 1e-3
    for i in range(1, T_FRAMES):
        np.testing.assert_allclose(poses[i, :3, 3], ref_poses[i, :3, 3],
                                   atol=5e-4, err_msg=f"frame {i}")
        assert _rot_angle(poses[i, :3, :3], ref_poses[i, :3, :3]) < 5e-3, i
    assert abs(ours["add_mean_mm"] - ref["add_mean_mm"]) < 0.5


def test_unported_entry_points_name_the_roadmap():
    # Every entry point of the JAX module is ported: train_object and
    # hard_aug (tests/test_torch_trainer.py), the sweep, the ablation and
    # run_suite (tests/test_torch_suite.py), and the object ensemble of
    # ROADMAP P17 (tests/test_torch_ensemble_suite.py). Each takes the JAX
    # function's parameters (but ``impl``), and none raises
    # NotImplementedError any more.
    for name in ("train_object", "train_objects_ensemble",
                 "ensemble_evaluate_tracking", "run_suite",
                 "evaluate_tracking", "shift_severity_sweep",
                 "shift_axis_ablation"):
        ours = inspect.signature(getattr(SB, name)).parameters
        theirs = inspect.signature(getattr(JSB, name)).parameters
        assert set(theirs) - {"impl"} <= set(ours), name
    assert "NotImplementedError" not in inspect.getsource(SB)
    assert SB.SHIFT_AXES == JSB.SHIFT_AXES
    assert (SB.hard_aug().depth_missing_prob
            == JSB.hard_aug().depth_missing_prob)
    assert SB.SYMMETRIC_OBJECTS == JSB.SYMMETRIC_OBJECTS
    assert SB.OBJECTS.keys() == JSB.OBJECTS.keys()
    np.testing.assert_array_equal(SB.YCB_K, JSB.YCB_K)
