"""The port's tracking step against JAX's where the track is lost, on the CPU.

The scene of tests/test_torch_tracker.py (a 0.08 m cube, a 64^2 ROI, 192x256
frames, JAX's Pallas kernels in interpret mode, the cull and the fused pass
2), but with full-size random regression heads, so every step moves far.
Each case is teacher-forced: at frame i both packages take JAX's pose i-1
and frame i, and the port's pose must lie within STEP_BAR of JAX's (NaN at
the same entries). The cases: an x4-shifted hard video from an x4 noisy
initialization (JAX's draws injected), a window clipped by the frame
border, a window wholly outside the frame (B empty), poses inside the near
plane and behind the camera (A empty), and degenerate poses whose pixel
coordinates leave int32 or are NaN (their bbox ints must be XLA's
saturating conversion). On the off-frame, behind-the-camera and degenerate
poses the track-health score must be JAX's too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.core import camera as jcam
from iros20_6d_pose_tracking_tpu.eval import domain_shift as JDS
from iros20_6d_pose_tracking_tpu.models import tracknet as jnet
from iros20_6d_pose_tracking_tpu.ops import roi as jroi
from iros20_6d_pose_tracking_tpu.render import rasterizer as JRz
from iros20_6d_pose_tracking_tpu.tracking import hypotheses as jhy
from iros20_6d_pose_tracking_tpu.tracking import tracker as jtrk
from iros20_6d_pose_tracking_tpu_torch.core import camera
from iros20_6d_pose_tracking_tpu_torch.core import se3
from iros20_6d_pose_tracking_tpu_torch.eval import domain_shift as DS
from iros20_6d_pose_tracking_tpu_torch.eval import synthetic_benchmark as SB
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.models.convert import (
    state_dict_from_jax)
from iros20_6d_pose_tracking_tpu_torch.ops import roi
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as TRz
from iros20_6d_pose_tracking_tpu_torch.tracking import hypotheses as hy
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
from test_torch_domain_shift import jax_init_draws, jax_sensor_draws

torch.set_num_threads(2)

RES = 64
H, W = 192, 256
K = np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1.0]], np.float32)
WIDTH_MM = 110.0
TAU, RHO = 0.03, 5 * np.pi / 180
FRAMES = 6
# The bar of tests/test_torch_tracker.py::test_track_step_matches_jax.
STEP_BAR = 1e-5
# tests/test_torch_hypotheses.py's bar on scores of the same poses.
SCORE_BAR = 1e-5
# XLA's float -> int32 conversion saturates, and NaN gives 0.
INT32_INPUTS = [np.inf, -np.inf, np.nan, 3e9, -3e9, 1e12, 2147483647.0,
                2147483648.0]
INT32_XLA = [2147483647, -2147483648, 0, 2147483647, -2147483648,
             2147483647, 2147483647, 2147483647]


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(0)
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
    variables = {"params": params, "batch_stats": stats}
    tm = M.make_cube(0.08)
    net = tracknet.create_model(RES)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    cfg = trk.TrackerConfig(resolution=RES, trans_normalizer=TAU,
                            rot_normalizer=RHO, object_width_mm=WIDTH_MM,
                            cull_backfaces=True)
    tracker = trk.Tracker.from_parts(net.eval(), cfg, TRz.upload(tm, "cpu"),
                                     K, mean, std)
    jcfg = jtrk.TrackerConfig(resolution=RES, trans_normalizer=TAU,
                              rot_normalizer=RHO, object_width_mm=WIDTH_MM,
                              render_impl="pallas_interpret",
                              cull_backfaces=True, fuse_pass2=True)
    return dict(tm=tm, mean=mean, std=std, variables=variables,
                jmodel=model, jcfg=jcfg, jmesh=JRz.upload(tm),
                tracker=tracker)


def _pose(t, w=(0.0, 0.0, 0.0)):
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = np.asarray(se3.so3_exp(torch.tensor(w, dtype=torch.float32)))
    p[:3, 3] = t
    return p


def _frame(s, pose):
    """The cube rendered at ``pose`` into a full uint8 / uint16 frame."""
    rgb, dep = SB._quantize(*SB.render_test_video(
        s["tracker"].mesh, pose[None], K, hw=(H, W)))
    return rgb[0], dep[0]


def _bbox(pose):
    return roi.compute_bbox(torch.from_numpy(pose), torch.from_numpy(K),
                            WIDTH_MM, (1000.0, 1000.0, 1000.0)).numpy()


def _jbbox(pose):
    return np.asarray(jroi.compute_bbox(jnp.asarray(pose), jnp.asarray(K),
                                        WIDTH_MM, (1000.0, 1000.0, 1000.0)))


def teacher_forced(s, init, frames_rgb, frames_depth, bar=STEP_BAR):
    """Both packages step from JAX's previous pose over the frames; the
    port's pose within ``bar`` of JAX's at every step. Returns JAX's poses
    (the init first) and both packages' first-step intermediates."""
    t = s["tracker"]
    prev = np.asarray(init, np.float32)
    poses, first = [prev], None
    for rgb, dep in zip(frames_rgb, frames_depth):
        jpose, jaux = jtrk.track_step(
            s["jmodel"], s["jcfg"], s["variables"], s["jmesh"],
            jnp.asarray(K), jnp.asarray(s["mean"]), jnp.asarray(s["std"]),
            jnp.asarray(prev), jnp.asarray(rgb), jnp.asarray(dep))
        pose, aux = trk.track_step(
            t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
            torch.from_numpy(prev), trk.upload_rgb(rgb, "cpu"),
            trk.upload_depth(dep, "cpu"))
        np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=bar,
                                   rtol=0, err_msg=f"step {len(poses)}")
        if first is None:
            first = ({k: np.asarray(v) for k, v in jaux.items()},
                     {k: v.numpy() for k, v in aux.items()})
        prev = np.asarray(jpose)
        poses.append(prev)
    return np.stack(poses), first


def assert_scores_match(s, poses, depth):
    """``depth_agreement`` of the same poses in both packages."""
    t = s["tracker"]
    ours = hy.depth_agreement(t.mesh, torch.from_numpy(np.stack(poses)), t.K,
                              trk.upload_depth(depth, "cpu"), t.cfg).numpy()
    ref = np.array([float(jhy.depth_agreement(
        s["jmesh"], jnp.asarray(p), jnp.asarray(K), jnp.asarray(depth),
        s["jcfg"])) for p in poses])
    np.testing.assert_allclose(ours, ref, atol=SCORE_BAR, rtol=0)
    return ref


def test_round_to_int32_is_xlas_conversion():
    """compute_bbox and project_points give XLA's saturating int32s for
    infinite, NaN and out-of-range pixel coordinates (torch's own float ->
    int32 conversion gives -2^31 for every one of them on the CPU)."""
    x = np.array(INT32_INPUTS, np.float32)
    # Unit intrinsics and z = 1 put each input on a pixel axis unchanged.
    K1 = np.eye(3, dtype=np.float32)
    pts = np.stack([x, x[::-1], np.ones_like(x)], -1)
    ours = camera.project_points(torch.from_numpy(pts), torch.from_numpy(K1))
    ref = jcam.project_points(jnp.asarray(pts), jnp.asarray(K1))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ours.numpy()[:, 0], INT32_XLA)
    poses = np.tile(np.eye(4, dtype=np.float32), (len(x), 1, 1))
    poses[:, 0, 3], poses[:, 1, 3] = x, x[::-1]
    for p in poses:
        ours = roi.compute_bbox(torch.from_numpy(p), torch.from_numpy(K1), 0.0)
        ref = jax.jit(jroi.compute_bbox)(jnp.asarray(p), jnp.asarray(K1), 0.0)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    batched = roi.compute_bbox(torch.from_numpy(poses), torch.from_numpy(K1),
                               0.0).numpy()
    np.testing.assert_array_equal(batched[:, 0, 1], INT32_XLA)
    np.testing.assert_array_equal(batched[:, 0, 0], INT32_XLA[::-1])
    np.testing.assert_array_equal(
        np.asarray(jnp.round(jnp.asarray(x)).astype(jnp.int32)), INT32_XLA)
    np.testing.assert_array_equal(
        camera.round_to_int32(torch.from_numpy(x)).numpy(), INT32_XLA)
    np.testing.assert_array_equal(
        camera.round_to_int32(torch.from_numpy(x).double()).numpy(),
        INT32_XLA)


def test_x4_shifted_video_from_x4_init(scene):
    """(a) The sweep's x4 point: the hard video of the cube shifted by the
    sensor model at x4 (JAX's noise draws) and the x4 noisy initialization
    (60 mm and 32 degrees, JAX's direction draws), tracked by full-size
    heads until the track is lost."""
    s = scene
    gt = SB.make_gt_trajectory(FRAMES + 1, z0=0.55)
    sm, jsm = DS.SensorModel().scaled(4.0), JDS.SensorModel().scaled(4.0)
    rgb, dep = SB.render_test_video(s["tracker"].mesh, gt, K, hw=(H, W),
                                    hard=True, lighting=sm.lighting())
    rgb_s, dep_s = SB._quantize(*DS.shift_video(
        rgb, dep, gt, K, sm, draws=jax_sensor_draws(2400, len(gt), (H, W))))
    assert (dep_s > 0).mean() < (dep.numpy() > 0).mean()  # the x4 dropout
    key = jax.random.PRNGKey(1100)
    init = np.asarray(JDS.noisy_init_pose(key, jnp.asarray(gt[0]), jsm))
    np.testing.assert_allclose(
        DS.noisy_init_pose(jax_init_draws(key), gt[0], sm).numpy(), init,
        atol=1e-6, rtol=0)
    d = np.linalg.inv(gt[0]) @ init
    assert abs(np.linalg.norm(d[:3, 3]) - 0.060) < 1e-5
    ang = np.degrees(np.arccos((np.trace(d[:3, :3]) - 1) / 2))
    assert abs(ang - 32.0) < 0.01
    poses, _ = teacher_forced(s, init, rgb_s[1:], dep_s[1:])
    err = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert err.max() > 0.1, err  # lost: 0.1 m is the AUC's ceiling


def test_window_clipped_by_the_border(scene):
    """(b) The cube at the left border: the window reaches past the
    frame's edge, so B holds a band of zeros beside the observed cube."""
    s = scene
    pose = _pose([-0.21, 0.02, 0.55], (0.2, 0.4, 0.0))
    rgb, dep = _frame(s, pose)
    left, right = _bbox(pose)[:, 1].min(), _bbox(pose)[:, 1].max()
    assert left < 0 < right < W
    poses, (jaux, aux) = teacher_forced(
        s, pose, [rgb] * FRAMES, [dep] * FRAMES)
    for a in (jaux, aux):
        assert (a["depthB"][:, 0] == 0).all() and (a["depthB"] > 0).sum() > 100
        assert (a["depthA"] > 0).sum() > 100


def test_window_outside_the_frame(scene):
    """(c) The prior pose projects far right of the frame: B is all zeros,
    and a score of 0 follows the pose in both packages."""
    s = scene
    rgb, dep = _frame(s, _pose([0.0, 0.0, 0.55], (0.3, 0.2, 0.1)))
    pose = _pose([0.9, 0.1, 0.5])
    assert _bbox(pose)[:, 1].min() > W
    poses, (jaux, aux) = teacher_forced(
        s, pose, [rgb] * FRAMES, [dep] * FRAMES)
    for a in (jaux, aux):
        assert not a["depthB"].any() and not a["rgbB"].any()
        assert (a["depthA"] > 0).sum() > 100
    assert_scores_match(s, poses, dep)


@pytest.mark.parametrize("z", [0.05, -0.3])
def test_pose_inside_the_near_plane_or_behind(scene, z):
    """(d) The prior pose inside the 0.1 m near plane, or behind the
    camera: no face survives the near test, so A is empty; the window
    still crops the observed cube into B."""
    s = scene
    rgb, dep = _frame(s, _pose([0.0, 0.0, 0.55], (0.3, 0.2, 0.1)))
    pose = _pose([0.004, -0.003, z], (0.1, 0.2, 0.3))
    poses, (jaux, aux) = teacher_forced(
        s, pose, [rgb] * FRAMES, [dep] * FRAMES)
    for a in (jaux, aux):
        assert not a["depthA"].any() and not a["rgbA"].any()
        assert (a["depthB"] > 0).any()
    assert_scores_match(s, poses, dep)


DEGENERATE = {
    "z0": [0.01, -0.005, 0.0],
    "nan": [np.nan, 0.0, 0.5],
    # One corner of the window on the principal point, the others past
    # 2^31 pixels: the crop then reads where the int32s wrap.
    "corner_past_int32": [0.055, 0.055, 1e-9],
}


@pytest.mark.parametrize("name", list(DEGENERATE))
def test_degenerate_pose(scene, name):
    """(e) Pixel coordinates that are infinite, NaN or beyond int32: the
    bbox ints are JAX's (XLA's saturating conversion), the steps agree
    with NaN at the same entries, and so do the scores."""
    s = scene
    rgb, dep = _frame(s, _pose([0.0, 0.0, 0.55], (0.3, 0.2, 0.1)))
    pose = _pose(DEGENERATE[name])
    bbox = _bbox(pose)
    np.testing.assert_array_equal(bbox, _jbbox(pose))
    extreme = (bbox == 2147483647) | (bbox == -2147483648)
    if name == "z0":  # every corner at +-infinity
        assert extreme.all() and (bbox == 2147483647).any()
    elif name == "nan":  # NaN columns give 0
        assert (bbox[:, 1] == 0).all() and not extreme.any()
    else:
        assert extreme.any() and (bbox == [H // 2, W // 2]).all(-1).any()
    poses, (jaux, aux) = teacher_forced(
        s, pose, [rgb] * FRAMES, [dep] * FRAMES)
    for a in (jaux, aux):
        assert not a["depthA"].any()
    np.testing.assert_array_equal(aux["depthB"], jaux["depthB"])
    assert np.isnan(poses[1]).any() == (name == "nan")
    assert_scores_match(s, poses, dep)
