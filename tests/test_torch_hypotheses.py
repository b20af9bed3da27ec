"""The port's multi-hypothesis tracking (tracking/hypotheses.py), its batched
crop and culled N-view render, and ``roi_views`` against the JAX package, on
a subdiv-2 icosphere (closed: the back-face cull is on) in a 64^2 ROI of
160x120 frames, with small regression heads. JAX runs its Pallas kernels in
interpret mode, as its own tests run them on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.core import se3 as jse3
from iros20_6d_pose_tracking_tpu.models import tracknet as jnet
from iros20_6d_pose_tracking_tpu.render import mesh as JM
from iros20_6d_pose_tracking_tpu.render import rasterizer as JRz
from iros20_6d_pose_tracking_tpu.tracking import hypotheses as jhy
from iros20_6d_pose_tracking_tpu.tracking import tracker as jtrk
from iros20_6d_pose_tracking_tpu_torch.core import se3
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.models.convert import (
    state_dict_from_jax)
from iros20_6d_pose_tracking_tpu_torch.ops import roi
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as TRz
from iros20_6d_pose_tracking_tpu_torch.tracking import hypotheses as hy
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
from iros20_6d_pose_tracking_tpu_torch.utils import profiling

torch.set_num_threads(2)

RES = 64
H, W = 120, 160
K = np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1.0]], np.float32)
WIDTH_MM = 110.0
# Scores are float32 sums over the ROI's pixels, taken in another order by
# XLA (F9): measured within 4e-6 of each other at the poses of this file.
SCORE_BAR = 1e-5
# A score at a refined pose: the port's and JAX's refined poses lie 1.2e-8
# apart, which moves the rendered depth by up to 0.017 mm (3.4e-5 relative,
# the rounding of the screen-linear forms, F13) and the score by 1.9e-4.
STEP_SCORE_BAR = 1e-3
# JAX's vmapped batch rounds apart from its single views (F13).
VMAP_RTOL = 1e-4


def _pose(w, t):
    return se3.make_pose(se3.so3_exp(torch.tensor(w, dtype=torch.float32)),
                         torch.tensor(t, dtype=torch.float32))


@pytest.fixture(scope="module")
def scene():
    return _make_scene()


def _make_scene():
    rng = np.random.RandomState(0)
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
    mean = np.zeros(8, np.float32)
    std = np.full(8, 100.0, np.float32)

    jtm = JM.make_icosphere(subdiv=2, radius=0.05)
    gt = np.eye(4, dtype=np.float32)
    gt[:3, 3] = [0.005, -0.003, 0.5]
    rgb, depth = JRz.render(JRz.upload(jtm), jnp.asarray(gt), jnp.asarray(K),
                            JRz.full_frame_window(W, H), out_hw=(H, W))
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.0, 0.0, 0.51]

    net = tracknet.create_model(RES)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    cfg = trk.TrackerConfig(resolution=RES, object_width_mm=WIDTH_MM,
                            cull_backfaces=True)
    tm = M.make_icosphere(subdiv=2, radius=0.05)
    tracker = trk.Tracker.from_parts(net.eval(), cfg, TRz.upload(tm, "cpu"),
                                     K, mean, std)
    jcfg = jtrk.TrackerConfig(resolution=RES, object_width_mm=WIDTH_MM,
                              render_impl="pallas_interpret",
                              cull_backfaces=True, fuse_pass2=True)
    return dict(
        variables=variables, jmodel=model, jcfg=jcfg, jmesh=JRz.upload(jtm),
        tracker=tracker, init=init, gt=gt, mean=mean, std=std,
        rgb=np.asarray(rgb).astype(np.uint8),
        depth=np.asarray(depth).astype(np.uint16))


def _poses(n, seed=1):
    """n poses around the object, some partly outside the frame."""
    rng = np.random.RandomState(seed)
    return torch.stack([
        _pose(rng.randn(3) * 0.6, [rng.uniform(-0.06, 0.06),
                                   rng.uniform(-0.05, 0.05),
                                   rng.uniform(0.45, 0.6)])
        for _ in range(n)])


def test_batched_crop_equals_single_crops():
    """crop_bbox over N bboxes (some past the image's edge) is the N single
    crops, bit for bit, in the transfer dtypes."""
    rng = np.random.RandomState(2)
    rgb = torch.as_tensor(rng.randint(0, 256, (H, W, 3)), dtype=torch.uint8)
    depth = torch.as_tensor(rng.randint(0, 3000, (H, W)), dtype=torch.int32)
    poses = _poses(6)
    poses[0, 0, 3] = 0.2  # far off to the side: half the crop is padding
    bbox = roi.compute_bbox(poses, torch.as_tensor(K), WIDTH_MM,
                            (1000.0, 1000.0, 1000.0))
    assert bbox.shape == (6, 4, 2)
    crops_rgb, crops_depth = roi.crop_bbox(rgb, depth, bbox, (RES, RES))
    assert crops_rgb.shape == (6, RES, RES, 3) and \
        crops_rgb.dtype == torch.uint8 and crops_depth.dtype == torch.int32
    assert (crops_depth[0] == 0).float().mean() > 0.3
    for n in range(6):
        one_rgb, one_depth = roi.crop_bbox(rgb, depth, bbox[n], (RES, RES))
        assert torch.equal(crops_rgb[n], one_rgb), n
        assert torch.equal(crops_depth[n], one_depth), n


@pytest.mark.parametrize("res", [48, 64])
def test_culled_view_batch_equals_single_renders(scene, res):
    """The culled render of N poses (one pass-1 and one pass-2 call) gives
    each view's winners and depth bit for bit as the single culled render
    of its pose, and its pass-1 inputs are each view's own compaction."""
    t = scene["tracker"]
    poses = _poses(5, seed=res)
    window = TRz.window_from_bbox(roi.compute_bbox(
        poses, t.K, WIDTH_MM, (1000.0, 1000.0, 1000.0)))
    hw = (res, res)
    rgb_b, depth_b = TRz.render(t.mesh, poses, t.K, window, out_hw=hw,
                                cull_backfaces=True)
    fx, fy, fiz, fvalid, R, tt = rk.project_faces(t.mesh, poses, t.K, window,
                                                  hw, TRz.NEAR_M)
    attr = rk.face_attr_forms(fx, fy, fiz, fvalid, t.mesh)
    coef, bbox, fb, attr_c = rk.culled_pass1_inputs(t.mesh, fx, fy, fiz,
                                                    fvalid, R, tt, attr)
    iz_b, win_b = rk.pass1_winners(coef, bbox, hw, fb)
    for n in range(5):
        rgb1, depth1 = TRz.render(t.mesh, poses[n], t.K, window[n],
                                  out_hw=hw, cull_backfaces=True)
        f1 = rk.project_faces(t.mesh, poses[n], t.K, window[n], hw,
                              TRz.NEAR_M)
        a1 = rk.face_attr_forms(*f1[:4], t.mesh)
        c1, b1, _, a1 = rk.culled_pass1_inputs(t.mesh, *f1, a1)
        iz1, win1 = rk.pass1_winners(c1, b1, hw, fb)
        assert torch.equal(coef[n], c1) and torch.equal(bbox[n], b1)
        assert torch.equal(attr_c[n], a1)
        assert torch.equal(win_b[n], win1) and torch.equal(iz_b[n], iz1)
        assert torch.equal(depth_b[n], depth1) and torch.equal(rgb_b[n], rgb1)
        assert (depth1 > 0).sum() > 100, n


def test_depth_agreement_matches_jax(scene):
    """The batched score of 5 poses (the truth, off poses, a pose with no
    overlap) and an occluded frame, against JAX's single-pose score at the
    tracking and the scoring resolution."""
    s, t = scene, scene["tracker"]
    poses = [s["gt"].copy() for _ in range(5)]
    poses[1][0, 3] += 0.01
    poses[2][2, 3] += 0.03
    poses[3][0, 3] += 0.4
    poses[4][:3, :3] = np.asarray(se3.so3_exp(torch.tensor([0.0, 0.3, 0.1])))
    occluded = np.where((np.arange(W)[None, :] < 80) & (s["depth"] > 0),
                        np.uint16(300), s["depth"])
    for frame in (s["depth"], occluded):
        for res in (RES, 88):
            ours = hy.depth_agreement(
                t.mesh, torch.as_tensor(np.stack(poses)), t.K,
                trk.upload_depth(frame, "cpu"), t.cfg, score_res=res).numpy()
            ref = np.array([float(jhy.depth_agreement(
                s["jmesh"], jnp.asarray(p), jnp.asarray(K),
                jnp.asarray(frame), s["jcfg"], score_res=res))
                for p in poses])
            np.testing.assert_allclose(ours, ref, atol=SCORE_BAR)
            assert ref[3] == 0.0 and ours[3] == 0.0
    assert ref[0] > 0.85  # occluded pixels leave the denominator


def _launches():
    c = profiling.counters()
    return c["launches.pass1_winners"], c["launches.pass2_shade"]


@pytest.mark.parametrize("samples,k", [(4, 3), (6, 7)])
def test_track_step_multi_matches_jax(scene, samples, k):
    """JAX's own perturbations injected: the port's winner, its score and
    every hypothesis against JAX's single-view step and score per
    hypothesis (the step bar of tests/test_torch_tracker.py; the port's
    score of JAX's refined poses within SCORE_BAR, its score of its own
    within STEP_SCORE_BAR), and against JAX's vmapped ``track_step_multi``
    within 1e-4 relative (F13)."""
    s, t = scene, scene["tracker"]
    key = jax.random.PRNGKey(k)
    perturb = np.asarray(jse3.random_gaussian_magnitude(
        key, 0.01, 5.0, (samples - 1,)))
    counts = _launches()
    pose, score, aux = hy.track_step_multi(
        t.model, t.cfg, t.mesh, t.K, t.mean, t.std, torch.as_tensor(s["init"]),
        trk.upload_rgb(s["rgb"], "cpu"), trk.upload_depth(s["depth"], "cpu"),
        samples=samples, perturb=torch.from_numpy(perturb.copy()))
    assert _launches() == counts
    jm, jcfg, v = s["jmodel"], s["jcfg"], s["variables"]
    args = (jnp.asarray(K), jnp.asarray(s["mean"]), jnp.asarray(s["std"]))
    hypo = np.concatenate([s["init"][None], s["init"][None] @ perturb])
    ref_poses, ref_scores = [], []
    for h in hypo:
        p, _ = jtrk.track_step(jm, jcfg, v, s["jmesh"], *args, jnp.asarray(h),
                               jnp.asarray(s["rgb"]), jnp.asarray(s["depth"]))
        ref_poses.append(np.asarray(p))
        ref_scores.append(float(jhy.depth_agreement(
            s["jmesh"], p, args[0], jnp.asarray(s["depth"]), jcfg,
            score_res=hy.scoring_resolution(t.cfg))))
    np.testing.assert_allclose(aux["poses"].numpy(), np.stack(ref_poses),
                               atol=1e-5)
    rescored = hy.depth_agreement(
        t.mesh, torch.as_tensor(np.stack(ref_poses)), t.K,
        trk.upload_depth(s["depth"], "cpu"), t.cfg,
        score_res=hy.scoring_resolution(t.cfg))
    np.testing.assert_allclose(rescored.numpy(), ref_scores, atol=SCORE_BAR)
    np.testing.assert_allclose(aux["scores"].numpy(), ref_scores,
                               atol=STEP_SCORE_BAR)
    best = int(np.argmax(ref_scores))
    assert int(torch.argmax(aux["scores"])) == best
    np.testing.assert_array_equal(pose.numpy(), aux["poses"][best].numpy())
    assert float(score) == float(aux["scores"][best])
    vp, vs, vaux = jhy.track_step_multi(
        jm, jcfg, v, s["jmesh"], *args, jnp.asarray(s["init"]),
        jnp.asarray(s["rgb"]), jnp.asarray(s["depth"]), key, samples=samples)
    np.testing.assert_allclose(aux["poses"].numpy(), np.asarray(vaux["poses"]),
                               rtol=VMAP_RTOL, atol=1e-6)
    np.testing.assert_allclose(aux["scores"].numpy(),
                               np.asarray(vaux["scores"]),
                               atol=STEP_SCORE_BAR)
    assert int(np.argmax(np.asarray(vaux["scores"]))) == best


def test_batched_step_equals_single_steps(scene):
    """track_step over N poses against N single steps of the port: the
    crops and renders bit for bit, the poses within the step bar (the CNN
    at batch N rounds its convolutions apart from batch 1)."""
    s, t = scene, scene["tracker"]
    poses = _poses(4, seed=9)
    poses[:, 2, 3] = 0.5
    rgb, depth = (trk.upload_rgb(s["rgb"], "cpu"),
                  trk.upload_depth(s["depth"], "cpu"))
    batch, aux = trk.track_step(t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
                                poses, rgb, depth)
    for n in range(4):
        one, aux1 = trk.track_step(t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
                                   poses[n], rgb, depth)
        for name in ("rgbA", "depthA", "rgbB", "depthB"):
            assert torch.equal(aux[name][n], aux1[name]), (n, name)
        np.testing.assert_allclose(batch[n].numpy(), one.numpy(), atol=1e-5)


def test_on_track_samples_and_video_multi(scene):
    """``on_track(samples=4)`` draws from a generator seeded with
    ``frame_cnt`` and keeps the winner's score; ``track_video_multi`` seeds
    each frame with its index, so it gives the per-frame mode's poses and
    scores bit for bit."""
    s = scene
    t = trk.Tracker.from_parts(s["tracker"].model, s["tracker"].cfg,
                               s["tracker"].mesh, K, s["mean"], s["std"])
    pose, poses, scores = s["init"], [], []
    for _ in range(3):
        pose = t.on_track(pose, s["rgb"], s["depth"], samples=4)
        poses.append(pose)
        scores.append(t.last_score)
    assert t.frame_cnt == 3 and all(0.0 <= x <= 1.0 for x in scores)
    gen = torch.Generator().manual_seed(0)
    p0, s0, _ = hy.track_step_multi(
        t.model, t.cfg, t.mesh, t.K, t.mean, t.std, torch.as_tensor(s["init"]),
        trk.upload_rgb(s["rgb"], "cpu"), trk.upload_depth(s["depth"], "cpu"),
        gen, samples=4)
    np.testing.assert_array_equal(poses[0], p0.numpy())
    assert scores[0] == float(s0)
    vp, vs = hy.track_video_multi(
        t.model, t.cfg, t.mesh, t.K, t.mean, t.std, torch.as_tensor(s["init"]),
        trk.upload_rgb(np.stack([s["rgb"]] * 3), "cpu"),
        trk.upload_depth(np.stack([s["depth"]] * 3), "cpu"), samples=4)
    np.testing.assert_array_equal(vp.numpy(), np.stack(poses))
    np.testing.assert_array_equal(vs.numpy(), np.float32(scores))


def test_reinit_policy_matches_jax():
    rng = np.random.RandomState(4)
    seq = rng.choice([0.05, 0.2, 0.29, 0.3, 0.31, 0.9], size=60)
    for threshold, patience in ((0.3, 2), (0.3, 3), (0.5, 1)):
        ours = hy.ReinitPolicy(threshold, patience)
        ref = jhy.ReinitPolicy(threshold, patience)
        for x in seq:
            assert ours.update(x) == ref.update(x)
            assert ours.bad_streak == ref.bad_streak


def test_track_video_with_health_matches_jax(scene):
    s, t = scene, scene["tracker"]
    n = 3
    frames_rgb = np.stack([s["rgb"]] * n)
    frames_depth = np.stack([s["depth"]] * n)
    ref_p, ref_s = jhy.track_video_with_health(
        s["jmodel"], s["jcfg"], s["variables"], s["jmesh"], jnp.asarray(K),
        jnp.asarray(s["mean"]), jnp.asarray(s["std"]), jnp.asarray(s["init"]),
        jnp.asarray(frames_rgb), jnp.asarray(frames_depth))
    poses, scores = hy.track_video_with_health(
        t.model, t.cfg, t.mesh, t.K, t.mean, t.std, torch.as_tensor(s["init"]),
        trk.upload_rgb(frames_rgb, "cpu"), trk.upload_depth(frames_depth,
                                                            "cpu"))
    np.testing.assert_array_equal(
        poses.numpy(), t.track_video(s["init"], frames_rgb, frames_depth))
    np.testing.assert_allclose(poses.numpy(), np.asarray(ref_p), atol=5e-5)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_s),
                               atol=STEP_SCORE_BAR)
    assert scores.min() > 0.25


def test_roi_views_matches_jax(scene):
    """The canvas pair at a pose: the crop bit for bit; the render under
    tests/test_torch_raster.py's bars for JAX's jitted render (F9): the
    same coverage, depth within 2e-3 relative, rgb more than 2.0 (of 255)
    apart on under 0.1% of pixels."""
    s, t = scene, scene["tracker"]
    ref = [np.asarray(x) for x in jtrk.roi_views(
        s["jcfg"], s["jmesh"], jnp.asarray(K), jnp.asarray(s["gt"]),
        jnp.asarray(s["rgb"]), jnp.asarray(s["depth"]))]
    ours = [x.numpy() for x in trk.roi_views(
        t.cfg, t.mesh, t.K, torch.as_tensor(s["gt"]),
        trk.upload_rgb(s["rgb"], "cpu"), trk.upload_depth(s["depth"], "cpu"))]
    assert all(x.dtype == np.float32 for x in ours)
    np.testing.assert_array_equal(ours[2], ref[2])
    np.testing.assert_array_equal(ours[3], ref[3])
    rgb, depth, rgb_j, depth_j = ours[0], ours[1], ref[0], ref[1]
    np.testing.assert_array_equal(depth > 0, depth_j > 0)
    assert (depth > 0).sum() > 1000
    np.testing.assert_allclose(depth, depth_j, rtol=2e-3)
    assert (np.abs(rgb - rgb_j).max(-1) > 2.0).mean() < 1e-3
