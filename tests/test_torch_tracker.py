"""The PyTorch port's tracking step, video loop and Tracker against the JAX
tracker, on the scene of tests/test_torch_trajectory.py: a 0.08 m cube,
a 64^2 ROI, 192x256 frames, small regression heads."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.models import tracknet as jnet
from iros20_6d_pose_tracking_tpu.render import mesh as M
from iros20_6d_pose_tracking_tpu.render import rasterizer as Rz
from iros20_6d_pose_tracking_tpu.tracking import tracker as jtrk
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.models.convert import (
    state_dict_from_jax)
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as TRz
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
from iros20_6d_pose_tracking_tpu_torch.utils import profiling

torch.set_num_threads(2)

RES = 64
H, W = 192, 256
K = np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1.0]], np.float32)
WIDTH_MM = 110.0
TAU, RHO = 0.03, 5 * np.pi / 180
T_FRAMES = 20


def _rot_angle(Ra, Rb):
    """Angle (rad) of Ra^T Rb from its skew part (exact for small angles,
    where the trace form's arccos has a float32 floor of ~1e-3)."""
    R = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arcsin(min(np.linalg.norm(w) / 2.0, 1.0)))


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
    # Small heads keep per-frame updates a few pixels, so the track stays
    # on the object over the whole horizon.
    for head in ("trans_out", "rot_out"):
        params[head]["kernel"] = params[head]["kernel"] * 0.05
        params[head]["bias"] = params[head]["bias"] * 0.0
    variables = {"params": params, "batch_stats": stats}

    tm = M.make_cube(0.08)
    gt = np.eye(4, dtype=np.float32)
    gt[:3, 3] = [0.01, -0.005, 0.55]
    rgb_f, depth_f = Rz.render(Rz.upload(tm), jnp.asarray(gt), jnp.asarray(K),
                               Rz.full_frame_window(W, H), out_hw=(H, W))
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.0, 0.0, 0.5]

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
    return dict(
        tm=tm, mean=mean, std=std, variables=variables, jmodel=model,
        jcfg=jcfg, jmesh=Rz.upload(tm), tracker=tracker, init=init,
        rgb=np.asarray(rgb_f).astype(np.uint8),
        depth=np.asarray(depth_f).astype(np.uint16))


def _launches():
    c = profiling.counters()
    return (c["launches.pass1_winners"], c["launches.pass2_shade"],
            c["launches.gather_rows"])


def test_track_step_matches_jax(scene):
    s = scene
    ref, _ = jtrk.track_step(
        s["jmodel"], s["jcfg"], s["variables"], s["jmesh"], jnp.asarray(K),
        jnp.asarray(s["mean"]), jnp.asarray(s["std"]),
        jnp.asarray(s["init"]), jnp.asarray(s["rgb"]),
        jnp.asarray(s["depth"]))
    t = s["tracker"]
    pose, aux = trk.track_step(
        t.model, t.cfg, t.mesh, t.K, t.mean, t.std, torch.from_numpy(
            s["init"]), trk.upload_rgb(s["rgb"], "cpu"),
        trk.upload_depth(s["depth"], "cpu"))
    assert (aux["depthA"] > 0).sum() > 500 and (aux["depthB"] > 0).sum() > 500
    np.testing.assert_allclose(pose.numpy(), np.asarray(ref), atol=1e-5)


def test_track_video_follows_jax_trajectory(scene):
    """Per frame within 5e-4 m and 5e-3 rad of the JAX scan (Pallas kernels
    in interpret mode, cull and fused pass 2), while the pose moves."""
    s = scene
    frames_rgb = np.stack([s["rgb"]] * T_FRAMES)
    frames_depth = np.stack([s["depth"]] * T_FRAMES)
    ref = np.asarray(jtrk.track_video(
        s["jmodel"], s["jcfg"], s["variables"], s["jmesh"], jnp.asarray(K),
        jnp.asarray(s["mean"]), jnp.asarray(s["std"]),
        jnp.asarray(s["init"]), jnp.asarray(frames_rgb),
        jnp.asarray(frames_depth)))
    counts = _launches()
    poses = s["tracker"].track_video(s["init"], frames_rgb, frames_depth)
    assert _launches() == counts
    assert poses.shape == (T_FRAMES, 4, 4) and np.isfinite(poses).all()
    assert np.linalg.norm(poses[-1, :3, 3] - s["init"][:3, 3]) > 1e-3
    for i in range(T_FRAMES):
        np.testing.assert_allclose(poses[i, :3, 3], ref[i, :3, 3], atol=5e-4,
                                   err_msg=f"translation, frame {i}")
        assert _rot_angle(poses[i, :3, :3], ref[i, :3, :3]) < 5e-3, i


def test_on_track_equals_track_video_and_detects_metres(scene):
    s = scene
    t = s["tracker"]
    frames_rgb = np.stack([s["rgb"]] * 2)
    frames_depth = np.stack([s["depth"]] * 2)
    video = t.track_video(s["init"], frames_rgb, frames_depth)
    p1 = t.on_track(s["init"], s["rgb"], s["depth"], debug=True)
    p2 = t.on_track(p1, s["rgb"], s["depth"].astype(np.float32) / 1000.0)
    assert t.frame_cnt == 2 and set(t.last_aux) >= {"rgbA", "depthB"}
    np.testing.assert_array_equal(p1, video[0])
    np.testing.assert_allclose(p2, video[1], atol=1e-6)


def test_tracker_from_dataset_info(scene):
    """__init__ decimates past max_faces, auto-culls the closed mesh, and
    carries Flax variables across; ``samples > 1``, the chunked and the
    adaptive video run, and so does a bf16 tracker, within JAX's bars of
    float32 (tests/test_tracker.py: 1 mm, 5e-3; tests/test_torch_bf16.py
    holds it against JAX's bf16)."""
    s = scene
    tm = M.make_icosphere(subdiv=2, radius=0.04)
    info = {"resolution": RES, "object_width": WIDTH_MM,
            "camera": {"focalX": K[0, 0], "focalY": K[1, 1],
                       "centerX": K[0, 2], "centerY": K[1, 2]}}
    t = trk.Tracker(info, s["mean"], s["std"], mesh=tm,
                    variables=s["variables"], trans_normalizer=TAU,
                    rot_normalizer=RHO, max_faces=200, device="cpu")
    assert t.cfg.cull_backfaces
    assert int(t.mesh.fmask.sum()) <= 200 < tm.num_faces
    pose = t.on_track(s["init"], s["rgb"], s["depth"])
    assert pose.shape == (4, 4) and np.isfinite(pose).all()
    multi = t.on_track(s["init"], s["rgb"], s["depth"], samples=4)
    assert multi.shape == (4, 4) and np.isfinite(multi).all()
    assert 0.0 <= t.last_score <= 1.0
    frames_rgb, frames_depth = np.stack([s["rgb"]] * 3), np.stack(
        [s["depth"]] * 3)
    np.testing.assert_array_equal(
        t.track_video_chunked(s["init"], frames_rgb, frames_depth,
                              chunk_size=2),
        t.track_video(s["init"], frames_rgb, frames_depth))
    poses, tel = t.track_video_adaptive(s["init"], frames_rgb, frames_depth,
                                        chunk_size=2, candidates=(2, 1))
    np.testing.assert_array_equal(
        poses, t.track_video(s["init"], frames_rgb, frames_depth))
    assert set(tel["probe_ms_per_frame"]) <= {2, 1}
    t16 = trk.Tracker(info, s["mean"], s["std"], mesh=tm,
                      variables=s["variables"], trans_normalizer=TAU,
                      rot_normalizer=RHO, max_faces=200, device="cpu",
                      dtype=torch.bfloat16)
    assert t16.cfg.dtype == t16.model.dtype == torch.bfloat16
    pose16 = t16.on_track(s["init"], s["rgb"], s["depth"])
    assert np.linalg.norm(pose16[:3, 3] - pose[:3, 3]) < 1e-3
    assert np.abs(pose16[:3, :3] - pose[:3, :3]).max() < 5e-3


def test_from_parts_takes_tensors_without_numpy(scene):
    """K, mean and std may come as tensors on the tracker's device
    (``train_object`` hands its statistics over on the card): they are moved
    there, never read through numpy, which refuses a CUDA tensor. On the
    CPU a tensor that requires grad, which numpy refuses too, stands in for
    one on the card. The tracker then tracks as with arrays."""
    s = scene
    t = s["tracker"]
    ts = trk.Tracker.from_parts(
        t.model, t.cfg, t.mesh, torch.tensor(K, requires_grad=True),
        torch.tensor(s["mean"], requires_grad=True),
        torch.tensor(s["std"], requires_grad=True))
    for name in ("K", "mean", "std"):
        got = getattr(ts, name)
        assert torch.equal(got, getattr(t, name)) and not got.requires_grad
    np.testing.assert_array_equal(
        ts.on_track(s["init"], s["rgb"], s["depth"]),
        t.on_track(s["init"], s["rgb"], s["depth"]))


def test_tracker_loads_reference_checkpoint(scene, tmp_path):
    """A reference ``{"state_dict": ...}`` .pth.tar loads strictly, and so
    does a Flax msgpack checkpoint the JAX package wrote."""
    from iros20_6d_pose_tracking_tpu.train import checkpoint as jck

    s = scene
    sd = state_dict_from_jax(s["variables"])
    path = str(tmp_path / "model_best_val.pth.tar")
    torch.save({"state_dict": sd, "epoch": 3}, path)
    info = {"resolution": RES, "object_width": WIDTH_MM,
            "camera": {"focalX": K[0, 0], "focalY": K[1, 1],
                       "centerX": K[0, 2], "centerY": K[1, 2]}}
    t = trk.Tracker(info, s["mean"], s["std"], ckpt_dir=path, mesh=s["tm"],
                    device="cpu")
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    flax_path = str(tmp_path / "checkpoint_last.msgpack")
    jck.save_checkpoint(flax_path, {**s["variables"], "step": np.int32(3)})
    t = trk.Tracker(info, s["mean"], s["std"], mesh=s["tm"], device="cpu",
                    ckpt_dir=flax_path)
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
