"""The port's ROS node core (``apps/predict_ros.py``) without ROS, as
tests/test_ros_and_ckpt.py holds the JAX one: the stream core against the
blocking core, the sanitizing of NaN, inf and out-of-range depth before the
uint16 cast, depth filling on the tracker's device (against the JAX
``fill_depth``), the on_track_lost callback raising samples to 2, and
``main()`` exiting with its message where rospy is missing. A 0.08 m cube,
a 64^2 ROI, 192x256 frames, small regression heads."""
import builtins

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.ops import depthproc as JD
from iros20_6d_pose_tracking_tpu_torch.apps import predict_ros
from iros20_6d_pose_tracking_tpu_torch.apps.predict_ros import TrackerRosCore
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as TRz
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

torch.set_num_threads(2)

RES = 64
H, W = 192, 256
K = np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1.0]], np.float32)
FILL_BAR_M = 1e-6  # tests/test_torch_depthproc.py


@pytest.fixture(scope="module")
def scene():
    torch.manual_seed(0)
    net = tracknet.create_model(RES).eval()
    with torch.no_grad():
        for head in (net.trans_out, net.rot_out):
            head[0].weight.mul_(0.05)
            head[0].bias.zero_()
    tm = M.make_cube(0.08)
    cfg = trk.TrackerConfig(resolution=RES, object_width_mm=110.0,
                            cull_backfaces=True)
    parts = (net, cfg, TRz.upload(tm, "cpu"), K, np.zeros(8, np.float32),
             np.full(8, 100.0, np.float32))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.005, -0.004, 0.5]
    rgb, depth = TRz.render(parts[2], torch.as_tensor(pose),
                            torch.as_tensor(K), TRz.full_frame_window(W, H),
                            out_hw=(H, W), cull_backfaces=True)
    # ROS style: depth in metres, from whole millimetres
    depth_m = np.round(depth.numpy()).astype(np.float32) / 1000.0
    return dict(parts=parts, pose=pose, rgb=rgb.numpy().astype(np.uint8),
                depth_m=depth_m)


def _core(scene, **kw):
    return TrackerRosCore(trk.Tracker.from_parts(*scene["parts"]), **kw)


def test_stream_core_matches_blocking_core(scene):
    """The stream core follows the reference-shaped blocking core, and is
    not ready before it has frames and a pose."""
    blocking = _core(scene, fill_depth_holes=False, use_stream=False)
    blocking.set_init_pose(scene["pose"])
    blocking.grab_color(scene["rgb"])
    blocking.grab_depth(scene["depth_m"])
    want = [blocking.on_track() for _ in range(3)]
    stream = _core(scene, fill_depth_holes=False)
    assert stream.on_track() is None
    stream.set_init_pose(scene["pose"])
    stream.grab_color(scene["rgb"])
    assert stream.on_track() is None
    stream.grab_depth(scene["depth_m"])
    got = [stream.on_track() for _ in range(3)]
    stream.close()
    for a, b in zip(want, got):
        assert b.dtype == np.float64
        np.testing.assert_allclose(b, a, atol=1e-5)
    assert np.abs(got[-1] - scene["pose"]).max() > 1e-5  # it moved


def test_depth_sanitized_before_the_uint16_cast(scene):
    """NaN and inf no-return pixels read as 0 mm, and depth beyond 65.535 m
    is clamped (both invalid to the step): the stream core tracks the
    corrupted frame as the blocking core tracks the zeroed one."""
    bad = scene["depth_m"].copy()
    bad[:4, :4] = np.nan
    bad[:4, 4:8] = np.inf
    bad[:4, 8:12] = 70.0
    zeroed = scene["depth_m"].copy()
    zeroed[:4, :12] = 0.0
    stream = _core(scene, fill_depth_holes=False)
    stream.set_init_pose(scene["pose"])
    stream.grab_color(scene["rgb"])
    stream.grab_depth(bad)
    p_bad = stream.on_track()
    stream.close()
    blocking = _core(scene, fill_depth_holes=False, use_stream=False)
    blocking.set_init_pose(scene["pose"])
    blocking.grab_color(scene["rgb"])
    blocking.grab_depth(zeroed)
    p_zeroed = blocking.on_track()
    assert np.isfinite(p_bad).all()
    np.testing.assert_allclose(p_bad, p_zeroed, atol=1e-5)


def test_filling_path(scene):
    """fill_depth_holes: the depth is filled on the tracker's device, within
    the bar of the JAX fill_depth, and both cores track the filled frame."""
    holey = scene["depth_m"].copy()
    rng = np.random.RandomState(0)
    holey[rng.rand(H, W) < 0.05] = 0.0
    for use_stream in (True, False):
        core = _core(scene, use_stream=use_stream)
        core.grab_depth(holey)
        assert core.depth.dtype == np.float32
        np.testing.assert_allclose(
            core.depth, np.asarray(JD.fill_depth(jnp.asarray(holey))),
            rtol=0, atol=FILL_BAR_M)
        core.set_init_pose(scene["pose"])
        core.grab_color(scene["rgb"])
        pose = core.on_track()
        assert pose.shape == (4, 4) and np.isfinite(pose).all()
        core.close()


def test_on_track_lost_raises_samples_to_two(scene, capsys):
    core = _core(scene, on_track_lost=lambda idx, score: None)
    assert core.stream.samples == 2
    assert core.stream.reinit_policy is not None
    assert "raising samples 1 -> 2" in capsys.readouterr().out
    core.close()
    core = _core(scene, samples=3)
    assert core.stream.samples == 3 and core.stream.reinit_policy is not None
    core = _core(scene)
    assert core.stream.samples == 1 and core.stream.reinit_policy is None
    assert not core.stream.keep_history


def test_main_without_rospy_exits_with_message(monkeypatch):
    real_import = builtins.__import__

    def no_ros(name, *args, **kwargs):
        if name in ("rospy", "tf", "cv_bridge") or name.startswith(
                "sensor_msgs"):
            raise ImportError(f"No module named {name!r}", name=name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_ros)
    with pytest.raises(SystemExit, match="requires a ROS environment.*"
                       "iros20_6d_pose_tracking_tpu_torch.apps.predict_ros"):
        predict_ros.main(["--artifacts_dir", "x", "--model_path", "y",
                          "--init_pose_file", "z"])
