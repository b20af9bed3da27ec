"""The port's bfloat16 CNN against the JAX package's, on the same Flax
weights (``state_dict_from_jax``), at a 48^2 ROI on the CPU.

``Se3TrackNet(dtype=torch.bfloat16)`` follows the Flax model's contract
(``models/tracknet.py``): bfloat16 activations, float32 parameters and
BatchNorm statistics, BatchNorm computed in float32 and rounded once, the
heads' outputs float32. The JAX side runs op by op (``jax.disable_jit``),
as the other port tests do (ROADMAP F9). The bars of the tracking step are
JAX's own for bf16 against float32 (``tests/test_tracker.py``: translation
< 1 mm, rotation-matrix entries < 5e-3); the trainer's contract is
``tests/test_train.py``'s mixed-precision test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.models import tracknet as jnet
from iros20_6d_pose_tracking_tpu.render import mesh as JM
from iros20_6d_pose_tracking_tpu.render import rasterizer as Jrz
from iros20_6d_pose_tracking_tpu.tracking import tracker as jtrk
from iros20_6d_pose_tracking_tpu_torch.data import augment as A
from iros20_6d_pose_tracking_tpu_torch.data.dataset import SyntheticPairs
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.models.convert import (
    state_dict_from_jax)
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

torch.set_num_threads(2)

RES = 48
K = np.array([[300.0, 0, 32.0], [0, 300.0, 32.0], [0, 0, 1.0]], np.float32)
WIDTH_MM = 110.0
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def setup():
    """Random Flax weights (PRNGKey 0), the icosphere, one 64x64 frame
    rendered by the port at the pose, and the JAX bf16 step from that
    pose."""
    variables = jnet.init_variables(jnet.Se3TrackNet(image_size=RES),
                                    jax.random.PRNGKey(0))
    tm = M.make_icosphere(subdiv=2, radius=0.05)
    mesh = rz.upload(tm, "cpu")
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.01, -0.005, 0.5]
    rgb, depth = rz.render(mesh, torch.from_numpy(pose), torch.from_numpy(K),
                           rz.full_frame_window(64, 64), out_hw=(64, 64))
    jmesh = Jrz.upload(JM.make_icosphere(subdiv=2, radius=0.05))
    with jax.disable_jit():
        jstep, _ = jtrk.track_step(
            jnet.Se3TrackNet(image_size=RES, dtype=jnp.bfloat16),
            jtrk.TrackerConfig(resolution=RES, object_width_mm=WIDTH_MM,
                               dtype=jnp.bfloat16),
            variables, jmesh, jnp.asarray(K), jnp.zeros(8),
            jnp.full(8, 100.0), jnp.asarray(pose), jnp.asarray(rgb.numpy()),
            jnp.asarray(depth.numpy()))
    return dict(variables=variables, sd=state_dict_from_jax(variables),
                tm=tm, mesh=mesh, pose=pose, rgb=rgb, depth=depth,
                jstep=np.asarray(jstep))


def _net(sd, dtype):
    net = tracknet.Se3TrackNet(image_size=RES, dtype=dtype)
    net.load_state_dict(sd, strict=True)
    return net.eval()


def _tracker(s, dtype):
    return trk.Tracker.from_parts(
        _net(s["sd"], torch.float32),
        trk.TrackerConfig(resolution=RES, object_width_mm=WIDTH_MM), s["mesh"],
        K, np.zeros(8), np.full(8, 100.0), dtype=dtype)


def _step(s, dtype):
    t = _tracker(s, dtype)
    pose, _ = trk.track_step(t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
                             torch.from_numpy(s["pose"]), s["rgb"], s["depth"])
    return pose.numpy()


def _close(a, b):
    """JAX's bars for a bf16 step against float32: translation < 1 mm,
    rotation-matrix entries < 5e-3."""
    dt = float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
    dr = float(np.abs(a[:3, :3] - b[:3, :3]).max())
    assert dt < 1e-3 and dr < 5e-3, (dt, dr)
    return dt, dr


def test_bf16_step_matches_jax_bf16_and_f32(setup):
    """The port's bf16 step against JAX's bf16 step (measured: translation
    0, rotation entries 3.4e-4) and against the port's float32 step (7.9e-5
    m, 5.7e-4), under JAX's bars; the step did move the pose."""
    s = setup
    p16, p32 = _step(s, BF16), _step(s, torch.float32)
    _close(p16, s["jstep"])
    _close(p16, p32)
    assert np.linalg.norm(p16[:3, 3] - s["pose"][:3, 3]) > 1e-2


def test_bf16_track_video_stays_with_f32(setup):
    """An 8-frame bf16 video ends within 5 mm of the float32 one."""
    s = setup
    rgb = np.stack([s["rgb"].numpy()] * 8)
    depth = np.stack([s["depth"].numpy()] * 8)
    tr16 = _tracker(s, BF16).track_video(s["pose"], rgb, depth)
    tr32 = _tracker(s, torch.float32).track_video(s["pose"], rgb, depth)
    assert np.isfinite(tr16).all()
    assert np.linalg.norm(tr16[-1][:3, 3] - tr32[-1][:3, 3]) < 5e-3


def test_bf16_heads_in_train_mode_match_jax(setup):
    """The forward's heads in train mode (BatchNorm on the batch's
    statistics) against JAX's bf16 forward within 2e-2 (measured 1.4e-2 on
    trans, 9.8e-3 on rot, outputs up to 0.88); the outputs are float32, the
    feature bfloat16, and the running statistics stay float32."""
    s = setup
    rng = np.random.RandomState(0)
    a = rng.randn(4, RES, RES, 4).astype(np.float32)
    b = rng.randn(4, RES, RES, 4).astype(np.float32)
    with jax.disable_jit():
        ref, _ = jnet.Se3TrackNet(image_size=RES, dtype=jnp.bfloat16).apply(
            s["variables"], jnp.asarray(a), jnp.asarray(b), train=True,
            mutable=["batch_stats"])
    net = _net(s["sd"], BF16).train()
    out = net(torch.from_numpy(a), torch.from_numpy(b))
    assert out["trans"].dtype == torch.float32
    assert out["feature"].dtype == BF16
    for k in ("trans", "rot"):
        err = np.abs(out[k].detach().numpy() - np.asarray(ref[k])).max()
        assert err < 2e-2, (k, err)
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in net.state_dict().values())


def test_bf16_train_step_descends_with_f32_state():
    """bf16 training on the port (the contract of tests/test_train.py's
    mixed-precision test): over 12 steps the loss descends, and the
    parameters, Adam's moments and BatchNorm's statistics stay float32."""
    mesh = rz.upload(M.make_icosphere(subdiv=2, radius=0.05), "cpu")
    Kt = np.array([[250.0, 0, 24.0], [0, 250.0, 24.0], [0, 0, 1.0]],
                  np.float32)
    synth = SyntheticPairs(
        mesh, Kt, resolution=RES, object_width_mm=WIDTH_MM,
        xyz_range=((-0.05, 0.05), (-0.05, 0.05), (0.45, 0.65)))
    cfg = tr.TrainConfig(resolution=RES, batch_size=8, learning_rate=3e-4,
                         aug=A.AugmentConfig(blur_prob=0.0,
                                             black_cover_prob=0.0))
    model = tracknet.init_params(
        tracknet.Se3TrackNet(image_size=RES, dtype=BF16),
        torch.Generator().manual_seed(0))
    opt, lr_at = tr.make_optimizer(model, cfg, steps_per_epoch=10)
    mean, std = torch.zeros(8), torch.full((8,), 100.0)
    losses = []
    for i in range(12):
        m = tr.train_step_synth(model, opt, lr_at(i), cfg, synth,
                                tr.step_generator("cpu", 11, i),
                                tr.step_generator("cpu", 11, 10**6 + i),
                                mean, std)
        assert m["loss"].dtype == torch.float32
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in model.state_dict().values())
    for state in opt.state.values():
        assert state["exp_avg"].dtype == torch.float32
        assert state["exp_avg_sq"].dtype == torch.float32


def test_bf16_tracker_config_and_constructor(setup):
    """``Tracker(dtype=bfloat16)`` builds a bf16 model that loads the Flax
    weights unchanged and tracks; a config whose dtype is not the model's,
    and a dtype other than float32 or bfloat16, raise."""
    s = setup
    info = {"resolution": RES, "object_width": WIDTH_MM,
            "camera": {"focalX": K[0, 0], "focalY": K[1, 1],
                       "centerX": K[0, 2], "centerY": K[1, 2]}}
    t = trk.Tracker(info, np.zeros(8), np.full(8, 100.0), mesh=s["tm"],
                    variables=s["variables"], device="cpu", dtype=BF16)
    assert t.cfg.dtype == BF16 and t.model.dtype == BF16
    pose = t.on_track(s["pose"], s["rgb"].numpy(), s["depth"].numpy())
    assert pose.shape == (4, 4) and np.isfinite(pose).all()
    with pytest.raises(ValueError, match="bfloat16"):
        trk.track_step(_net(s["sd"], torch.float32), t.cfg, t.mesh, t.K,
                       t.mean, t.std, torch.from_numpy(s["pose"]), s["rgb"],
                       s["depth"])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        trk.TrackerConfig(dtype=torch.float16)
