"""The port's sensor model and recovery protocols (``eval/domain_shift.py``)
against the JAX package's, on the CPU.

torch cannot replay ``jax.random`` (ROADMAP F7), so JAX's own draws are
injected: the sensor noise of ``jax.random.split(key, 5)`` in the order of
the JAX ``apply_sensor_model`` (its Bernoulli masks are ``uniform < p``,
bit for bit in the installed JAX), the directions of ``noisy_init_pose``,
and the re-init draws of ``long_horizon_eval`` keyed by frame index. The
JAX side runs op by op (``jax.disable_jit``; ROADMAP F9). The observed
videos are rendered once by the port and handed to both packages.

``tests/data/jax_sweep_init_draws.json`` holds the initialization draws of
JAX's severity sweep of the cube, for the card machine, which has no JAX
(``accuracy_f17.py``); a test regenerates them here and compares. To write
the file again: ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_domain_shift.py``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.eval import domain_shift as JDS
from iros20_6d_pose_tracking_tpu.eval import synthetic_benchmark as JSB
from iros20_6d_pose_tracking_tpu.models import tracknet as jnet
from iros20_6d_pose_tracking_tpu.render import rasterizer as Jrz
from iros20_6d_pose_tracking_tpu.tracking import hypotheses as jhy
from iros20_6d_pose_tracking_tpu.tracking import tracker as jtrk
from iros20_6d_pose_tracking_tpu_torch.datagen import pair_producer as pp
from iros20_6d_pose_tracking_tpu_torch.eval import domain_shift as DS
from iros20_6d_pose_tracking_tpu_torch.eval import synthetic_benchmark as SB
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.models.convert import (
    state_dict_from_jax)
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
from iros20_6d_pose_tracking_tpu_torch.tracking import hypotheses as hy
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

torch.set_num_threads(2)

SWEEP_DRAWS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                           "jax_sweep_init_draws.json")
SWEEP_SEVERITIES = (0.5, 1.0, 2.0, 3.0, 4.0)
HW = (96, 128)
K = np.array([[200.0, 0, 64.0], [0, 200.0, 48.0], [0, 0, 1.0]], np.float32)
RES = 48
SEVERITIES = (0.0, 0.5, 1.0, 2.0, 4.0)


def jax_sensor_draws(seed, T, hw):
    """JAX's draws of ``shift_video(..., seed=seed)``: frame t's key is
    ``split(PRNGKey(seed), T)[t]``, split into (rgb noise, depth noise,
    dropout, edge dropout, warp), as ``apply_sensor_model`` splits it."""
    out = {k: [] for k in ("rgb_noise", "depth_noise", "drop", "edge",
                           "warp")}
    for key in jax.random.split(jax.random.PRNGKey(seed), T):
        kn, kd, kdrop, kedge, kw = jax.random.split(key, 5)
        out["rgb_noise"].append(jax.random.normal(kn, tuple(hw) + (3,)))
        out["depth_noise"].append(jax.random.normal(kd, tuple(hw)))
        out["drop"].append(jax.random.uniform(kdrop, tuple(hw)))
        out["edge"].append(jax.random.uniform(kedge, tuple(hw)))
        out["warp"].append(jax.random.uniform(kw, (4, 4)))
    return {k: torch.from_numpy(np.stack([np.asarray(x) for x in v]))
            for k, v in out.items()}


def jax_init_draws(key):
    """The directions ``noisy_init_pose(key, ...)`` draws in JAX: two
    ``random_direction`` calls, each two uniforms."""
    out = {}
    for name, k in zip(("dir_t", "dir_r"), jax.random.split(key)):
        ka, kb = jax.random.split(k)
        out[name] = {"u_theta": torch.tensor(float(jax.random.uniform(ka))),
                     "u_phi": torch.tensor(float(jax.random.uniform(kb)))}
    return out


def jax_sweep_init_draws():
    """JAX's noisy initializations of the cube's severity sweep (the suite's
    object 0, so its seed is 0): severity s draws ``noisy_init_pose(
    PRNGKey(700 + int(100 s)), gt[0], SensorModel().scaled(s))`` (JAX
    ``shift_severity_sweep``). Per severity: the key, the four uniforms of
    the two directions and the pose they give, as JSON numbers (each a
    float32 value)."""
    gt0 = SB.make_gt_trajectory(1)[0]  # gt[0] for every length
    rows = {}
    for s in SWEEP_SEVERITIES:
        seed = 700 + int(s * 100)
        key = jax.random.PRNGKey(seed)
        draws = {name: {k: float(v) for k, v in d.items()}
                 for name, d in jax_init_draws(key).items()}
        pose = JDS.noisy_init_pose(key, jnp.asarray(gt0),
                                   JDS.SensorModel().scaled(s))
        rows[str(s)] = {"key": seed, **draws,
                        "init_pose": np.asarray(pose).tolist()}
    return {"object": "cube", "gt0": gt0.tolist(), "severities": rows}


def jax_reinit_draws(seed):
    """Frame index -> JAX's re-init draws ``fold_in(PRNGKey(seed), i)``."""
    key = jax.random.PRNGKey(seed)
    return lambda i: jax_init_draws(jax.random.fold_in(key, i))


def _video(tm, gt, hard=False):
    """The port's render of ``gt`` as numpy float32 frames."""
    rgb, dep = SB.render_test_video(rz.upload(tm, "cpu"), gt, K, hw=HW,
                                    hard=hard)
    return rgb.numpy(), dep.numpy()


@pytest.mark.parametrize("s", SEVERITIES)
def test_sensor_model_scaled_matches_jax(s):
    ours, ref = DS.SensorModel().scaled(s), JDS.SensorModel().scaled(s)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    np.testing.assert_array_equal(ours.lighting().numpy(),
                                  np.asarray(ref.lighting()))
    assert ours.lighting().dtype == torch.float32


def test_texture_hostile_and_velocities_match_jax():
    assert dataclasses.asdict(DS.texture_hostile()) == dataclasses.asdict(
        JDS.texture_hostile())
    base = DS.SensorModel().scaled(2.0)
    assert dataclasses.asdict(DS.texture_hostile(base)) == dataclasses.asdict(
        JDS.texture_hostile(JDS.SensorModel().scaled(2.0)))
    gt = SB.make_gt_trajectory(30)
    ours = DS.screen_velocities(gt, K)
    assert ours.dtype == np.float32 and ours.shape == (30, 2)
    np.testing.assert_array_equal(ours, JDS.screen_velocities(gt, K))


@pytest.fixture(scope="module")
def hard_video():
    """A hard (background, occluder, dropout) 96x128 video of the cube over
    4 frames of the gt trajectory."""
    gt = SB.make_gt_trajectory(4)
    return (gt,) + _video(M.make_cube(0.08), gt, hard=True)


@pytest.mark.parametrize("severity", [1.0, 2.0, 3.0, 4.0])
def test_shift_video_matches_jax(hard_video, severity):
    """The default model (x1), x2, x3 (the sweep's cliff on the card) and
    x4 (negative ambient, gamma 1.15^4) on
    JAX's draws: rgb within 1e-3 of 255 everywhere (measured 3.1e-5); the
    blur offsets equal; depth differs on at most 0.1% of pixels, each by
    one quantization step or by dropout (measured: none, bit-equal)."""
    gt, rgb, dep = hard_video
    sm, jsm = DS.SensorModel().scaled(severity), \
        JDS.SensorModel().scaled(severity)
    draws = jax_sensor_draws(3, len(gt), HW)
    with jax.disable_jit():
        rgb_j, dep_j = JDS.shift_video(jnp.asarray(rgb), jnp.asarray(dep),
                                       gt, K, jsm, seed=3)
    rgb_j, dep_j = np.asarray(rgb_j), np.asarray(dep_j)
    rgb_s, dep_s = DS.shift_video(torch.from_numpy(rgb),
                                  torch.from_numpy(dep), gt, K, sm,
                                  draws=draws)
    rgb_s, dep_s = rgb_s.numpy(), dep_s.numpy()
    np.testing.assert_allclose(rgb_s, rgb_j, atol=1e-3, rtol=0)
    vel = DS.screen_velocities(gt, K)
    offs = DS.blur_offsets(torch.from_numpy(vel), sm).numpy()
    for t in range(len(gt)):
        with jax.disable_jit():
            v = jnp.asarray(vel[t])
            speed = jnp.linalg.norm(v)
            ext = jnp.minimum(speed, jsm.motion_blur_px)
            direc = v / jnp.maximum(speed, 1e-6)
            taps = jnp.array([-1.0, -0.5, 0.0, 0.5, 1.0])
            ref = jnp.round(taps[:, None] * ext * direc[None, :])
        np.testing.assert_array_equal(offs[t], np.asarray(ref).astype(int))
    assert np.abs(offs).max() >= 1  # the blur does shift
    diff = dep_s != dep_j
    assert diff.mean() <= 1e-3
    step = np.isclose(np.abs(dep_s - dep_j), sm.depth_quant_mm, rtol=1e-5)
    dropped = (dep_s == 0) | (dep_j == 0)
    assert (step | dropped)[diff].all()
    valid = dep_s > 0
    q = dep_s[valid] / sm.depth_quant_mm
    np.testing.assert_allclose(q, np.round(q), atol=1e-3)
    assert valid.mean() < (dep > 0).mean()


def test_edge_dropout_wraps_around_the_border_like_jax():
    """JAX's edge-dropout neighbourhood is ``jnp.roll``: a depth step at the
    left border drops the right border's pixels too. The port copies it on
    purpose (ROADMAP F8); noise-free, the two agree bit for bit."""
    T, (H, W) = 4, HW  # the shapes of test_shift_video_matches_jax
    dep = np.full((T, H, W), 1500.0, np.float32)
    dep[:, :, 0] = 500.0
    rgb = np.full((T, H, W, 3), 100.0, np.float32)
    gt = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    gt[:, 2, 3] = 0.6
    sm = dataclasses.replace(DS.SensorModel(), depth_noise_mm=0.0,
                             depth_warp_amp=0.0, dropout_prob=0.0,
                             edge_dropout_prob=1.0, depth_quant_mm=1.0)
    jsm = JDS.SensorModel(**dataclasses.asdict(sm))
    with jax.disable_jit():
        _, dep_j = JDS.shift_video(jnp.asarray(rgb), jnp.asarray(dep), gt, K,
                                   jsm, seed=0)
    _, dep_s = DS.shift_video(rgb, dep, gt, K, sm,
                              draws=jax_sensor_draws(0, T, (H, W)))
    np.testing.assert_array_equal(dep_s.numpy(), np.asarray(dep_j))
    d = dep_s.numpy()
    assert (d[:, :, W - 1] == 0).all() and (d[:, :, 0] == 0).all()
    assert (d[:, :, W // 2] == 1500.0).all()


def test_warp_upsampling_equals_jax_resize():
    """The depth warp's 4x4 -> HxW bilinear upsampling (the pair factory's
    half-pixel helper) against ``jax.image.resize(..., "bilinear")``."""
    u = np.random.RandomState(0).rand(4, 4).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(u), HW, "bilinear"))
    ours = pp._upsample_linear_t(torch.from_numpy(u)[..., None], *HW)[..., 0]
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)


def test_noisy_init_pose_matches_jax():
    """On JAX's directions: within 1e-6 of JAX's pose, with the exact
    translation and rotation magnitudes (tests/test_domain_shift.py)."""
    sensor = DS.SensorModel(init_trans_m=0.015, init_rot_deg=8.0)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 0.6
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(JDS.noisy_init_pose(key, jnp.asarray(pose),
                                             JDS.SensorModel()))
        p = DS.noisy_init_pose(jax_init_draws(key), pose, sensor).numpy()
        np.testing.assert_allclose(p, ref, atol=1e-6, rtol=0)
        d = np.linalg.inv(pose) @ p
        assert abs(np.linalg.norm(d[:3, 3]) - 0.015) < 1e-5
        ang = np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2,
                                           -1, 1)))
        assert abs(ang - 8.0) < 0.01
    gen_a, gen_b = (torch.Generator().manual_seed(4) for _ in range(2))
    torch.testing.assert_close(DS.noisy_init_pose(gen_a, pose),
                               DS.noisy_init_pose(gen_b, pose))


def test_jax_sweep_init_draws_file_is_jaxs():
    """The committed draws are JAX's, regenerated here exactly, and the
    port's ``noisy_init_pose`` of them lies within 1e-6 of JAX's pose."""
    with open(SWEEP_DRAWS) as f:
        saved = json.load(f)
    assert saved == jax_sweep_init_draws()
    gt0 = np.asarray(saved["gt0"], np.float32)
    for s, row in saved["severities"].items():
        draws = {name: {k: torch.tensor(v, dtype=torch.float32)
                        for k, v in row[name].items()}
                 for name in ("dir_t", "dir_r")}
        pose = DS.noisy_init_pose(draws, gt0,
                                  DS.SensorModel().scaled(float(s)))
        np.testing.assert_allclose(pose.numpy(), row["init_pose"], atol=1e-6,
                                   rtol=0)


@pytest.fixture(scope="module")
def zero_head():
    """The zero-head (hold-pose) cube tracker of tests/test_domain_shift.py
    in both packages, with the same Flax weights."""
    tm = M.make_cube(0.08)
    model = jnet.Se3TrackNet(image_size=RES)
    variables = jnet.init_variables(model, jax.random.PRNGKey(0))
    params = variables["params"]
    for head in ("trans_out", "rot_out"):
        params[head]["kernel"] = params[head]["kernel"] * 0.0
        params[head]["bias"] = params[head]["bias"] * 0.0
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    width = tm.diameter * 1000 * 1.1
    jobj = JSB.BenchObject(
        name="cube", tm=tm, mesh=Jrz.upload(tm), model=model,
        variables=variables, mean=jnp.zeros(8), std=jnp.full(8, 100.0),
        width_mm=width, tcfg=jtrk.TrackerConfig(
            resolution=RES, object_width_mm=width, render_impl="xla"))
    net = tracknet.create_model(RES)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    obj = SB.BenchObject(
        name="cube", tm=tm, mesh=rz.upload(tm, "cpu"), model=net.eval(),
        mean=torch.zeros(8), std=torch.full((8,), 100.0), width_mm=width,
        tcfg=trk.TrackerConfig(resolution=RES, object_width_mm=width))
    return jobj, obj


def _recording(module, monkeypatch, sink):
    """Record the health scores of every ``track_video_with_health`` call
    ``module`` makes."""
    fn = module.track_video_with_health

    def wrapped(*a, **kw):
        poses, scores = fn(*a, **kw)
        sink.append(np.asarray(scores.cpu() if torch.is_tensor(scores)
                               else scores))
        return poses, scores

    monkeypatch.setattr(module, "track_video_with_health", wrapped)


MILD = dict(init_trans_m=0.001, init_rot_deg=0.5)
LONG_CASES = {
    # tests/test_domain_shift.py's forced-burst protocols, cut to T=20,
    # chunk 5: a static scene, and a moving one that fires before the burst
    "static_burst": dict(static=True, kw=dict(fail_at=8, fail_len=4),
                         mild=True),
    "moving_burst": dict(static=False, kw=dict(fail_at=12, fail_len=4)),
}


@pytest.mark.parametrize("case", list(LONG_CASES))
def test_long_horizon_eval_matches_jax(zero_head, monkeypatch, case):
    """The closed loop on JAX's re-init draws: re-init frames, detection
    latency, recovery frame and pre-burst flag equal; AUCs within 0.05;
    every chunk's health scores within 1e-3 (the bar of refined poses' scores
    in tests/test_torch_hypotheses.py).
    JAX pads its last chunk, so only the real frames' scores are compared.
    A score within 1e-3 of the threshold could fall on the other side of
    it: such scores must fall on the same side in both packages."""
    jobj, obj = zero_head
    spec = LONG_CASES[case]
    T = 20
    if spec["static"]:
        pose0 = np.eye(4, dtype=np.float32)
        pose0[:3, 3] = [0.0, 0.0, 0.6]
        gt = np.tile(pose0[None], (T, 1, 1))
    else:
        gt = SB.make_gt_trajectory(T)
    rgb, dep = _video(obj.tm, gt)
    sensor = DS.SensorModel(**MILD) if spec.get("mild") else DS.SensorModel()
    jsensor = JDS.SensorModel(**dataclasses.asdict(sensor))
    kw = dict(chunk=5, threshold=0.4, patience=2, **spec["kw"])
    ours_s, ref_s = [], []
    _recording(hy, monkeypatch, ours_s)
    _recording(jhy, monkeypatch, ref_s)
    with jax.disable_jit():
        ref = JDS.long_horizon_eval(jobj, gt, rgb, dep, K,
                                    reinit_sensor=jsensor, **kw)
    ours = DS.long_horizon_eval(obj, gt, rgb, dep, K, reinit_sensor=sensor,
                                reinit_draws=jax_reinit_draws(33), **kw)
    assert ours["reinit_frames"] == ref["reinit_frames"]
    assert ours["reinit_count"] == ref["reinit_count"]
    assert ours["frames"] == ref["frames"] == T - 1
    for k in ("add_auc", "adi_auc"):
        assert abs(ours[k] - ref[k]) < 0.05, k
    assert len(ours_s) == len(ref_s)
    for a, b in zip(ours_s, ref_s):
        b = b[:len(a)]
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
        near = np.abs(a - kw["threshold"]) <= 1e-3
        np.testing.assert_array_equal((a < kw["threshold"])[near],
                                      (b < kw["threshold"])[near])
    if "fail_at" in kw:
        for k in ("detection_latency", "recovered_at", "pre_burst_trigger",
                  "fail_at", "fail_len"):
            assert ours[k] == ref[k], k
        assert ours["recovered"] == (ref["recovered_at"] is not None)
        if ours["recovered"]:
            assert abs(ours["post_recovery_add_auc"]
                       - ref["post_recovery_add_auc"]) < 0.05
        else:
            assert ours["post_recovery_add_auc"] is None
    if case == "static_burst":
        # tests/test_domain_shift.py's assertions, at this cut
        assert ours["detection_latency"] <= 4
        assert ours["recovered_at"] >= 12
        assert ours["post_recovery_add_auc"] > 90.0
    if case == "moving_burst":
        # an organic fire re-anchors before the burst
        assert any(f < 12 for f in ours["reinit_frames"])


LIVE_CASES = {
    # tests/test_domain_shift.py: recovery after the burst
    "recovers": (50, dict(fail_at=20, fail_len=10)),
    # the burst runs to the last frame: nothing can recover
    "no_recovery": (30, dict(fail_at=20, fail_len=20)),
}


@pytest.mark.parametrize("case", list(LIVE_CASES))
def test_live_recovery_eval(zero_head, case):
    """The live path on the port alone (tests/test_domain_shift.py's
    assertions), each fetch awaited after its push so the run does not
    depend on the fetch thread's timing. Every row says ``recovered`` and
    has the post-recovery keys: None, never nan, when nothing recovered."""
    _, obj = zero_head
    T, burst = LIVE_CASES[case]
    gt = SB.make_gt_trajectory(T)
    rgb, dep = _video(obj.tm, gt)
    kw = dict(samples=2, threshold=0.4, patience=2, refetch_every=2,
              reinit_sensor=DS.SensorModel(**MILD), pace_hz=None,
              sync_fetches=True, **burst)
    r = DS.live_recovery_eval(obj, gt, rgb, dep, K, **kw)
    assert r["frames"] == T - 1
    assert r["track_lost_events"] >= 1
    assert r["detection_latency"] is not None
    assert r["detection_latency"] >= 1
    assert np.isfinite(r["add_auc"]) and np.isfinite(r["adi_auc"])
    assert {"recovered", "post_recovery_add_auc",
            "post_recovery_adi_auc"} <= r.keys()
    numbers = [v for v in r.values() if isinstance(v, float)]
    assert np.isfinite(numbers).all()
    if case == "recovers":
        assert r["recovered"] is True
        assert r["recovered_at"] >= 30          # after the burst clears
        assert np.isfinite(r["post_recovery_add_auc"])
        assert np.isfinite(r["post_recovery_adi_auc"])
        # the same run again gives the same row (the fetches awaited)
        assert DS.live_recovery_eval(obj, gt, rgb, dep, K, **kw) == r
    else:
        assert r["recovered"] is False and r["recovered_at"] is None
        assert r["post_recovery_add_auc"] is None
        assert r["post_recovery_adi_auc"] is None
        assert "not recovered" in SB.recovery_auc_text(r)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(os.path.dirname(SWEEP_DRAWS), exist_ok=True)
    with open(SWEEP_DRAWS, "w") as f:
        json.dump(jax_sweep_init_draws(), f, indent=1)
        f.write("\n")
