"""The port's adaptive dispatcher (``tracking/dispatch.py``) on the scene of
tests/test_dispatch.py: an icosphere drifting across 64x64 frames, a 64^2
ROI.

Every dispatch granularity runs the same eager step, so every mode and every
mix of modes gives the bits of the port's ``track_video`` (JAX's test holds
its modes to 1e-5), at samples 4 too, since the port keys the hypotheses'
draws by frame index in every mode (JAX's modes draw differently). The
adaptive poses follow JAX's ``track_video`` within the bars of
tests/test_torch_tracker.py. A mode slowed mid-video triggers a reprobe that
keeps the other modes' samples.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.models import tracknet as jnet
from iros20_6d_pose_tracking_tpu.render import mesh as JM
from iros20_6d_pose_tracking_tpu.render import rasterizer as JRz
from iros20_6d_pose_tracking_tpu.tracking import tracker as jtrk
from iros20_6d_pose_tracking_tpu_torch.models import convert, tracknet
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
from iros20_6d_pose_tracking_tpu_torch.tracking import hypotheses as hy
from iros20_6d_pose_tracking_tpu_torch.tracking import dispatch
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
from iros20_6d_pose_tracking_tpu_torch.tracking.dispatch import (
    AdaptiveVideoTracker)

torch.set_num_threads(2)

RES = 64
K = np.array([[300.0, 0, 32.0], [0, 300.0, 32.0], [0, 0, 1.0]], np.float32)
WIDTH_MM = 110.0


def _net():
    """A seeded network with its regression heads scaled by 0.05 (zero
    bias), so the track stays on the object."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = tracknet.create_model(RES)
    with torch.no_grad():
        for head in (net.trans_out, net.rot_out):
            head[0].weight.mul_(0.05)
            head[0].bias.zero_()
    return net.eval()


def _tracker():
    mesh = rz.upload(M.make_icosphere(subdiv=2, radius=0.05), "cpu")
    cfg = trk.TrackerConfig(resolution=RES, object_width_mm=WIDTH_MM)
    return trk.Tracker.from_parts(_net(), cfg, mesh, K, np.zeros(8),
                                  np.ones(8) * 100.0)


@pytest.fixture(scope="module")
def tracker():
    return _tracker()


@pytest.fixture(scope="module")
def frames(tracker):
    """32 distinct frames: the object rendered along a small drift, so
    per-frame poses evolve and chunk boundaries matter."""
    rgbs, deps = [], []
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, 0.5]
    for i in range(32):
        p = pose.copy()
        p[0, 3] += 0.0004 * i
        rgb, dep = rz.render(tracker.mesh, torch.from_numpy(p), tracker.K,
                             rz.full_frame_window(RES, RES),
                             out_hw=(RES, RES))
        rgbs.append(torch.clamp(torch.round(rgb), 0, 255).to(
            torch.uint8).numpy())
        deps.append(torch.round(dep).numpy().astype(np.uint16))
    return np.stack(rgbs), np.stack(deps), pose


def _video(frames, T):
    rgbs, deps, pose0 = frames
    return rgbs[:T], deps[:T], pose0


@pytest.fixture(scope="module")
def ref(tracker, frames):
    """The port's track_video over all 32 frames (a prefix of it is the
    reference of a shorter video)."""
    rgbs, deps, pose0 = frames
    return tracker.track_video(pose0, rgbs, deps)


def test_adaptive_matches_plain_scan(tracker, frames, ref):
    """Probe segments in every candidate mode, then steady state: the poses
    of one whole-video track_video, bit for bit."""
    rgbs, deps, pose0 = _video(frames, 20)
    d = AdaptiveVideoTracker(tracker, candidates=(8, 4, 1), probe_frames=4)
    poses, scores = d.track(pose0, rgbs, deps, chunk_size=8)
    assert poses.shape == (20, 4, 4) and scores is None
    assert set(d.probe_ms_per_frame) == {8, 4, 1}
    assert d.mode == min(d.probe_ms_per_frame, key=d.probe_ms_per_frame.get)
    assert len(d.segments) >= 3
    np.testing.assert_array_equal(poses, ref[:20])


def test_adaptive_via_tracker_api(tracker, frames, ref):
    rgbs, deps, pose0 = _video(frames, 12)
    poses, tel = tracker.track_video_adaptive(
        pose0, rgbs, deps, chunk_size=4, candidates=(4, 1))
    assert poses.shape == (12, 4, 4) and "scores" not in tel
    assert set(tel["probe_ms_per_frame"]) == {4, 1}
    assert tel["mode"] in (4, 1) and tel["settled"]
    np.testing.assert_array_equal(poses, ref[:12])


def test_adaptive_survives_constant_reprobing(tracker, frames, ref):
    """reprobe_factor below 1 re-probes after nearly every steady segment:
    switching modes mid-video is output-neutral, and the churn shows in the
    telemetry."""
    rgbs, deps, pose0 = _video(frames, 24)
    d = AdaptiveVideoTracker(tracker, candidates=(8, 1), probe_frames=4,
                             reprobe_factor=0.5)
    poses, _ = d.track(pose0, rgbs, deps, chunk_size=8)
    np.testing.assert_array_equal(poses, ref[:24])
    assert d.reprobes >= 1


def test_adaptive_multi_hypothesis(tracker, frames):
    """samples 4: every mode gives the bits of
    hypotheses.track_video_multi(first_frame=0), poses and health scores
    (frame g draws from a generator seeded seed + g in every mode)."""
    T = 13
    rgbs, deps, pose0 = _video(frames, T)
    want_p, want_s = hy.track_video_multi(
        tracker.model, tracker.cfg, tracker.mesh, tracker.K, tracker.mean,
        tracker.std, torch.from_numpy(pose0), trk.upload_rgb(rgbs, "cpu"),
        trk.upload_depth(deps, "cpu"), samples=4)
    d = AdaptiveVideoTracker(tracker, candidates=(4, 0, 1), probe_frames=4,
                             samples=4)
    poses, scores = d.track(pose0, rgbs, deps, chunk_size=12)
    assert scores.shape == (T,) and np.isfinite(scores).all()
    # a 4-frame scan, the stream's 8 pushes, one per-frame step
    assert [m for m, *_ in d.segments] == [4, 0, 1], d.segments
    np.testing.assert_array_equal(poses, want_p.numpy())
    np.testing.assert_array_equal(scores, want_s.numpy())
    d1 = AdaptiveVideoTracker(tracker, candidates=(1,), samples=4, seed=11)
    poses, scores = d1.track(want_p[10].numpy(), rgbs[11:], deps[11:],
                             chunk_size=2)
    np.testing.assert_array_equal(poses, want_p[11:].numpy())
    np.testing.assert_array_equal(scores, want_s[11:].numpy())


def test_adaptive_short_video_and_tail(tracker, frames, ref):
    """A video shorter than one chunk, a tail that is no multiple of any
    candidate: exactly T poses, the last chunk not padded."""
    rgbs, deps, pose0 = _video(frames, 5)
    d = AdaptiveVideoTracker(tracker, candidates=(4, 1), probe_frames=4)
    poses, _ = d.track(pose0, rgbs, deps, chunk_size=8)
    assert poses.shape == (5, 4, 4)
    assert sum(n for _, n, *_ in d.segments) == 5
    np.testing.assert_array_equal(poses, ref[:5])


def test_adaptive_stream_candidate_parity(tracker, frames, ref):
    """Candidate 0, the windowed StreamTracker over the host chunk: the
    stream's poses are track_video's bits, so a stream steady phase leaves
    the trajectory as it was."""
    rgbs, deps, pose0 = _video(frames, 32)
    d = AdaptiveVideoTracker(tracker, candidates=(4, 0), probe_frames=4)
    poses, _ = d.track(pose0, rgbs, deps, chunk_size=8)
    assert poses.shape == (32, 4, 4)
    assert set(d.probe_ms_per_frame) == {4, 0} and d.mode in (4, 0)
    assert 0 in {m for m, *_ in d.segments}
    np.testing.assert_array_equal(poses, ref)
    forced = AdaptiveVideoTracker(tracker, candidates=(0,), probe_frames=4)
    poses, _ = forced.track(pose0, rgbs[:16], deps[:16], chunk_size=8)
    assert {m for m, *_ in forced.segments} == {0} and forced.settled
    np.testing.assert_array_equal(poses, ref[:16])


def test_adaptive_resident_fast_path(tracker, frames, ref):
    """Sources already tensors on the device: the whole video is one chunk,
    candidates may exceed any chunk_size, and the stream is refused."""
    rgbs, deps, pose0 = _video(frames, 16)
    d = AdaptiveVideoTracker(tracker, candidates=(16, 1), probe_frames=4)
    poses, _ = d.track(pose0, trk.upload_rgb(rgbs, "cpu"),
                       trk.upload_depth(deps, "cpu"))
    assert poses.shape == (16, 4, 4)
    np.testing.assert_array_equal(poses, ref[:16])
    with pytest.raises(ValueError, match="host sources"):
        AdaptiveVideoTracker(tracker, candidates=(4, 0)).track(
            pose0, torch.from_numpy(rgbs), torch.from_numpy(deps))


def test_reprobe_keeps_the_other_modes_samples(tracker, frames, ref,
                                               monkeypatch):
    """The per-frame mode's one-frame probe is slowed, and the scan mode is
    slowed once it has run a steady segment: the dispatcher settles on the
    scan, re-probes when it collapses, keeps the per-frame sample in the
    table until that mode is measured again, and settles on the per-frame
    mode. The poses do not change.

    The dispatcher's clock is a fake one that only the segments advance:
    every frame costs 1 ms in either mode, and a slowed segment costs more,
    so no stall of the host can change a decision."""
    rgbs, deps, pose0 = _video(frames, 32)
    d = AdaptiveVideoTracker(tracker, candidates=(4, 1), probe_frames=4)
    scan, per_frame = d._run_scan, d._run_per_frame
    tables = []  # the table as each per-frame segment starts
    now = [0.0]  # the fake clock, s
    frame_s = 1e-3
    monkeypatch.setattr(dispatch, "time",
                        types.SimpleNamespace(perf_counter=lambda: now[0]))

    def steady_seen():
        return any(ph == "steady" for *_, ph in d.segments)

    def scan_sample_s():  # the scan's first probe, s a frame
        return d.segments[0][2] / 1e3

    def slow_scan(pose, buf, sbuf, rgb, dep, a, b, c, g0):
        out = scan(pose, buf, sbuf, rgb, dep, a, b, c, g0)
        now[0] += frame_s * (b - a)
        if steady_seen():  # 4x its sample: past reprobe_factor 2
            now[0] += 3 * scan_sample_s() * (b - a)
        return out

    def slow_per_frame(pose, buf, sbuf, rgb, dep, a, b, g0):
        tables.append(dict(d.probe_ms_per_frame))
        out = per_frame(pose, buf, sbuf, rgb, dep, a, b, g0)
        now[0] += frame_s * (b - a)
        if b - a == 1 and d.segments and not steady_seen():  # not warm-up
            now[0] += 4 * scan_sample_s()  # past the 3x cutoff
        return out

    monkeypatch.setattr(d, "_run_scan", slow_scan)
    monkeypatch.setattr(d, "_run_per_frame", slow_per_frame)
    poses, _ = d.track(pose0, rgbs, deps, chunk_size=8)
    steady = [m for m, n, ms, ph in d.segments if ph == "steady"]
    assert steady[0] == 4 and steady[-1] == 1, d.segments
    assert d.reprobes == 1 and d.mode == 1 and d.settled, d.telemetry()
    assert set(d.probe_ms_per_frame) == {4, 1}
    # segments: scan probe1, per-frame probe1 (hopeless), fill, scan steady
    # x2 (the second collapses), per-frame probe1 again ...
    first_sample = d.segments[1][2]
    again = [i for i, (m, n, ms, ph) in enumerate(d.segments)
             if ph == "probe1" and m == 1][1]
    assert {4: d.segments[again - 1][2], 1: first_sample} in tables
    np.testing.assert_array_equal(poses, ref)


def test_adaptive_follows_jax_track_video(tracker, frames):
    """The port's adaptive poses against JAX's track_video (Pallas kernels
    in interpret mode, fused pass 2) with the same weights on the same
    frames: per frame within 5e-4 m and 5e-3 rad, the bars of
    tests/test_torch_tracker.py."""
    T = 8
    rgbs, deps, pose0 = _video(frames, T)
    model = jnet.create_model(RES)
    variables = convert.state_dict_to_variables(tracker.model.state_dict())
    jcfg = jtrk.TrackerConfig(resolution=RES, object_width_mm=WIDTH_MM,
                              render_impl="pallas_interpret", fuse_pass2=True)
    want = np.asarray(jtrk.track_video(
        model, jcfg, variables,
        JRz.upload(JM.make_icosphere(subdiv=2, radius=0.05)), jnp.asarray(K),
        jnp.zeros(8), jnp.ones(8) * 100.0, jnp.asarray(pose0),
        jnp.asarray(rgbs), jnp.asarray(deps)))
    d = AdaptiveVideoTracker(tracker, candidates=(4, 1, 0), probe_frames=2)
    poses, _ = d.track(pose0, rgbs, deps, chunk_size=4)
    assert np.linalg.norm(poses[-1, :3, 3] - pose0[:3, 3]) > 1e-4
    for i in range(T):
        np.testing.assert_allclose(poses[i, :3, 3], want[i, :3, 3],
                                   atol=5e-4, err_msg=f"frame {i}")
        R = poses[i, :3, :3].astype(np.float64).T @ want[i, :3, :3]
        w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                      R[1, 0] - R[0, 1]])
        assert np.arcsin(min(np.linalg.norm(w) / 2, 1.0)) < 5e-3, i
