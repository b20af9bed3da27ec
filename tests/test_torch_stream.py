"""The port's live tracking path (``tracking/stream.py``): the packed window
bytes and the host ROI geometry against the JAX package's numpy code, the
windowed and full-frame stream bit-equal to the port's ``track_video``, the
stream against JAX's ``StreamTracker`` (Pallas kernels in interpret mode),
samples > 1 against the ``on_track(samples=N)`` loop, and the generation
guard, history, re-init, containment and closed-loop paths. The scene is
tests/test_torch_tracker.py's: a 0.08 m cube, a 64^2 ROI, 192x256 frames,
small regression heads."""
import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.models import tracknet as jnet
from iros20_6d_pose_tracking_tpu.render import mesh as JM
from iros20_6d_pose_tracking_tpu.render import rasterizer as JRz
from iros20_6d_pose_tracking_tpu.tracking import stream as jst
from iros20_6d_pose_tracking_tpu.tracking import tracker as jtrk
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.models.convert import (
    state_dict_from_jax)
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as TRz
from iros20_6d_pose_tracking_tpu_torch.tracking import stream as st
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
from iros20_6d_pose_tracking_tpu_torch.tracking.hypotheses import (
    ReinitPolicy)

torch.set_num_threads(2)

RES = 64
H, W = 192, 256
K = np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1.0]], np.float32)
WIDTH_MM = 110.0


def _rot_angle(Ra, Rb):
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
    for head in ("trans_out", "rot_out"):
        params[head]["kernel"] = params[head]["kernel"] * 0.05
        params[head]["bias"] = params[head]["bias"] * 0.0
    variables = {"params": params, "batch_stats": stats}
    tm = M.make_cube(0.08)
    gt = np.eye(4, dtype=np.float32)
    gt[:3, 3] = [0.01, -0.005, 0.55]
    rgb, depth = TRz.render(TRz.upload(tm, "cpu"), torch.as_tensor(gt),
                            torch.as_tensor(K), TRz.full_frame_window(W, H),
                            out_hw=(H, W), cull_backfaces=True)
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.0, 0.0, 0.5]
    net = tracknet.create_model(RES)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    cfg = trk.TrackerConfig(resolution=RES, object_width_mm=WIDTH_MM,
                            cull_backfaces=True)
    parts = (net.eval(), cfg, TRz.upload(tm, "cpu"), K, mean, std)
    jcfg = jtrk.TrackerConfig(resolution=RES, object_width_mm=WIDTH_MM,
                              render_impl="pallas_interpret",
                              cull_backfaces=True, fuse_pass2=True)
    jtracker = jtrk.Tracker.from_parts(model, jcfg, variables,
                                       JRz.upload(JM.make_cube(0.08)), K,
                                       mean, std)
    return dict(parts=parts, jtracker=jtracker, init=init, gt=gt,
                rgb=rgb.numpy().astype(np.uint8),
                depth=depth.numpy().astype(np.uint16))


def _tracker(scene):
    """A fresh port Tracker (frame_cnt 0) on the scene's parts."""
    return trk.Tracker.from_parts(*scene["parts"])


def _still_tracker(scene):
    """A fresh port Tracker whose regression heads are zero: it holds its
    pose, so the health score stays high on the scene's frame."""
    net, *rest = scene["parts"]
    net = copy.deepcopy(net)
    with torch.no_grad():
        for head in (net.trans_out, net.rot_out):
            head[0].weight.zero_()
    return trk.Tracker.from_parts(net, *rest)


def _video(scene, n):
    return (np.stack([scene["rgb"]] * n), np.stack([scene["depth"]] * n))


def _drain(s):
    """Wait for the stream's background fetch, if one is running."""
    if s._fetch_future is not None:
        s._fetch_future.result(timeout=60)


def test_pack_window_bytes_equal_jax():
    rng = np.random.RandomState(0)
    for shape in ((32, 32), (48, 64)):
        rgb = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
        depth = rng.randint(0, 65536, shape).astype(np.uint16)
        packed = st.pack_window(rgb, depth)
        want = jst.pack_window(rgb, depth)
        assert packed.dtype == np.uint8 and packed.shape == shape + (5,)
        assert packed.tobytes() == want.tobytes()
        # strided views of a bigger frame pack the same bytes
        big_rgb = rng.randint(0, 256, (80, 90, 3)).astype(np.uint8)
        big_d = rng.randint(0, 65536, (80, 90)).astype(np.uint16)
        win = (slice(7, 7 + shape[0]), slice(11, 11 + shape[1]))
        assert st.pack_window(big_rgb[win], big_d[win]).tobytes() == \
            jst.pack_window(big_rgb[win], big_d[win]).tobytes()
        u_rgb, u_depth = st.unpack_window(torch.from_numpy(packed))
        assert u_depth.dtype == torch.int32
        np.testing.assert_array_equal(u_rgb.numpy(), rgb)
        np.testing.assert_array_equal(
            u_depth.numpy(), trk.upload_depth(depth, "cpu").numpy())


def _geometry_pair(**kw):
    """A port and a JAX StreamTracker over stub trackers (the geometry reads
    only K and the object width), at 480x640."""
    cfg = types.SimpleNamespace(object_width_mm=180.0)
    Kp = np.array([[1066.778, 0, 312.9869], [0, 1067.487, 241.3109],
                   [0, 0, 1]], np.float32)
    port = st.StreamTracker(types.SimpleNamespace(
        K=torch.as_tensor(Kp), cfg=cfg, device=torch.device("cpu")), **kw)
    ref = jst.StreamTracker(types.SimpleNamespace(K=Kp, cfg=cfg), **kw)
    for s in (port, ref):
        s._hw = (480, 640)
    return port, ref


@pytest.mark.parametrize("fn", ["host_bbox", "bucket", "predicted_center",
                                "roi_escaped"])
def test_host_geometry_equals_jax(fn):
    rng = np.random.RandomState(1)
    if fn == "host_bbox":
        port, ref = _geometry_pair()
        for _ in range(200):
            pose = np.eye(4, dtype=rng.choice([np.float32, np.float64]))
            pose[:3, 3] = rng.uniform([-0.2, -0.2, -0.1], [0.2, 0.2, 1.5])
            assert port._host_bbox(pose) == ref._host_bbox(pose)
    elif fn == "bucket":
        for kw in ({}, {"margin": 1.45}, {"refetch_every": 3,
                                          "base_pad_px": 10.0}):
            port, ref = _geometry_pair(**kw)
            for _ in range(300):  # one hysteresis state over the sequence
                if rng.rand() < 0.3:
                    i0 = int(rng.randint(0, 50))
                    hist = [(i0, rng.uniform(0, 480, 2)),
                            (i0 + int(rng.randint(0, 9)),
                             rng.uniform(0, 480, 2))]
                    for s in (port, ref):
                        s._center_hist.clear()
                        s._center_hist.extend(hist)
                if rng.rand() < 0.05:
                    port._pad_boost = ref._pad_boost = ref._pad_boost + 16.0
                side = float(rng.uniform(20.0, 700.0))
                assert port._bucket(side) == ref._bucket(side)
                assert port._vel_px() == ref._vel_px()
        port, _ = _geometry_pair(margin=1.45)
        assert port._bucket(196.0) == 320
        port, _ = _geometry_pair()
        static = port._bucket(196.0)
        assert static % 32 == 0 and static <= 288
        port._center_hist.extend([(0, np.array([100.0, 100.0])),
                                  (8, np.array([100.0, 180.0]))])
        port._cur_bucket = None
        assert port._bucket(196.0) > static
        port._center_hist.clear()
        port._pad_boost, port._cur_bucket = 48.0, None
        assert port._bucket(196.0) > static
    elif fn == "predicted_center":
        port, ref = _geometry_pair()
        for _ in range(200):
            hist = [(int(i), rng.uniform(0, 640, 2))
                    for i in sorted(rng.randint(0, 40, 2))]
            frame = int(rng.randint(0, 80))
            centre = tuple(rng.uniform(0, 480, 2))
            for s in (port, ref):
                s._center_hist.clear()
                s._center_hist.extend(hist[:int(rng.randint(0, 3))]
                                      if s is port else [])
            ref._center_hist.extend(port._center_hist)
            port._frame_idx = ref._frame_idx = frame
            port._center_vu = ref._center_vu = centre
            assert port._predicted_center() == ref._predicted_center()
    else:
        port, ref = _geometry_pair()
        for _ in range(500):
            vu = tuple(rng.uniform(-100, 700, 2))
            side = float(rng.uniform(10, 400))
            rect = (int(rng.randint(0, 300)), int(rng.randint(0, 400)),
                    int(rng.choice([128, 160, 256, 320])))
            assert port._roi_escaped(vu, side, rect) == \
                ref._roi_escaped(vu, side, rect)
        assert not port._roi_escaped((228.0, 228.0), 200.0, (100, 100, 256))
        assert port._roi_escaped((228.0, 330.0), 200.0, (100, 100, 256))
        assert not port._roi_escaped((10.0, 10.0), 200.0, (0, 0, 256))


@pytest.mark.parametrize("window", [True, False])
def test_stream_equals_track_video(scene, window):
    """The windowed (packed window, device offset, background refetches)
    and the full-frame stream give track_video's bits while the ROI stays
    inside the window."""
    t = _tracker(scene)
    n = 8
    rgbs, depths = _video(scene, n)
    want = t.track_video(scene["init"], rgbs, depths)
    s = st.StreamTracker(t, window=window, refetch_every=2)
    s.begin(scene["init"], image_hw=(H, W))
    for i in range(n):
        s.push(rgbs[i], depths[i])
        _drain(s)
    got = s.poses()
    s.close()
    assert got.shape == (n, 4, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(s.current_pose(), want[-1])
    np.testing.assert_array_equal(s.poses(include_init=True)[0],
                                  scene["init"])
    stats = s.stats()
    assert stats["containment_violations"] == 0
    if window:
        assert stats["refetches"] >= 2 and s._center_frame > 0
        assert stats["bucket"] < min(H, W) and stats["compiled_programs"] >= 1
    else:
        assert stats["refetches"] == 0 and stats["compiled_programs"] == 1


def test_stream_follows_jax_stream(scene):
    """Four windowed pushes against JAX's StreamTracker on the same frames:
    within 5e-4 m and 5e-3 rad per frame, the same window."""
    n = 4
    ref = jst.StreamTracker(scene["jtracker"], window=True)
    ref.begin(scene["init"], image_hw=(H, W))
    s = st.StreamTracker(_tracker(scene), window=True)
    s.begin(scene["init"], image_hw=(H, W))
    for _ in range(n):
        ref.push(scene["rgb"], scene["depth"])
        s.push(scene["rgb"], scene["depth"])
    got, want = s.poses(), ref.poses()
    s.close()
    assert np.linalg.norm(got[-1, :3, 3] - scene["init"][:3, 3]) > 1e-4
    np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], atol=5e-4)
    assert max(_rot_angle(a[:3, :3], b[:3, :3])
               for a, b in zip(got, want)) < 5e-3
    assert s.stats() == ref.stats()
    assert s._rect_hist == ref._rect_hist


def test_stream_reinit_poisons_inflight_snapshot(scene):
    """A background fetch submitted before begin()/set_pose() must not
    recentre the window after re-initialization (tests/test_stream.py's
    generation guard)."""
    s = st.StreamTracker(_tracker(scene), window=True, refetch_every=1)
    s.begin(scene["init"], image_hw=(H, W))
    old_gen = s._gen
    s.begin(scene["init"], image_hw=(H, W))
    s._pending_center = (old_gen, 999, ((0.0, 0.0), 50.0))
    s.push(scene["rgb"], scene["depth"])
    assert s._center_frame == 0
    assert s._center_vu != (0.0, 0.0)
    _drain(s)
    s._pending_center = (s._gen, 1, ((5.0, 6.0), 60.0))
    s.push(scene["rgb"], scene["depth"])
    assert s._center_frame == 1 and s._center_vu == (5.0, 6.0)
    s.close()


def test_stream_no_history_and_set_pose(scene):
    """keep_history=False keeps only the latest device pose and score;
    set_pose mid-stream equals a fresh stream begun at that pose."""
    s = st.StreamTracker(_tracker(scene), window=True, keep_history=False,
                         samples=2)
    s.begin(scene["init"], image_hw=(H, W))
    for _ in range(3):
        s.push(scene["rgb"], scene["depth"])
    assert len(s._poses) == 1 and s.poses().shape == (0, 4, 4)
    assert s.scores().shape == (1,)
    assert np.isfinite(s.current_pose()).all()
    s.close()

    reinit = np.eye(4, dtype=np.float32)
    reinit[:3, 3] = [0.01, 0.0, 0.52]
    s = st.StreamTracker(_tracker(scene), window=True)
    s.begin(scene["init"], image_hw=(H, W))
    s.push(scene["rgb"], scene["depth"])
    gen = s._gen
    s.set_pose(reinit)
    assert s._gen == gen + 1 and s._center_frame == 1
    s.push(scene["rgb"], scene["depth"])
    s2 = st.StreamTracker(_tracker(scene), window=True)
    s2.begin(reinit, image_hw=(H, W))
    s2.push(scene["rgb"], scene["depth"])
    np.testing.assert_array_equal(s.poses()[-1], s2.poses()[-1])
    s.close()
    s2.close()


def test_stream_samples_equal_on_track_loop(scene):
    """samples=4: the stream's winners and scores are the bits of the
    Tracker.on_track(samples=4) loop over the same frames (both seed frame
    i's draws with i)."""
    n = 4
    t = _tracker(scene)
    pose, want, want_scores = scene["gt"], [], []
    for _ in range(n):
        pose = t.on_track(pose, scene["rgb"], scene["depth"], samples=4)
        want.append(pose)
        want_scores.append(t.last_score)
    s = st.StreamTracker(_tracker(scene), window=True, samples=4)
    s.begin(scene["gt"], image_hw=(H, W))
    for _ in range(n):
        s.push(scene["rgb"], scene["depth"])
    np.testing.assert_array_equal(s.poses(), np.stack(want))
    np.testing.assert_array_equal(s.scores(),
                                  np.asarray(want_scores, np.float32))
    scores = s.scores()
    assert scores[0] > 0.5 and ((scores >= 0) & (scores <= 1)).all()
    s.begin(scene["init"], image_hw=(H, W))
    assert s.scores().shape == (0,)
    s.close()


def test_stream_first_frame_seeds_draws(scene):
    """begin(first_frame=k) at samples 4: push i draws with seed k + i, so
    the stream gives the bits of on_track(samples=4) from frame_cnt = k."""
    k, n = 5, 2
    t = _tracker(scene)
    t.frame_cnt = k
    pose, want, want_scores = scene["gt"], [], []
    for _ in range(n):
        pose = t.on_track(pose, scene["rgb"], scene["depth"], samples=4)
        want.append(pose)
        want_scores.append(t.last_score)
    s = st.StreamTracker(_tracker(scene), window=True, samples=4)
    s.begin(scene["gt"], image_hw=(H, W), first_frame=k)
    for _ in range(n):
        s.push(scene["rgb"], scene["depth"])
    np.testing.assert_array_equal(s.poses(), np.stack(want))
    np.testing.assert_array_equal(s.scores(),
                                  np.asarray(want_scores, np.float32))
    s.close()


def test_stream_containment_violation(scene):
    """A teleported device pose is caught by the background containment
    check (tests/test_stream.py's case): counted, and the pad widened."""
    s = st.StreamTracker(_tracker(scene), window=True, refetch_every=1)
    s.begin(scene["init"], image_hw=(H, W))
    s.push(scene["rgb"], scene["depth"])
    tele = np.eye(4, dtype=np.float32)
    tele[:3, 3] = [0.2, 0.15, 0.5]
    s._pose_dev = torch.from_numpy(tele)
    for _ in range(4):
        s.push(scene["rgb"], scene["depth"])
        _drain(s)
    s.close()
    stats = s.stats()
    assert stats["refetches"] >= 1
    assert stats["containment_violations"] >= 1
    assert stats["pad_boost_px"] >= 16.0


def test_stream_closed_loop_reinit(scene):
    """samples >= 2 and a ReinitPolicy close the failure loop: black frames
    collapse the health score, the policy fires on the fetch thread, and
    the pose the callback returns is applied by the next push."""
    calls = []
    redetected = scene["gt"].copy()

    def on_lost(idx, score):
        calls.append((idx, score))
        return redetected

    s = st.StreamTracker(_still_tracker(scene), window=True, samples=2,
                         refetch_every=1,
                         reinit_policy=ReinitPolicy(patience=2),
                         on_track_lost=on_lost)
    s.begin(scene["gt"], image_hw=(H, W))
    for _ in range(3):
        s.push(scene["rgb"], scene["depth"])
        _drain(s)
    assert s.track_lost_events == 0
    black_rgb = np.zeros_like(scene["rgb"])
    black_depth = np.zeros_like(scene["depth"])
    gen = s._gen
    for _ in range(8):
        s.push(black_rgb, black_depth)
        _drain(s)
        if s._gen > gen:
            break
    s.close()
    assert s.track_lost_events >= 1
    assert calls and calls[0][1] < 0.3
    assert s._gen > gen  # the returned pose was applied through set_pose
    assert s.stats()["track_lost_events"] == s.track_lost_events
    with pytest.raises(ValueError):
        st.StreamTracker(_tracker(scene), samples=1,
                         reinit_policy=ReinitPolicy())
