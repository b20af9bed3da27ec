"""The port's spans and counters (``utils/profiling.py``) on the CPU: nothing
is recorded while recording is off; ``on_track``, ``track_video`` and
``train_step`` give their span trees with request ids; self time; upload
bytes counted only towards a CUDA device; the spans' clock against their
own events in the profiler's trace; and the benchmark's span readers
(``portbench/metrics/*``) on hand-made span lists."""
import os
import runpy
import time

import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
from iros20_6d_pose_tracking_tpu_torch.tracking import compiled
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr
from iros20_6d_pose_tracking_tpu_torch.utils import profiling

torch.set_num_threads(2)

RES = 48
H, W = 96, 128
K = np.array([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1.0]], np.float32)
CPU = torch.device("cpu")
METRICS = os.path.join(os.path.dirname(__file__), os.pardir, "portbench",
                       "metrics")


@pytest.fixture(autouse=True)
def no_spans():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def scene():
    torch.manual_seed(0)
    tm = M.make_cube(0.08)
    gt = np.eye(4, dtype=np.float32)
    gt[:3, 3] = [0.005, -0.003, 0.55]
    rgb, depth = rz.render(rz.upload(tm, CPU), torch.as_tensor(gt),
                           torch.as_tensor(K), rz.full_frame_window(W, H),
                           out_hw=(H, W), cull_backfaces=True)
    net = tracknet.Se3TrackNet(RES).eval()
    cfg = trk.TrackerConfig(resolution=RES, object_width_mm=110.0,
                            cull_backfaces=True)
    t = trk.Tracker.from_parts(net, cfg, rz.upload(tm, CPU), K,
                               np.zeros(8, np.float32),
                               np.full(8, 100.0, np.float32))
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.0, 0.0, 0.55]
    return dict(t=t, init=init, rgb=rgb.numpy().astype(np.uint8),
                depth=depth.numpy().astype(np.uint16))


def _children(rec, i):
    return [s["name"] for s in rec if s["parent"] == i]


def test_nothing_recorded_while_off(scene):
    a, b = profiling.span("a"), profiling.span("b", device=True)
    assert a is b is profiling._NO_SPAN
    with a as s:
        s.add("bytes", 3)
    scene["t"].on_track(scene["init"], scene["rgb"], scene["depth"])
    assert profiling.spans() == []


def test_on_track_span_tree(scene):
    t = scene["t"]
    pose = t.on_track(scene["init"], scene["rgb"], scene["depth"])  # warm
    first = t.frame_cnt
    before = profiling.counters()
    with profiling.recording():
        for _ in range(2):
            pose = t.on_track(pose, scene["rgb"], scene["depth"])
    rec = profiling.spans()
    roots = [i for i, s in enumerate(rec) if s["parent"] is None]
    assert [rec[i]["name"] for i in roots] == ["tracker.on_track"] * 2
    for k, i in enumerate(roots):
        # the card replays where the CPU runs the step eagerly
        assert _children(rec, i) == [
            "tracker.prepare", "tracker.upload", "compiled.key",
            "compiled.load", "compiled.eager", "tracker.fetch"]
        tree = [s for s in rec if s["parent"] == i]
        assert all(s["request"] == first + k for s in tree + [rec[i]])
        # no CUDA upload; the step's 17 convolutions read held weights
        assert all(s["counts"] == ({"layout_held": 17} if s["name"] ==
                                   "compiled.eager" else {}) for s in tree)
        assert all(s["thread"] == rec[i]["thread"] for s in tree)
        for s in tree:
            assert rec[i]["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= rec[i]["end_ns"]
    after = profiling.counters()
    for name in ("upload.pageable_bytes", "upload.pinned_bytes",
                 "compiled.captures"):
        assert after[name] == before[name]
    assert after["compiled.eager_calls"] >= before["compiled.eager_calls"] + 2


def test_track_video_span_tree(scene):
    t = scene["t"]
    T = 3
    rgb = trk.upload_rgb(np.stack([scene["rgb"]] * T), CPU)
    depth = trk.upload_depth(np.stack([scene["depth"]] * T), CPU)
    init = torch.as_tensor(scene["init"])
    args = (t.model, t.cfg, t.mesh, t.K, t.mean, t.std, init, rgb, depth)
    with profiling.recording():
        trk.track_video(*args)
        trk.track_video(*args)
    rec = profiling.spans()
    roots = [i for i, s in enumerate(rec) if s["parent"] is None]
    assert [rec[i]["name"] for i in roots] == ["tracker.track_video"] * 2
    for i in roots:
        assert _children(rec, i) == (
            ["compiled.key", "compiled.load", "compiled.fill"]
            + ["compiled.eager"] * T + ["compiled.gather"])
        assert {s["request"] for s in rec if s["parent"] == i} == {
            rec[i]["request"]}
    assert rec[roots[1]]["request"] == rec[roots[0]]["request"] + 1
    assert compiled.VIDEO_SLOTS > T  # one block of slots


def test_train_step_device_spans():
    torch.manual_seed(0)
    net = tracknet.Se3TrackNet(RES)
    cfg = tr.TrainConfig(resolution=RES, batch_size=2)
    opt, _ = tr.make_optimizer(net, cfg, steps_per_epoch=1)
    g = torch.Generator().manual_seed(0)
    eye = torch.eye(4).expand(2, 4, 4).clone()
    eye[:, 2, 3] = 0.5
    raw = {"rgbA": torch.rand(2, RES, RES, 3, generator=g) * 255,
           "depthA": torch.rand(2, RES, RES, generator=g) * 500 + 300,
           "rgbB": torch.rand(2, RES, RES, 3, generator=g) * 255,
           "depthB": torch.rand(2, RES, RES, generator=g) * 500 + 300,
           "maskB": torch.ones(2, RES, RES), "A_in_cam": eye,
           "B_in_cam": eye.clone()}
    mean, std = torch.zeros(8), torch.full((8,), 100.0)
    with profiling.recording():
        for _ in range(2):
            tr.train_step(net, opt, 1e-3, cfg, tr.step_generator(CPU, 0),
                          raw, mean, std)
    rec = profiling.spans()
    roots = [i for i, s in enumerate(rec) if s["parent"] is None]
    assert [rec[i]["name"] for i in roots] == ["trainer.train_step"] * 2
    assert rec[roots[1]]["request"] == rec[roots[0]]["request"] + 1
    for i in roots:
        assert _children(rec, i) == ["trainer.augment", "trainer.forward",
                                     "trainer.backward", "trainer.adam"]
    # device spans hold host times only on the CPU
    assert all(s["device_ms"] is None for s in rec)


def test_self_time_is_duration_less_children():
    with profiling.recording():
        with profiling.span("outer", request=7):
            time.sleep(0.002)
            with profiling.span("inner") as s:
                s.add("bytes", 5)
                time.sleep(0.003)
            with profiling.span("inner"):
                pass
    outer, a, b = profiling.spans()
    dur = [s["end_ns"] - s["start_ns"] for s in (outer, a, b)]
    assert outer["self_ns"] == dur[0] - dur[1] - dur[2]
    assert a["self_ns"] == dur[1] and a["parent"] == 0 == b["parent"]
    assert a["request"] == 7 and a["counts"] == {"bytes": 5}
    assert outer["self_ns"] >= 2_000_000 and a["self_ns"] >= 3_000_000


def test_count_goes_to_the_innermost_span():
    before = profiling.counters()["upload.pageable_bytes"]
    with profiling.recording():
        with profiling.span("outer"):
            with profiling.span("inner"):
                profiling.count("upload.pageable_bytes", 64)
            profiling.count("upload.pageable_bytes", 36)
    profiling.count("upload.pageable_bytes", 100)  # recording off
    outer, inner = profiling.spans()
    assert inner["counts"] == {"pageable_bytes": 64}
    assert outer["counts"] == {"pageable_bytes": 36}
    assert profiling.counters()["upload.pageable_bytes"] == before + 200
    names = set(profiling.counters())
    assert {"launches.pass1_winners", "launches.pass2_shade",
            "launches.gather_rows", "launches.pass1_worklist",
            "compiled.replays", "compiled.eager_calls",
            "compiled.captures"} <= names


def _events_ns(prof, name):
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name() == name:
            start = e.start_ns()
            out.append((start, start + int(e.duration_ns())))
    return out


def test_span_shares_the_profilers_clock():
    """Recording is on while a profiler runs; a span around a 20 ms sleep
    and its event in the trace agree within 1 ms at each end, and the
    event is a host operation (``record_function``'s user annotations are
    mirrored onto the card's timeline)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("clock.check"):
            time.sleep(0.02)
    (s,) = profiling.spans()
    ((a, b),) = _events_ns(prof, "clock.check")
    (e,) = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "clock.check"]
    assert e.device_type() == torch.autograd.DeviceType.CPU
    assert abs(s["start_ns"] - a) < 1_000_000
    assert abs(s["end_ns"] - b) < 1_000_000
    assert s["end_ns"] - s["start_ns"] >= 20_000_000


def _span(name, start, end, parent=None, counts=None, device_ms=None):
    return {"name": name, "start_ns": start, "end_ns": end, "parent": parent,
            "request": 0, "thread": 1, "counts": counts or {},
            "self_ns": None, "device_ms": device_ms}


def _read(metric, ctx):
    return runpy.run_path(os.path.join(METRICS, f"{metric}.py"))["read"](ctx)


ONTRACK = [  # two calls, 1 ms apart
    _span("tracker.on_track", 0, 3_000_000),
    _span("tracker.prepare", 0, 100_000, 0, {"pageable_bytes": 64}),
    _span("tracker.upload", 100_000, 400_000, 0,
          {"pageable_bytes": 1_536_000}),
    _span("compiled.key", 400_000, 500_000, 0),
    _span("compiled.load", 500_000, 600_000, 0),
    _span("compiled.replay", 600_000, 900_000, 0),
    _span("tracker.fetch", 900_000, 3_000_000, 0),
    _span("tracker.on_track", 4_000_000, 6_000_000),
    _span("tracker.prepare", 4_000_000, 4_100_000, 7, {"pageable_bytes": 64}),
    _span("tracker.upload", 4_100_000, 4_300_000, 7,
          {"pageable_bytes": 1_536_000}),
    _span("compiled.key", 4_300_000, 4_400_000, 7),
    _span("compiled.load", 4_400_000, 4_500_000, 7),
    _span("compiled.replay", 4_500_000, 4_700_000, 7),
    _span("tracker.fetch", 4_700_000, 6_000_000, 7),
]
TRAIN = [
    _span("trainer.train_step", 0, 10, device_ms=130.0),
    _span("trainer.augment", 0, 1, 0, device_ms=10.0),
    _span("trainer.forward", 1, 2, 0, device_ms=30.0),
    _span("trainer.backward", 2, 3, 0, device_ms=80.0),
    _span("trainer.adam", 3, 4, 0, device_ms=6.0),
]


@pytest.mark.parametrize("metric,records,ctx,expected", [
    ("host_ms.ontrack", ONTRACK, {"calls": 2}, (0.9 + 0.7) / 2),
    ("upload_ms.ontrack", ONTRACK, {"calls": 2}, (0.4 + 0.3) / 2),
    ("key_ms.ontrack", ONTRACK, {"calls": 2}, 0.1),
    ("launch_ms.ontrack", ONTRACK, {"calls": 2}, (0.3 + 0.2) / 2),
    ("pageable_kb.ontrack", ONTRACK, {"calls": 2}, 1_536_064 / 1024),
    ("launch_ms.video", ONTRACK, {"frames": 4}, 0.5 / 4),
    ("launch_ms.video_bf16", ONTRACK, {"frames": 4}, 0.5 / 4),
    ("augment_ms.train", TRAIN + TRAIN, {"steps": 2}, 10.0),
    ("forward_ms.train", TRAIN, {"steps": 1}, 30.0),
    ("backward_ms.train", TRAIN, {"steps": 1}, 80.0),
    ("adam_ms.train", TRAIN, {"steps": 1}, 6.0),
])
def test_span_readers(monkeypatch, metric, records, ctx, expected):
    monkeypatch.setattr(profiling, "spans", lambda: records)
    assert _read(metric, ctx) == pytest.approx(expected, rel=1e-12)
    # a window that recorded none of its spans, and a port without spans
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _read(metric, ctx) is None
    monkeypatch.delattr(profiling, "spans")
    assert _read(metric, ctx) is None
