"""A robot's grasp loop, or the ROS node in blocking mode: one caller hands
``Tracker.on_track(prev_pose, rgb, depth)`` one frame at a time, as host
arrays (uint8 RGB, uint16 mm depth), and feeds back the pose it returns;
closed loop. Frames come from the recorded video, passes alternating
forward and backward, each starting from the ground-truth pose of its
first frame. Every call's latency runs from handing the frame over to
holding its pose.

Parameters as in ``video``."""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import program, trace, tracking_check as tc
from . import video


class State(video.State):
    """One run: its inputs (the video also as host arrays), the tracker,
    the passes it tracked and every call's latency."""

    def run_pass(self, direction, n=None, record=True, deadline=None):
        """Track frames of one pass through on_track; returns the poses."""
        T = self.host_rgb.shape[0]
        order = range(T) if direction > 0 else range(T - 1, -1, -1)
        pose = self.gt_host[0 if direction > 0 else T - 1]
        poses = []
        for k, i in enumerate(order):
            if n is not None and k >= n:
                break
            t0 = time.perf_counter()
            pose = self.trk.on_track(pose, self.host_rgb[i],
                                     self.host_depth[i])
            if record:
                self.latency.append(time.perf_counter() - t0)
            poses.append(pose)
            if deadline is not None and time.perf_counter() >= deadline:
                break
        out = torch.as_tensor(np.stack(poses))
        if record:
            self.passes.append((direction, out))
        return out


def setup(cfg_name: str, params: dict, seed: int, device) -> State:
    s = State()
    s.params, s.seed, s.device = params, seed, device
    (s.cfg, s.mesh, s.weights, s.gt, rgb, depth) = tc.inputs(cfg_name, seed,
                                                            device)
    s.video = {+1: (rgb, depth)}
    s.init = {+1: s.gt[0], -1: s.gt[-1]}
    s.host_rgb = rgb.cpu().numpy()
    s.host_depth = depth.cpu().numpy().astype(np.uint16)
    s.gt_host = s.gt.cpu().numpy()
    net = program.network(*s.weights, s.cfg, device)
    s.trk = program.tracker(net, s.mesh, s.cfg, device)
    s.passes = []
    s.latency = []
    s.run_pass(+1, params["warmup_frames"], record=False)
    return s


def measure(s: State, seconds: float) -> dict:
    """Calls until ``seconds`` have gone by; the 95th percentile of every
    call's latency."""
    d = +1
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        s.run_pass(d, deadline=deadline)
        d = -d
    lat = np.asarray(s.latency) * 1e3
    return {"pose_latency_ms_p95": float(np.percentile(lat, 95)),
            "calls": int(lat.size), "window_s": time.perf_counter() - t0}


def traced(s: State) -> dict:
    n = s.params["trace_frames"]
    with trace.traced() as prof:
        with trace.window_span():
            poses = s.run_pass(+1, n)
    return {"summary": trace.summarize(prof), "calls": poses.shape[0]}


_judged = video._judged
close = video.close
reference = video.reference
readings = video.readings
check = video.check


def layer_context(s: State, traced_out: dict) -> dict:
    return {"summary": traced_out["summary"], "calls": traced_out["calls"]}
