"""Offline tracking of a recorded RGB-D video with FoundationPose's refiner
(the port's ``models/refinenet.RefineNet``): the ``video`` traffic, two
render-and-compare rounds a frame. The video is preloaded on the card and
tracked by the module-level ``tracking.tracker.track_video`` (the captured
two-round step replayed, its frame slots refilled from the video), one pass
after another, closed loop, one object. Passes alternate forward and
backward, each from the ground-truth pose of its first frame, and each
pass's poses are fetched to the host at its end.

Every judged step is one frame's two rounds: from the program's own prior
pose, the reference (``reference/refiner.py``) renders, crops and runs the
network twice, each round from the pose of the round before, and its new
pose is compared with the program's.

Parameters as in ``video``."""
from __future__ import annotations

import numpy as np
import torch

from .. import (config, counts, counts_refiner, program, refiner_weights,
                scene, trace, tracking_check as tc)
from ..reference import refiner as ref_refiner
from . import video

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
COUNTER = "refine.rounds"


def network(params, buffers, cfg, device):
    """The port's RefineNet in the configuration's activation type,
    holding the benchmark's weights; its own position table."""
    from iros20_6d_pose_tracking_tpu_torch.models import refinenet

    with torch.device(device):
        net = refinenet.RefineNet(dtype=DTYPES[cfg["dtype"]])
    state = {**params, **buffers}
    for name, t in net.state_dict().items():
        state.setdefault(name, t)
    net.load_state_dict(state, strict=True)
    return net.eval()


def tracker(net, mesh, cfg, device):
    """``Tracker.from_parts`` with the refiner: the ROI of the diameter plus
    the bounding-box pad (1.2 d), back faces culled. The refiner normalises
    its inputs itself, so the statistics are placeholders."""
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    tcfg = trk.TrackerConfig(
        resolution=cfg["resolution"], object_width_mm=cfg["object_width_mm"],
        cull_backfaces=cfg["mesh"]["cull"], dtype=DTYPES[cfg["dtype"]])
    return trk.Tracker.from_parts(net, tcfg, program.mesh_arrays(mesh, device),
                                  np.asarray(cfg["K"], np.float32),
                                  np.zeros(8, np.float32),
                                  np.ones(8, np.float32))


def inputs(cfg_name: str, seed: int, device):
    """(cfg, mesh (numpy), weights, ground truth (T, 4, 4), rgb, depth)."""
    cfg0 = config.configuration(cfg_name)
    mesh = scene.make_mesh(cfg0)
    cfg = config.configuration(cfg_name, mesh["diameter_m"])
    weights = refiner_weights.make_weights(cfg, seed, device)
    gt = scene.trajectory(cfg, seed, cfg["video"]["frames"], device)
    rgb, depth = scene.make_video(cfg, seed, gt, device)
    return cfg, mesh, weights, gt, rgb, depth


State = video.State


def setup(cfg_name: str, params: dict, seed: int, device) -> State:
    s = State()
    s.params, s.seed, s.device = params, seed, device
    (s.cfg, s.mesh, s.weights, s.gt, rgb, depth) = inputs(cfg_name, seed,
                                                          device)
    s.video = {+1: (rgb, depth), -1: (rgb.flip(0), depth.flip(0))}
    s.init = {+1: s.gt[0], -1: s.gt[-1]}
    net = network(*s.weights, s.cfg, device)
    s.trk = tracker(net, s.mesh, s.cfg, device)
    n = params["warmup_frames"]
    for d in (+1, -1):
        s.track(d, n).cpu()
    s.passes = []
    return s


measure = video.measure
close = video.close


def _rounds():
    """The port's count of refiner rounds, or None where it keeps none."""
    try:
        from iros20_6d_pose_tracking_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling.counters().get(COUNTER)


def traced(s: State) -> dict:
    n = s.params["trace_frames"]
    before = _rounds()
    with trace.traced() as prof:
        with trace.window_span():
            poses = s.track(+1, n).cpu()
    after = _rounds()
    s.passes.append((+1, poses))
    rounds = None if before is None or after is None else after - before
    return {"summary": trace.summarize(prof), "frames": poses.shape[0],
            "rounds": rounds}


def reference(s: State, priors, idx, precision="float32",
              rounds=ref_refiner.ROUNDS):
    dev = s.device
    rgb, depth = s.video[+1]
    i = idx.to(dev)
    return ref_refiner.step(*s.weights, scene.mesh_on(s.mesh, dev),
                            torch.tensor(s.cfg["K"], device=dev),
                            priors.to(dev), rgb[i], depth[i].float(), s.cfg,
                            precision=precision, rounds=rounds).cpu()


def readings(s: State, precision=None, with_steps=False,
             one_round=False) -> dict:
    """The judged numbers of the program's poses, or with ``precision`` of
    the reference computed at that precision in the program's place
    (``fp8``: the control); ``with_steps`` adds every judged step's gap;
    ``one_round``: the reference's first round alone in the program's
    place (a planted fault: a step that stops after one round)."""
    priors, idx, prog = video._judged(s)
    ref = reference(s, priors, idx)
    if precision is not None:
        prog = reference(s, priors, idx, precision)
    if one_round:
        prog = reference(s, priors, idx, rounds=1)
    out = tc.readings(s.cfg, prog, ref, s.params["over"])
    if with_steps:
        out["step_gaps"] = tc.step_gaps(s.cfg, prog, ref).tolist()
    return out


def check(s: State) -> list:
    return tc.numbers(readings(s), s.params["limits"])


def layer_context(s: State, traced_out: dict) -> dict:
    """What the per-layer readers of a traced refiner pass read."""
    return {"summary": traced_out["summary"], "frames": traced_out["frames"],
            "rounds": traced_out["rounds"],
            "flops_per_round": counts_refiner.forward_flops(
                s.cfg["resolution"]),
            "peak_flops": counts.PEAK_FLOPS[s.cfg["dtype"]]}
