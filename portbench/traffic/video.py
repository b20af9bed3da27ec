"""Offline tracking of a recorded RGB-D video (predict's scan mode,
evaluation): the video preloaded on the card, tracked by the module-level
``tracking.tracker.track_video`` (the captured step replayed, its frame
slots refilled from the video), one pass after another, closed loop, one
object. Passes alternate forward and backward so that motion stays
continuous; each starts from the ground-truth pose of its first frame, as
a tracker re-initialised at the start of a sequence, and its poses are
fetched to the host at its end.

Parameters: ``rate_metric`` (the end-to-end metric's name), ``judged``
frames, ``over`` (the gap above which a judged step counts as off),
``trace_frames`` in the traced window, ``warmup_frames``, ``limits``."""
from __future__ import annotations

import time

import torch

from .. import counts, program, trace, tracking_check as tc
from ..reference import render as ref_render, track as ref_track


class State:
    """One run: its inputs, the program, and the passes it tracked."""

    def track(self, direction, n=None):
        """One pass of ``n`` frames (all by default) through the program,
        forward (+1) or backward (-1), from the ground truth of its first
        frame. Returns the poses on the card."""
        from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

        rgb, depth = self.video[direction]
        if n is not None:
            rgb, depth = rgb[:n], depth[:n]
        t = self.trk
        return trk.track_video(t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
                               self.init[direction], rgb, depth)


def setup(cfg_name: str, params: dict, seed: int, device) -> State:
    s = State()
    s.params, s.seed, s.device = params, seed, device
    (s.cfg, s.mesh, s.weights, s.gt, rgb, depth) = tc.inputs(cfg_name, seed,
                                                            device)
    s.video = {+1: (rgb, depth), -1: (rgb.flip(0), depth.flip(0))}
    s.init = {+1: s.gt[0], -1: s.gt[-1]}
    net = program.network(*s.weights, s.cfg, device)
    s.trk = program.tracker(net, s.mesh, s.cfg, device)
    n = params["warmup_frames"]
    for d in (+1, -1):
        s.track(d, n).cpu()
    s.passes = []
    return s


def measure(s: State, seconds: float) -> dict:
    """Whole passes until ``seconds`` have gone by; the rate is every frame
    whose pose reached the host over the time to the last fetch."""
    frames, d = 0, +1
    t0 = time.perf_counter()
    while True:
        poses = s.track(d).cpu()
        s.passes.append((d, poses))
        frames += poses.shape[0]
        d = -d
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    return {s.params["rate_metric"]: frames / elapsed, "frames": frames,
            "window_s": elapsed}


def traced(s: State) -> dict:
    n = s.params["trace_frames"]
    with trace.traced() as prof:
        with trace.window_span():
            poses = s.track(+1, n).cpu()
    s.passes.append((+1, poses))
    return {"summary": trace.summarize(prof), "frames": poses.shape[0]}


def _judged(s: State):
    """(priors, frame indices, program poses) of the judged steps."""
    picks = tc.pick(s.seed, [p.shape[0] for _, p in s.passes],
                    s.params["judged"])
    T = s.gt.shape[0]
    priors, idx, prog = [], [], []
    for p, f in picks:
        d, poses = s.passes[p]
        priors.append(s.init[d].cpu() if f == 0 else poses[f - 1])
        idx.append(f if d > 0 else T - 1 - f)
        prog.append(poses[f])
    return torch.stack(priors), torch.tensor(idx), torch.stack(prog)


def close(s: State) -> None:
    """Free the program's state before the reference runs."""
    s.trk = None
    program.free()


def reference(s: State, priors, idx, precision="float32"):
    dev = s.device
    rgb, depth = s.video[+1]
    t = tc.scene.mesh_on(s.mesh, dev)
    K = torch.tensor(s.cfg["K"], device=dev)
    mean = torch.tensor(s.cfg["mean"], device=dev)
    std = torch.tensor(s.cfg["std"], device=dev)
    i = idx.to(dev)
    return ref_track.step(*s.weights, t, K, mean, std, priors.to(dev),
                          rgb[i], depth[i].float(), s.cfg,
                          precision=precision).cpu()


def readings(s: State, precision=None, with_steps=False) -> dict:
    """The judged numbers of the program's poses, or with ``precision`` of
    the reference computed at that precision in the program's place;
    ``with_steps`` adds every judged step's gap (``step_gaps``), from which
    ``over`` and the limits are set."""
    priors, idx, prog = _judged(s)
    ref = reference(s, priors, idx)
    if precision is not None:
        prog = reference(s, priors, idx, precision)
    out = tc.readings(s.cfg, prog, ref, s.params["over"])
    if with_steps:
        out["step_gaps"] = tc.step_gaps(s.cfg, prog, ref).tolist()
    return out


def check(s: State) -> list:
    return tc.numbers(readings(s), s.params["limits"])


def layer_context(s: State, traced_out: dict) -> dict:
    """What the per-layer readers of a traced video pass read; the
    kernels' bounds are those of every render of the traced pass."""
    dev = s.device
    n = traced_out["frames"]
    _, poses = s.passes[-1]
    priors = torch.cat([s.init[+1].cpu()[None], poses[:n - 1]]).to(dev)
    mesh_t = tc.scene.mesh_on(s.mesh, dev)
    K = torch.tensor(s.cfg["K"], device=dev)
    left, right, top, bottom = ref_track.roi_bbox(priors, K,
                                                  s.cfg["object_width_mm"])
    win = torch.stack([left, right, top, bottom], -1).float()
    res = (s.cfg["resolution"],) * 2
    _, _, winners = ref_render.render(mesh_t, priors, K, win, res,
                                      s.cfg["near_m"], s.cfg["far_m"])
    k1, p2 = tc.bounds(s.cfg, mesh_t, priors, K, winners)
    return {"summary": traced_out["summary"], "frames": traced_out["frames"],
            "flops_per_frame": counts.forward_flops(s.cfg["resolution"]),
            "peak_flops": counts.PEAK_FLOPS[s.cfg["dtype"]],
            "k1_bound_s": k1, "pass2_bound_s": p2}


