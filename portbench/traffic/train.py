"""Training a tracker for a new object: batches of synthetic pairs made on
the card by the port's sampler (``data.dataset``: the poses from the draws,
both branches of every pair rendered in one K1 and one pass2_shade launch,
the domain randomisation composited into B), then ``train.trainer.
train_step`` (B augmentation, normalisation, forward and backward, Adam),
back to back. Every random number of a step is drawn by the benchmark from
the seed, in the layout of the port's own draws, before the window: a ring
of ``draw_sets`` draw sets, step k taking set k mod ``draw_sets``, so that
only the port's code runs in the window.

Set-up builds the model and its optimizer once, drives them through the
first ``judged_steps`` steps (which also warm every shape up) and hands
the same objects to the window. After the window, ``judged_steps`` more
steps go through the same objects and the same call. The reference
follows both groups: the first from the benchmark's weights, the later
from the program's state as the window left it.

Parameters: ``judged_steps``, ``draw_sets``, ``trace_steps``,
``sampler_views_judged``, ``limits``."""
from __future__ import annotations

import time

import torch

from .. import check as compare, config, counts, program, scene, trace
from ..reference import cnn, train as ref_train


class State:
    """One run: inputs, the model and optimizer, the judged steps."""

    def step(self, sample_events=None):
        """One step of the program on the next step's draws: (draw set,
        raw batch, outputs). ``sample_events``: a list that gets the CUDA
        events around the sampler's call."""
        k = self.step_no % len(self.ring)
        draws = self.ring[k]
        if sample_events is not None:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
        raw = program.sample(self.synth, draws["synth"])
        if sample_events is not None:
            b.record()
            sample_events.append((a, b))
        out = program.train_step(self.net, self.opt, self.lr_at(self.step_no),
                                 self.tcfg, raw, draws, self.mean, self.std)
        self.step_no += 1
        return k, raw, out


def _adam_state(s: State):
    """Adam's moments and step count (zero moments before its first
    step)."""
    m, v, t = {}, {}, 0
    for n, p in s.net.named_parameters():
        st = s.opt.state.get(p, {})
        if "exp_avg" in st:
            m[n], v[n] = st["exp_avg"].clone(), st["exp_avg_sq"].clone()
            t = int(st["step"])
        else:
            m[n], v[n] = torch.zeros_like(p), torch.zeros_like(p)
    return m, v, t


def _snapshot(s: State) -> dict:
    """The program's state: parameters, BatchNorm buffers and Adam's."""
    return {"params": {n: p.detach().clone()
                       for n, p in s.net.named_parameters()},
            "buffers": {n: b.detach().clone()
                        for n, b in s.net.named_buffers()},
            "adam": _adam_state(s)}


def _judged_steps(s: State, n: int, start: dict) -> dict:
    """``n`` steps of the program through the window's own call, from the
    state ``start`` that the reference will start from: the draw set and
    the raw batch of each step, the losses, the first gradient as Adam got
    it (worked out from its first moment before and after one step, L2
    included) and the parameters after the last step."""
    b1 = s.tcfg.betas[0]
    m0 = start["adam"][0]
    rec = {"start": start, "draws": [], "raws": [], "losses": []}
    for k in range(n):
        d, raw, out = s.step()
        rec["draws"].append(d)
        rec["raws"].append({n_: v.clone() for n_, v in raw.items()})
        rec["losses"].append(out["loss"])
        if k == 0:
            m1 = _adam_state(s)[0]
            rec["first_grad"] = {n_: (m1[n_] - b1 * m0[n_]) / (1 - b1)
                                 for n_ in m1}
    rec["p_after"] = {n_: p.detach().clone()
                      for n_, p in s.net.named_parameters()}
    rec["losses"] = torch.stack(rec["losses"]).cpu()
    return rec


def setup(cfg_name: str, params: dict, seed: int, device) -> State:
    s = State()
    s.params, s.seed, s.device = params, seed, device
    cfg0 = config.configuration(cfg_name)
    s.mesh = scene.make_mesh(cfg0)
    s.cfg = config.configuration(cfg_name, s.mesh["diameter_m"])
    s.weights = scene.make_weights(s.cfg, seed, device)
    s.ring = [scene.train_draws(s.cfg, seed, k, device)
              for k in range(params["draw_sets"])]
    s.net = program.network(*s.weights, s.cfg, device)
    s.synth, s.tcfg, s.opt, s.lr_at = program.trainer(s.net, s.mesh, s.cfg,
                                                      device)
    s.mean = torch.tensor(s.cfg["mean"], device=device)
    s.std = torch.tensor(s.cfg["std"], device=device)
    s.step_no = 0
    zero = {k: torch.zeros_like(v) for k, v in s.weights[0].items()}
    start = {"params": {k: v.clone() for k, v in s.weights[0].items()},
             "buffers": s.weights[1], "adam": (zero, zero, 0)}
    s.early = _judged_steps(s, params["judged_steps"], start)
    return s


def measure(s: State, seconds: float) -> dict:
    """Steps back to back; a step counts once its loss is on the host, read
    while the next step is queued."""
    n = s.tcfg.batch_size
    steps, pending = 0, None
    t0 = time.perf_counter()
    while True:
        _, _, out = s.step()
        if pending is not None:
            pending.item()
            steps += 1
        pending = out["loss"]
        if time.perf_counter() - t0 >= seconds:
            break
    pending.item()
    steps += 1
    elapsed = time.perf_counter() - t0
    return {"train_samples_per_s": steps * n / elapsed, "steps": steps,
            "window_s": elapsed}


def traced(s: State) -> dict:
    events = []
    with trace.traced() as prof:
        with trace.window_span():
            for _ in range(s.params["trace_steps"]):
                _, _, out = s.step(events)
            out["loss"].item()
    return {"summary": trace.summarize(prof), "steps": len(events),
            "sample_ms": [a.elapsed_time(b) for a, b in events]}


def close(s: State) -> None:
    """After the window: the later judged steps, from the state the window
    left, through the same objects and call; then free the program."""
    s.late = _judged_steps(s, s.params["judged_steps"], _snapshot(s))
    s.net = s.opt = s.synth = None
    program.free()


def _reference_run(s: State, rec: dict, precision="float32",
                   half_batch=False):
    """The reference's steps of one judged group from its start, on the
    program's sampled batches (images and poses; the sampler is judged by
    itself, ``sampler_readings``): losses, the first gradient the
    optimizer gets, and the parameters after the last step."""
    start = rec["start"]
    params, buffers = start["params"], start["buffers"]
    t = s.cfg["train"]
    adam = ref_train.Adam(params, t["learning_rate"], tuple(t["betas"]),
                          1e-8, t["weight_decay"], start["adam"])
    losses = []
    for d, raw in zip(rec["draws"], rec["raws"]):
        draws = scene.train_draws(s.cfg, s.seed, d, s.device)
        loss, grads = ref_train.loss_and_grads(
            params, buffers, raw, draws["aug"], s.mean, s.std, s.cfg,
            precision, half_batch)
        params = adam.step(params, grads)
        losses.append(float(loss))
    return torch.tensor(losses, dtype=torch.float64), adam.first_grad, params


def sampler_readings(s: State, precision=None, altered_poses=False) -> dict:
    """The sampler's batches of every judged step against the reference's
    at the same draws. ``sampler_share``: of the judged views, the share of
    their pixel values (rgb of both branches, in 0-255, and depth, in mm)
    that differ by more than ``SAMPLER_TOL``; a silhouette pixel whose
    centre lies within rounding of an edge may be covered on one side only,
    while a wrong view, pose, lighting or composite moves whole regions.
    ``pose_gap``: the largest gap of an entry of the batch's A and B poses
    (metres, and the rotation's entries). With ``precision``, the
    reference's sampler at that precision (its poses and its render)
    stands in the program's place; ``altered_poses`` moves the program's
    poses by 1 mm (a planted fault)."""
    n = s.params["sampler_views_judged"]
    gen = torch.Generator().manual_seed(int(s.seed) & ((1 << 63) - 1))
    mesh_t = scene.mesh_on(s.mesh, s.device)
    K = torch.tensor(s.cfg["K"], device=s.device)
    off = total = 0
    pose_gap = 0.0
    for rec in (s.early, s.late):
        for d, raw in zip(rec["draws"], rec["raws"]):
            draws = scene.train_draws(s.cfg, s.seed, d, s.device)
            views = torch.randperm(raw["rgbA"].shape[0], generator=gen)[:n].to(
                s.device)
            ref = ref_train.sample(mesh_t, K, draws["A_in_cam"],
                                   draws["B_in_cam"], draws["dr"], s.cfg,
                                   views)
            if precision is not None:
                with cnn.Arith(precision):
                    ctrl = scene.train_draws(s.cfg, s.seed, d, s.device)
                poses = {k: ctrl[k] for k in ("A_in_cam", "B_in_cam")}
                judged = ref_train.sample(mesh_t, K, ctrl["A_in_cam"],
                                          ctrl["B_in_cam"], draws["dr"],
                                          s.cfg, views, precision)
            else:
                poses = {k: raw[k] for k in ("A_in_cam", "B_in_cam")}
                judged = {k: v[views] for k, v in raw.items()}
            for key, P in poses.items():
                if altered_poses:
                    P = P.clone()
                    P[:, 0, 3] += 1e-3
                pose_gap = max(pose_gap,
                               float((P - draws[key]).abs().max()))
            for key in ("rgbA", "depthA", "rgbB", "depthB"):
                diff = (judged[key] - ref[key]).abs()
                off += int((diff > SAMPLER_TOL).sum())
                total += diff.numel()
    return {"sampler_share": off / total, "pose_gap": pose_gap}


SAMPLER_TOL = 1.0


def _group_readings(s: State, rec: dict, precision, half_batch) -> dict:
    """Loss, first gradient and parameter change of one judged group.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's (the biases of convolutions that BatchNorm follows) move under
    Adam by round-off alone and are left out of the parameters' change."""
    losses, g_ref, p_ref = _reference_run(s, rec)
    norms = {k: g.norm() for k, g in g_ref.items()}
    med = torch.stack(list(norms.values())).median()
    keep = {k for k, v in norms.items() if v >= 1e-3 * med}
    if precision is None and not half_batch:
        p_losses, p_grad, p_after = rec["losses"], rec["first_grad"], \
            rec["p_after"]
    else:
        p_losses, p_grad, p_after = _reference_run(
            s, rec, precision or "float32", half_batch)
    p0 = rec["start"]["params"]
    return {
        "loss_gap": float(((p_losses.double() - losses).abs()
                           / losses.abs()).max()),
        "grad_gap": compare.leaf_gap(p_grad, g_ref),
        "change_gap": compare.leaf_gap({k: p_after[k] - p0[k] for k in keep},
                                     {k: p_ref[k] - p0[k] for k in keep}),
    }


def readings(s: State, precision=None, half_batch=False,
             altered_poses=False) -> dict:
    """The judged numbers of the program's steps, or with ``precision`` or
    ``half_batch`` of the reference in the program's place (under
    ``half_batch``, which leaves the sampler alone, the sampler's numbers
    are the program's; ``altered_poses`` moves the program's poses): those
    of the first steps, under ``late_`` those of the steps after the
    window, and the sampler's."""
    out = _group_readings(s, s.early, precision, half_batch)
    late = _group_readings(s, s.late, precision, half_batch)
    out.update({f"late_{k}": v for k, v in late.items()})
    out.update(sampler_readings(
        s, precision if precision in ("tf32",) else None, altered_poses))
    return out


def check(s: State) -> list:
    r = readings(s)
    lim = s.params["limits"]
    return [(k, r[k], lim[k]) for k in lim]


def layer_context(s: State, traced_out: dict) -> dict:
    return {"summary": traced_out["summary"], "steps": traced_out["steps"],
            "samples": traced_out["steps"] * s.tcfg.batch_size,
            "flops_per_sample": 3 * counts.forward_flops(s.cfg["resolution"]),
            "peak_flops": counts.PEAK_FLOPS[s.cfg["dtype"]],
            "sample_ms": traced_out["sample_ms"]}
