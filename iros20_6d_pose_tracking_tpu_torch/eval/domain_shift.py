"""Domain-shifted sensor model and the long-horizon and live recovery
protocols of the accuracy suite, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/eval/domain_shift.py``. The
observed test video and the tracker's A branch come from the same
rasterizer; this module breaks that identity on every axis a real camera
would:

  - **lighting**: the observed video renders with other ambient, diffuse
    and light-position constants (:meth:`SensorModel.lighting`) than the
    tracker's A branch;
  - **photometric drift**: per-frame exposure and white-balance gains (slow
    sinusoids), gamma, RGB noise;
  - **motion blur** along the object's projected screen velocity;
  - **depth sensor**: a low-frequency multiplicative warp, per-pixel noise,
    quantization, edge dropout at depth discontinuities, random dropout;
  - **noisy initialization** of PoseCNN grade (:func:`noisy_init_pose`).

:func:`apply_sensor_model` runs all T frames of a video in one batch on
their device. Its random numbers come in as draws (:func:`draw_sensor_noise`,
ROADMAP F7): torch cannot replay ``jax.random``, so a test hands both
packages the same draws. The Bernoulli masks are ``uniform < p``, which is
what ``jax.random.bernoulli`` computes.

:func:`long_horizon_eval` is the closed-loop protocol: track in chunks with
the per-frame depth-agreement health, re-initialize from a noisy external
pose whenever ``ReinitPolicy`` fires, optionally through a forced
full-occlusion burst. :func:`live_recovery_eval` runs the burst through the
live path (``StreamTracker`` with its background policy and
``on_track_lost``). Divergences from the JAX module (ROADMAP F8): the last
chunk is not padded; re-init draws are keyed by frame index; every recovery
row says ``recovered`` and gives ``None``, never ``nan``, for the
post-recovery AUCs when nothing recovered. Copied on purpose: the edge
dropout's 3x3 neighbourhood wraps around the image border (``torch.roll``,
as JAX's ``jnp.roll``), and the live policy is not re-armed after a blind
fire.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import se3
from ..datagen.pair_producer import _upsample_linear_t
from ..render import mesh as M
from ..render import raster_kernels as rk
from ..tracking import hypotheses as hy
from ..tracking import tracker as trk
from ..train.trainer import step_generator
from . import metrics as ME

# Seed index of the first noisy initialization; later ones use the frame's
# index (the JAX module's fold_in(key, 10**6) and fold_in(key, frame)).
INIT_INDEX = 10**6


@dataclass(frozen=True)
class SensorModel:
    """Static description of the observation's domain shift (the JAX
    module's fields and defaults)."""

    # lighting of the OBSERVED render (the A branch keeps the rasterizer's
    # ambient 0.65 / diffuse 0.4 / light (0, -0.1, -0.9)): darker overall,
    # with a displaced light
    ambient: float = 0.45
    diffuse: float = 0.48
    light_cam: tuple = (0.35, -0.45, -0.35)
    # photometric pipeline
    exposure_amp: float = 0.18     # peak exposure gain drift (x1 +- amp)
    wb_amp: float = 0.08           # peak per-channel white-balance drift
    gamma: float = 1.15
    rgb_noise_std: float = 3.0     # 0..255 scale
    motion_blur_px: float = 2.5    # max blur extent along screen velocity
    # depth sensor
    depth_quant_mm: float = 4.0
    edge_grad_mm: float = 30.0     # discontinuity threshold for dropout
    edge_dropout_prob: float = 0.7
    depth_warp_amp: float = 0.012  # low-frequency multiplicative warp
    depth_noise_mm: float = 2.0
    dropout_prob: float = 0.02
    # initialization error (PoseCNN grade)
    init_trans_m: float = 0.015
    init_rot_deg: float = 8.0
    # constant per-channel white-balance gain (texture_hostile)
    wb_const: tuple = (1.0, 1.0, 1.0)

    def lighting(self, device="cpu") -> torch.Tensor:
        """(5,) float32 [ambient, diffuse, lx, ly, lz], the render's
        lighting override."""
        return torch.tensor([self.ambient, self.diffuse, *self.light_cam],
                            dtype=torch.float32, device=device)

    def scaled(self, s: float) -> "SensorModel":
        """The same shift at severity ``s`` (x0: the matched domain, x1:
        this model, x2, x4: more hostile). Lighting moves ``s`` of the way
        from the rasterizer's defaults to this model's values and beyond;
        amplitudes and noises scale linearly, probabilities saturate at 1,
        gamma scales in log space (gamma ** s)."""
        def lerp(default, v):
            return default + s * (v - default)

        return dataclasses.replace(
            self,
            ambient=lerp(rk.AMBIENT, self.ambient),
            diffuse=lerp(rk.DIFFUSE, self.diffuse),
            light_cam=tuple(lerp(d, v)
                            for d, v in zip(rk.LIGHT_CAM, self.light_cam)),
            exposure_amp=s * self.exposure_amp,
            wb_amp=s * self.wb_amp,
            gamma=float(self.gamma ** s),
            rgb_noise_std=s * self.rgb_noise_std,
            motion_blur_px=s * self.motion_blur_px,
            depth_quant_mm=max(s * self.depth_quant_mm, 1e-6),
            edge_dropout_prob=min(s * self.edge_dropout_prob, 1.0),
            depth_warp_amp=s * self.depth_warp_amp,
            depth_noise_mm=s * self.depth_noise_mm,
            dropout_prob=min(s * self.dropout_prob, 1.0),
            init_trans_m=s * self.init_trans_m,
            init_rot_deg=s * self.init_rot_deg,
            wb_const=tuple(lerp(1.0, v) for v in self.wb_const),
        )


def texture_hostile(base: SensorModel = SensorModel()) -> SensorModel:
    """A shift against the appearance cue of UV textures: a strong warm
    colour cast (a fixed white-balance error) and doubled white-balance
    hunting; depth and geometry stay at ``base``."""
    return dataclasses.replace(base, wb_const=(1.25, 1.0, 0.72),
                               wb_amp=2.0 * base.wb_amp)


def screen_velocities(gt: np.ndarray, K: np.ndarray) -> np.ndarray:
    """(T, 2) per-frame projected object-centre velocity in pixels (u, v)."""
    t = gt[:, :3, 3]
    z = np.maximum(t[:, 2], 1e-6)
    u = t[:, 0] * K[0, 0] / z + K[0, 2]
    v = t[:, 1] * K[1, 1] / z + K[1, 2]
    uv = np.stack([u, v], -1)
    vel = np.zeros_like(uv)
    vel[1:] = uv[1:] - uv[:-1]
    return vel.astype(np.float32)


def _shift3(img: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor):
    """Zero-padded integer shift of each frame of ``img`` (T, H, W[, C]) by
    its own (dy[t], dx[t]): out[t, y, x] = img[t, y - dy, x - dx] where that
    lies in the frame, else 0."""
    T, H, W = img.shape[:3]
    dev = img.device
    sy = torch.arange(H, device=dev)[None, :] - dy[:, None]      # (T, H)
    sx = torch.arange(W, device=dev)[None, :] - dx[:, None]      # (T, W)
    ok = (((sy >= 0) & (sy < H))[:, :, None]
          & ((sx >= 0) & (sx < W))[:, None, :])
    t = torch.arange(T, device=dev)[:, None, None]
    out = img[t, sy.clamp(0, H - 1)[:, :, None],
              sx.clamp(0, W - 1)[:, None, :]]
    if img.dim() == 4:
        ok = ok[..., None]
    return torch.where(ok, out, 0.0)


def blur_offsets(vel_uv: torch.Tensor, sensor: SensorModel) -> torch.Tensor:
    """(T, 5, 2) integer (u, v) offsets of the 5 motion-blur taps of each
    frame: taps -1, -0.5, 0, 0.5, 1 of the blur extent along the screen
    velocity."""
    vu, vv = vel_uv[:, 0], vel_uv[:, 1]
    speed = torch.sqrt(vu * vu + vv * vv)
    ext = torch.clamp(speed, max=sensor.motion_blur_px)
    direc = vel_uv / torch.clamp(speed, min=1e-6)[:, None]
    taps = torch.tensor([-1.0, -0.5, 0.0, 0.5, 1.0], device=vel_uv.device)
    return torch.round(taps[None, :, None] * ext[:, None, None]
                       * direc[:, None, :]).to(torch.int64)


def draw_sensor_noise(generator: torch.Generator, T: int, hw, device) -> dict:
    """Draws of :func:`apply_sensor_model` for T frames of (H, W), made on
    the generator's device and moved to ``device``: the RGB noise (T, H, W,
    3) and depth noise (T, H, W) standard normals, the warp's (T, 4, 4)
    uniforms, and the edge-dropout and dropout uniforms (T, H, W)."""
    H, W = hw
    gd = generator.device

    def normal(shape):
        return torch.randn(shape, generator=generator, device=gd).to(device)

    def uniform(shape):
        return torch.rand(shape, generator=generator, device=gd).to(device)

    return {"rgb_noise": normal((T, H, W, 3)),
            "depth_noise": normal((T, H, W)),
            "warp": uniform((T, 4, 4)),
            "edge": uniform((T, H, W)),
            "drop": uniform((T, H, W))}


@torch.no_grad()
def apply_sensor_model(draws: dict, rgb: torch.Tensor, depth_mm: torch.Tensor,
                       vel_uv: torch.Tensor, frame_idx: torch.Tensor,
                       sensor: SensorModel):
    """T frames through the camera model, on their device. rgb (T, H, W, 3)
    in [0, 255] and depth_mm (T, H, W) float32, vel_uv (T, 2) projected
    object velocity in px a frame, frame_idx (T,) the frames' indices (the
    phase of the exposure and white-balance drift). Deterministic given
    ``draws`` (:func:`draw_sensor_noise`). Returns (rgb, depth) float32."""
    T, H, W = depth_mm.shape
    dev = rgb.device

    # motion blur: the mean of 5 integer-shifted copies along the velocity
    offs = blur_offsets(vel_uv, sensor)
    acc = torch.zeros_like(rgb)
    for k in range(offs.shape[1]):
        acc = acc + _shift3(rgb, offs[:, k, 1], offs[:, k, 0])
    rgb = acc / 5.0

    # exposure and white-balance drift, gamma, noise
    ph = frame_idx.to(torch.float32)
    two_pi = 2 * math.pi
    exposure = 1.0 + sensor.exposure_amp * torch.sin(two_pi * ph / 97.0)
    periods = torch.tensor([61.0, 83.0, 47.0], device=dev)
    phases = torch.tensor([0.0, 2.1, 4.2], device=dev)
    wb = torch.tensor(sensor.wb_const, dtype=torch.float32, device=dev) + \
        sensor.wb_amp * torch.sin(two_pi * ph[:, None] / periods + phases)
    rgb = rgb * exposure[:, None, None, None] * wb[:, None, None, :]
    rgb = 255.0 * torch.pow(torch.clamp(rgb / 255.0, 0.0, 1.0), sensor.gamma)
    rgb = rgb + draws["rgb_noise"] * sensor.rgb_noise_std
    rgb = torch.clamp(rgb, 0.0, 255.0)

    # depth sensor
    valid = depth_mm > 0
    up = _upsample_linear_t(draws["warp"].permute(1, 2, 0), H, W)
    warp = 1.0 + (up.permute(2, 0, 1) - 0.5) * 2.0 * sensor.depth_warp_amp
    d = depth_mm * warp
    d = d + draws["depth_noise"] * sensor.depth_noise_mm
    d = torch.round(d / sensor.depth_quant_mm) * sensor.depth_quant_mm
    # edge dropout: depth discontinuities shadow the IR projector. The 3x3
    # neighbourhood wraps around the border, as JAX's jnp.roll does.
    dmax = d
    dmin = torch.where(valid, d, torch.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            r = torch.roll(d, (dy, dx), (1, 2))
            rv = torch.roll(valid, (dy, dx), (1, 2))
            dmax = torch.maximum(dmax, torch.where(rv, r, 0.0))
            dmin = torch.minimum(dmin, torch.where(rv, r, torch.inf))
    edge = (dmax - torch.where(torch.isfinite(dmin), dmin, dmax)) \
        > sensor.edge_grad_mm
    drop = edge & (draws["edge"] < sensor.edge_dropout_prob)
    drop = drop | (draws["drop"] < sensor.dropout_prob)
    d = torch.where(valid & ~drop, d, 0.0)
    return rgb, d


def shift_video(frames_rgb, frames_depth, gt, K,
                sensor: SensorModel = SensorModel(), seed: int = 0,
                draws: dict | None = None):
    """The sensor model over a whole rendered video ((T, H, W, 3) rgb in
    [0, 255], (T, H, W) depth mm; tensors or arrays), all T frames in one
    batch on the frames' device. ``draws`` default to
    :func:`draw_sensor_noise` from a generator on that device seeded
    ``seed``. Returns (rgb, depth) float32 tensors."""
    rgb = torch.as_tensor(frames_rgb).to(torch.float32)
    depth = torch.as_tensor(frames_depth).to(torch.float32)
    dev = rgb.device
    T, H, W = depth.shape
    if draws is None:
        draws = draw_sensor_noise(torch.Generator(dev).manual_seed(seed), T,
                                  (H, W), dev)
    vel = torch.from_numpy(screen_velocities(np.asarray(gt),
                                             np.asarray(K))).to(dev)
    idx = torch.arange(T, device=dev)
    return apply_sensor_model(draws, rgb, depth, vel, idx, sensor)


def draw_noisy_init(generator: torch.Generator, device="cpu") -> dict:
    """Draws of :func:`noisy_init_pose`: a direction for the translation
    and one for the rotation axis (``se3.draw_direction``)."""
    return {"dir_t": se3.draw_direction(generator, (), device),
            "dir_r": se3.draw_direction(generator, (), device)}


def noisy_init_pose(draws, pose, sensor: SensorModel = SensorModel()):
    """PoseCNN-grade perturbed initialization: exactly ``init_trans_m`` of
    translation and ``init_rot_deg`` of rotation, each in a uniform random
    direction. ``draws``: :func:`draw_noisy_init`'s dict, or a
    ``torch.Generator`` to draw it from. Returns a (4, 4) float32 tensor on
    ``pose``'s device (the CPU for an array)."""
    pose = torch.as_tensor(pose, dtype=torch.float32)
    if isinstance(draws, torch.Generator):
        draws = draw_noisy_init(draws)
    dev = pose.device
    dt = se3.apply_direction({k: v.to(dev) for k, v in draws["dir_t"].items()}
                             ) * sensor.init_trans_m
    w = se3.apply_direction({k: v.to(dev) for k, v in draws["dir_r"].items()}
                            ) * float(np.deg2rad(sensor.init_rot_deg))
    return pose @ se3.make_pose(se3.so3_exp(w), dt)


def _reinit_draws(seed: int, reinit_draws):
    """Frame index -> the draws of the noisy re-detection at that frame:
    ``reinit_draws(index)`` where given, else :func:`draw_noisy_init` from a
    CPU generator keyed (seed, index), the same on every device."""
    if reinit_draws is not None:
        return reinit_draws
    return lambda i: draw_noisy_init(step_generator("cpu", seed, i))


def _frames_on(frames, device, depth: bool):
    """A video ((T, H, W[, 3]) array or tensor) as a tensor on ``device``:
    uint8 RGB and uint16 depth as ``tracker.upload_rgb`` / ``upload_depth``
    give them, anything else as it is."""
    if torch.is_tensor(frames):
        return frames.to(device)
    return (trk.upload_depth if depth else trk.upload_rgb)(frames, device)


def _recovery_scores(out: dict, add, adi, recovered_at) -> None:
    """The recovery keys of a forced-failure row: ``recovered`` and the
    post-recovery AUCs over the frames after ``recovered_at`` (None when
    nothing recovered)."""
    out["recovered"] = recovered_at is not None
    # errors are indexed over gt (frame 0 = init): tracked frame r is row r+1
    out["post_recovery_add_auc"] = None if recovered_at is None else float(
        ME.vocap(add[recovered_at + 1:]) * 100)
    out["post_recovery_adi_auc"] = None if recovered_at is None else float(
        ME.vocap(adi[recovered_at + 1:]) * 100)


@torch.no_grad()
def long_horizon_eval(obj, gt, frames_rgb, frames_depth, K, *,
                      chunk: int = 50, threshold: float = 0.3,
                      patience: int = 3, seed: int = 33,
                      reinit_sensor: SensorModel = SensorModel(),
                      fail_at: int | None = None, fail_len: int = 15,
                      reinit_draws=None) -> dict:
    """Closed-loop long-horizon tracking on the device of the object's mesh:
    track in chunks of ``chunk`` frames with each frame's depth-agreement
    health (``hypotheses.track_video_with_health``); whenever
    ``ReinitPolicy`` fires, re-initialize from a noisy external pose
    (:func:`noisy_init_pose` of the gt) and continue. The last chunk tracks
    only its own frames.

    ``fail_at``: tracked-frame index of a forced failure, a ``fail_len``
    frame full-occlusion burst (RGB and depth zeroed). The detector is blind
    during the burst too, so a fire inside it holds the last estimate and
    re-detects at the first clear frame. Reported: ``detection_latency``
    (frames from the onset to the fire that triggered the recovery, counting
    only fires at or after the onset; None with ``pre_burst_trigger`` when
    the recovery rode an earlier fire), ``recovered_at``, ``recovered`` and
    the post-recovery AUCs (None when nothing recovered).

    Re-init draws are keyed by frame index: frame i's from a CPU generator
    keyed (``seed``, i), the first pose's (``seed``, 10**6);
    ``reinit_draws(i)`` replaces them (a test passes JAX's). ``obj``: a
    ``synthetic_benchmark.BenchObject``. Returns ADD / ADD-S AUC over all
    frames and the re-init telemetry."""
    dev = obj.mesh.fverts.device
    draws_at = _reinit_draws(seed, reinit_draws)
    gt = np.asarray(gt)
    T = len(gt) - 1  # tracked frames (gt[0] is the init frame)
    rgb = _frames_on(frames_rgb, dev, depth=False)
    dep = _frames_on(frames_depth, dev, depth=True)
    fail_end = -1
    if fail_at is not None:
        fail_end = min(fail_at + fail_len, T)
        rgb, dep = rgb.clone(), dep.clone()
        rgb[1 + fail_at:1 + fail_end] = 0
        dep[1 + fail_at:1 + fail_end] = 0
    Kt = torch.as_tensor(np.asarray(K), dtype=torch.float32).to(dev)
    poses_out = np.zeros((T, 4, 4), np.float32)
    policy = hy.ReinitPolicy(threshold=threshold, patience=patience)
    reinits, fires = [], []
    cur_pose = noisy_init_pose(draws_at(INIT_INDEX), gt[0],
                               reinit_sensor).to(dev)
    start = 0  # index into tracked frames: frame i is gt[i + 1]
    while start < T:
        stop = min(start + chunk, T)
        poses, scores = hy.track_video_with_health(
            obj.model, obj.tcfg, obj.mesh, Kt, obj.mean, obj.std, cur_pose,
            rgb[1 + start:1 + stop], dep[1 + start:1 + stop])
        scores = scores.cpu().numpy()
        trig = None
        for j in range(stop - start):
            if policy.update(float(scores[j])):
                trig = j
                break
        take = (stop - start) if trig is None else (trig + 1)
        poses_np = poses.cpu().numpy()
        poses_out[start:start + take] = poses_np[:take]
        if trig is None:
            cur_pose = poses[stop - start - 1]
            start = stop
            continue
        fires.append(start + trig)
        start += take
        if fail_at is not None and fail_at <= start < fail_end:
            # re-detection would land inside the burst: hold the last
            # estimate through it and re-detect at the first clear frame (a
            # fire before the burst re-detects at once, as unforced)
            poses_out[start:fail_end] = poses_np[take - 1]
            start = fail_end
        if start < T:  # external re-detection at the next frame (noisy gt)
            cur_pose = noisy_init_pose(draws_at(start), gt[start],
                                       reinit_sensor).to(dev)
            reinits.append(start)
        policy.bad_streak = 0
    cloud = M.voxel_down_sample(obj.tm.verts, 0.005)
    all_poses = np.concatenate([gt[:1], poses_out], 0)
    add, adi = ME.batch_errors(all_poses, gt, cloud, device=dev)
    out = {
        "frames": int(T),
        "reinit_count": len(reinits),
        "reinit_frames": reinits,
        "add_auc": float(ME.vocap(add) * 100),
        "adi_auc": float(ME.vocap(adi) * 100),
        "add_mean_mm": float(add.mean() * 1000),
    }
    if fail_at is not None:
        recov = [r for r in reinits if r >= fail_end]
        out["fail_at"] = int(fail_at)
        out["fail_len"] = int(fail_end - fail_at)
        # the fire that triggered the recovery: the last one at or after
        # the onset and at or before the recovery frame
        burst_fires = [f for f in fires if f >= fail_at]
        trigger = ([f for f in burst_fires if recov and f <= recov[0]]
                   or [None])
        out["detection_latency"] = (
            int(trigger[-1]) - int(fail_at) + 1
            if recov and trigger[-1] is not None else None)
        out["pre_burst_trigger"] = bool(recov) and trigger[-1] is None
        out["recovered_at"] = int(recov[0]) if recov else None
        _recovery_scores(out, add, adi, out["recovered_at"])
    return out


def live_recovery_eval(obj, gt, frames_rgb, frames_depth, K, *,
                       samples: int = 4, threshold: float = 0.3,
                       patience: int = 2, refetch_every: int = 8,
                       seed: int = 33,
                       reinit_sensor: SensorModel = SensorModel(),
                       fail_at: int = 50, fail_len: int = 15,
                       pace_hz: float | None = 30.0,
                       sync_fetches: bool = False,
                       reinit_draws=None) -> dict:
    """Forced-occlusion recovery through the live path: a windowed
    ``StreamTracker`` at ``samples`` hypotheses whose background fetch feeds
    a ``ReinitPolicy`` and calls ``on_track_lost`` (the machinery of
    ``predict --track_mode stream --auto_reinit`` and the ROS node). The
    policy sees one health sample a refetch, so the latency is quantized by
    ``patience`` x ``refetch_every`` plus the fetch's round trip.

    A ``fail_len`` frame blackout starts at tracked frame ``fail_at``. The
    external detector (the callback) is blind during it (returns None); at
    the first fire on a clear frame it returns a noisy gt pose, which the
    stream applies at its next push. The policy is not re-armed after a
    blind fire (its streak restarts, as in the JAX module). ``pace_hz``
    paces the pushes like a camera (None: as fast as they go); every push is
    followed by a blocking pose read, the live consumer's pattern.
    ``sync_fetches`` waits for each push's background fetch before the next
    push, so the run does not depend on the thread's timing (tests).

    Re-init draws as :func:`long_horizon_eval`'s. Returns the detection and
    application telemetry, ADD / ADD-S AUC over all frames, ``recovered``,
    and the post-recovery AUCs (None when nothing recovered)."""
    from ..tracking.stream import StreamTracker

    draws_at = _reinit_draws(seed, reinit_draws)
    gt = np.asarray(gt)
    T = len(gt) - 1
    fail_end = min(fail_at + fail_len, T)

    def host(frames, dtype, top):
        a = frames.cpu().numpy() if torch.is_tensor(frames) else np.asarray(
            frames)
        a = np.array(a, copy=True)
        a[1 + fail_at:1 + fail_end] = 0
        if a.dtype != dtype:
            a = np.clip(np.round(a), 0, top).astype(dtype)
        return a

    rgb = host(frames_rgb, np.uint8, 255)
    dep = host(frames_depth, np.uint16, 65535)
    tr = trk.Tracker.from_parts(obj.model, obj.tcfg, obj.mesh, np.asarray(K),
                                obj.mean, obj.std)
    fires: list = []          # (fire frame index, score, detected?)
    applied: list = []        # push frame index where a re-init landed

    def on_lost(idx, score):
        if fail_at <= idx < fail_end:
            fires.append((int(idx), float(score), False))
            return None       # the detector cannot see an occluded object
        fires.append((int(idx), float(score), True))
        g = min(int(idx) + 1, T)
        return noisy_init_pose(draws_at(int(idx)), gt[g],
                               reinit_sensor).numpy()

    policy = hy.ReinitPolicy(threshold=threshold, patience=patience)
    s = StreamTracker(tr, window=True, samples=samples,
                      refetch_every=refetch_every, reinit_policy=policy,
                      on_track_lost=on_lost)
    orig_set = s.set_pose

    def set_pose(p):
        applied.append(int(s._frame_idx))
        orig_set(p)

    s.set_pose = set_pose
    init = noisy_init_pose(draws_at(INIT_INDEX), gt[0], reinit_sensor)
    s.begin(init.numpy(), image_hw=rgb.shape[1:3])
    period = 1.0 / pace_hz if pace_hz else 0.0
    t_next = time.perf_counter()
    try:
        for i in range(T):
            if period:
                t_next += period
                dt = t_next - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)
            s.push(rgb[1 + i], dep[1 + i])
            # the per-frame blocking pose read of a live consumer (the ROS
            # node broadcasts every frame): without it the host outruns the
            # card and the background fetch, hence the policy, stops
            # sampling
            s.current_pose()
            if sync_fetches:
                s.wait_fetch()
    finally:
        s.close()

    poses = s.poses()
    all_poses = np.concatenate([gt[:1], poses], 0)
    cloud = M.voxel_down_sample(obj.tm.verts, 0.005)
    add, adi = ME.batch_errors(all_poses, gt, cloud,
                               device=obj.mesh.fverts.device)
    det = [f for f, _, _ in fires if f >= fail_at]
    rec = [a for a in applied if a >= fail_end]
    out = {
        "frames": int(T),
        "fail_at": int(fail_at),
        "fail_len": int(fail_end - fail_at),
        "samples": int(samples),
        "patience": int(patience),
        "refetch_every": int(refetch_every),
        "pace_hz": pace_hz,
        "fires": [f for f, _, _ in fires],
        "track_lost_events": int(s.track_lost_events),
        # frames from the onset to the first fire at or after it
        "detection_latency": (int(det[0]) - fail_at + 1) if det else None,
        "reinit_applied_at": [int(a) for a in applied],
        "recovered_at": int(rec[0]) if rec else None,
        "add_auc": float(ME.vocap(add) * 100),
        "adi_auc": float(ME.vocap(adi) * 100),
    }
    _recovery_scores(out, add, adi, out["recovered_at"])
    return out
