"""Adaptive choice of how a whole video is tracked, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/tracking/dispatch.py``. The JAX
package probes dispatch granularities because a long fused scan collapsed on
a shared TPU while per-frame dispatch of the same step did not. Here every
candidate runs the same step, so the modes differ only in how the host
drives it:

  - ``c > 1``: ``tracker.track_video`` over ``c`` frames of the chunk on the
    device at a time, replays of the compiled video program
    (``hypotheses.track_video_multi``, eager, at samples > 1);
  - ``c == 1``: ``compiled.track_step`` frame by frame into a preallocated
    (L, 4, 4) tensor, replays of the compiled one-frame program, as JAX
    dispatches its jitted step (``hypotheses.track_step_multi``);
  - ``0`` (``STREAM``): the port's ``StreamTracker`` pushed the host chunk's
    frames (windowed packed uploads).

Every mode computes the same bits: the step of every frame is the same, the
pose is carried on the device from segment to segment, and at samples > 1
frame ``g`` of a ``track`` call draws its hypotheses from a generator seeded
``seed + g`` in every mode (JAX's modes split their key streams differently
and agree only statistically). So the probe segments are real work, and the
poses are kept.

Probing as in JAX: each candidate first runs one dispatch (8 pushes for the
stream); if that alone is 3x slower per frame than the best mode measured
since the probe began, its sample is kept and the candidate skipped, else
it runs about ``probe_frames`` frames more. The fastest sampled mode then
runs the rest, each steady segment timed; one slower than
``reprobe_factor`` x its sample starts a new probe of every other
candidate, the stream included. Unlike JAX, a reprobe keeps the other
modes' earlier samples in ``probe_ms_per_frame`` until each is measured
again. Every segment's time ends with its last pose fetched to the host: an
enqueue, eager or a replay, returns long before the card has run it.

Host chunks are loaded on one background thread while the device tracks the
previous chunk. The last chunk is not padded: it tracks exactly its own
frames, and a tail that fits no program of the mode runs per frame
(``fill``). Sources already on the device (tensors) are tracked as one
chunk with no upload. ``warmup`` / the first chunk run every candidate on
one frame until its program is captured (``compiled.WARMUP_CALLS`` + 1
calls), so no probe segment times an nvcc build, cuDNN's first call or a
capture.

Consumers: ``Tracker.track_video_adaptive`` and ``apps/predict.py
--track_mode adaptive``.
"""
from __future__ import annotations

import concurrent.futures as cf
import time

import numpy as np
import torch

from . import compiled
from . import hypotheses as hy
from . import tracker as trk


class AdaptiveVideoTracker:
    """Runtime choice of the dispatch granularity around a ``Tracker``.

    Args:
      tracker: a ``tracking.tracker.Tracker``.
      candidates: frames per dispatch to consider. 1 is the per-frame step,
        0 the windowed stream (needs host sources), any other ``c`` runs
        ``track_video`` over ``c`` frames at a time. ``chunk_size`` must be
        a multiple of every ``c >= 1``.
      probe_frames: frames spent probing each candidate (a candidate with
        ``c >= probe_frames`` probes on one dispatch).
      reprobe_factor: a steady segment slower than its mode's sample times
        this starts a new probe.
      samples: hypotheses per frame (1: single hypothesis).
      seed: the draws' key of a ``track`` call's first frame: frame ``g``
        draws from a generator seeded ``seed + g`` (``Tracker.on_track``
        seeds with ``frame_cnt``).
    """

    STREAM = 0

    def __init__(self, tracker, candidates=(100, 10, 1, 0),
                 probe_frames: int = 20, reprobe_factor: float = 2.0,
                 samples: int = 1, seed: int = 0):
        self.t = tracker
        self.candidates = tuple(int(c) for c in candidates)
        if any(c < 0 for c in self.candidates) or \
                len(set(self.candidates)) != len(self.candidates):
            raise ValueError(f"candidates must be distinct and >= 0, got "
                             f"{self.candidates}")
        self.probe_frames = int(probe_frames)
        self.reprobe_factor = float(reprobe_factor)
        self.samples = int(samples)
        self.seed = int(seed)
        self._stream = None
        self._warmed: set = set()
        # telemetry of the last track() call
        self.mode = None
        self.settled = None  # False: the video ended mid-probe, and mode is
        #                      the best sample so far
        self.probe_ms_per_frame: dict = {}
        self._probe1: dict = {}   # mode -> its one-dispatch sample (ms)
        self._fresh: set = set()  # modes sampled since the probe began
        self.reprobes = 0
        self.segments: list = []  # (mode, frames, ms_per_frame, phase)

    # -- segment runners: each returns the pose after frame b - 1 --

    def _args(self):
        t = self.t
        return t.model, t.cfg, t.mesh, t.K, t.mean, t.std

    def _run_scan(self, pose, buf, sbuf, rgb, dep, a, b, c, g0):
        """Frames [a, b) as ``track_video`` calls of ``c`` frames."""
        for s in range(a, b, c):
            if self.samples > 1:
                poses, sbuf[s:s + c] = hy.track_video_multi(
                    *self._args(), pose, rgb[s:s + c], dep[s:s + c],
                    samples=self.samples, first_frame=self.seed + g0 + s)
            else:
                poses = trk.track_video(*self._args(), pose, rgb[s:s + c],
                                        dep[s:s + c])
            buf[s:s + c] = poses
            pose = poses[-1]
        return pose

    def _run_per_frame(self, pose, buf, sbuf, rgb, dep, a, b, g0):
        """Frames [a, b) one ``track_step`` each."""
        for i in range(a, b):
            if self.samples > 1:
                gen = torch.Generator(self.t.device).manual_seed(
                    self.seed + g0 + i)
                pose, sbuf[i], _ = hy.track_step_multi(
                    *self._args(), pose, rgb[i], dep[i], gen,
                    samples=self.samples)
            else:
                pose = compiled.track_step(*self._args(), pose, rgb[i],
                                           dep[i])
            buf[i] = pose
        return pose

    def _get_stream(self):
        if self._stream is None:
            from .stream import StreamTracker

            self._stream = StreamTracker(self.t, window=True,
                                         samples=self.samples)
        return self._stream

    def _run_stream(self, pose, buf, sbuf, rgb_np, dep_np, a, b, g0):
        """Frames [a, b) of the host chunk pushed through the windowed
        StreamTracker, begun at the device pose; its poses (and scores) go
        into the chunk's buffers."""
        s = self._get_stream()
        if rgb_np.dtype != np.uint8:
            rgb_np = np.clip(np.round(rgb_np), 0, 255).astype(np.uint8)
        if dep_np.dtype != np.uint16:
            dep_np = np.clip(np.round(dep_np), 0, 65535).astype(np.uint16)
        s.begin(pose.cpu().numpy(), image_hw=rgb_np.shape[1:3],
                first_frame=self.seed + g0 + a)
        for i in range(a, b):
            s.push(rgb_np[i], dep_np[i])
        buf[a:b] = torch.from_numpy(s.poses()).to(buf.device)
        if sbuf is not None:
            sbuf[a:b] = torch.from_numpy(s.scores()).to(sbuf.device)
        return buf[b - 1]

    def _run_segment(self, mode, phase, pose, buf, sbuf, rgb, dep, a, b, g0,
                     rgb_np=None, dep_np=None):
        """Run and time frames [a, b) in ``mode``. The clock stops once the
        segment's last pose is on the host: every frame's step depends on
        the one before, so that covers all of the segment's work."""
        t0 = time.perf_counter()
        if mode == self.STREAM:
            pose = self._run_stream(pose, buf, sbuf, rgb_np, dep_np, a, b, g0)
        elif mode == 1:
            pose = self._run_per_frame(pose, buf, sbuf, rgb, dep, a, b, g0)
        else:
            pose = self._run_scan(pose, buf, sbuf, rgb, dep, a, b, mode, g0)
        pose.cpu()
        ms = (time.perf_counter() - t0) / max(b - a, 1) * 1e3
        self.segments.append((mode, b - a, round(ms, 3), phase))
        return pose, ms

    def _buffers(self, L):
        dev = self.t.device
        buf = torch.empty((L, 4, 4), dtype=torch.float32, device=dev)
        sbuf = (torch.empty((L,), dtype=torch.float32, device=dev)
                if self.samples > 1 else None)
        return buf, sbuf

    def _ensure_warm(self, pose, rgb, dep, rgb_np=None, dep_np=None):
        """Run every candidate on the chunk's first frame (the stream where
        host frames are given) into scratch buffers until its program is
        captured, so that no probe segment times a kernel build, cuDNN's
        first call or a capture. Every ``c > 1`` shares one video program
        whatever its segment length, so a one-frame video warms them all.
        Once per frame shape and dtypes."""
        key = (tuple(rgb.shape[1:]), rgb.dtype, dep.dtype, rgb_np is not None)
        if key in self._warmed:
            return
        n = compiled.WARMUP_CALLS + 1
        buf, sbuf = self._buffers(n)
        for c in self.candidates:
            if c == self.STREAM:
                if rgb_np is not None:
                    self._run_stream(pose, buf, sbuf, rgb_np[:1].repeat(n, 0),
                                     dep_np[:1].repeat(n, 0), 0, n, 0)
            else:
                for _ in range(n):
                    if c == 1:
                        self._run_per_frame(pose, buf, sbuf, rgb, dep, 0, 1,
                                            0)
                    else:
                        self._run_scan(pose, buf, sbuf, rgb, dep, 0, 1, 1, 0)
        buf.cpu()
        self._warmed.add(key)

    def warmup(self, rgb_u8: np.ndarray, depth_u16: np.ndarray,
               init_pose: np.ndarray, chunk_size: int = 100):
        """Run every candidate on one frame until its program is captured,
        so that the first real ``track`` measures execution, not kernel
        builds or captures. ``chunk_size`` is kept from the JAX signature
        (whose programs are specialised to the chunk); the port's video
        program does not depend on it."""
        dev = self.t.device
        pose = torch.as_tensor(np.asarray(init_pose),
                               dtype=torch.float32).to(dev)
        rgb_np, dep_np = np.asarray(rgb_u8)[None], np.asarray(depth_u16)[None]
        try:
            self._ensure_warm(pose, trk.upload_rgb(rgb_np, dev),
                              trk.upload_depth(dep_np, dev), rgb_np, dep_np)
        finally:
            self.close()
        self.segments = []

    def close(self) -> None:
        """Stop the stream candidate's pose-fetch thread (``track`` and
        ``warmup`` call it on their way out)."""
        if self._stream is not None:
            self._stream.close()

    def track(self, init_pose, rgb_source, depth_source,
              n_frames: int | None = None, chunk_size: int = 100):
        """Track a video, choosing the dispatch granularity as it goes.

        Sources follow ``Tracker.track_video_chunked``: arrays or callables
        ``f(start, stop) -> np.ndarray``, loaded a chunk ahead on a
        background thread. Tensors are the device-resident path: the whole
        video is one chunk (moved to the tracker's device if it is not
        there), candidates may be as long as the video, and the stream is
        not a candidate.

        Returns (poses (T, 4, 4) float32, scores (T,) float32 or None):
        scores only when samples > 1. Telemetry lands on self (mode,
        settled, probe_ms_per_frame, reprobes, segments).
        """
        if n_frames is None:
            if callable(rgb_source) or callable(depth_source):
                raise ValueError("n_frames is required with callable sources")
            n_frames = len(rgb_source)
        if n_frames == 0:
            return np.zeros((0, 4, 4), np.float32), None
        dev = self.t.device
        resident = torch.is_tensor(rgb_source)
        if resident:
            chunk_size = n_frames
            if self.STREAM in self.candidates:
                raise ValueError("the stream candidate needs host sources")
            if any(c > n_frames for c in self.candidates):
                raise ValueError(f"a candidate of {self.candidates} is longer "
                                 f"than the resident video ({n_frames})")
        elif any(c != self.STREAM and chunk_size % c for c in
                 self.candidates):
            raise ValueError(f"chunk_size {chunk_size} is not a multiple of "
                             f"every candidate of {self.candidates}")

        self.mode = None
        self.probe_ms_per_frame = {}
        self._probe1 = {}
        self._fresh = set()
        self.reprobes = 0
        self.segments = []
        pending = list(self.candidates)  # modes still to probe
        chosen = None
        pose = torch.as_tensor(np.asarray(init_pose),
                               dtype=torch.float32).to(dev)
        out_chunks, score_chunks = [], []

        def run_chunk(g0, rgb, dep, rgb_np=None, dep_np=None):
            nonlocal pending, chosen, pose
            L = rgb.shape[0]
            self._ensure_warm(pose, rgb, dep, rgb_np, dep_np)
            buf, sbuf = self._buffers(L)
            a = 0
            while a < L:
                phase = "steady"
                if pending:
                    mode = pending[0]
                    # the stream's one-dispatch sample is 8 pushes: a single
                    # push measures begin()'s round trip, not the pipeline
                    step1 = 8 if mode == self.STREAM else mode
                    if L - a >= step1:
                        if mode not in self._probe1:
                            b, phase = a + step1, "probe1"
                        else:
                            g = max(mode, 1)
                            n = max(g, -(-self.probe_frames // g) * g)
                            b, phase = a + min(n, ((L - a) // g) * g), "probe"
                    else:  # the tail fits no dispatch of this mode: per frame
                        mode, b, phase = 1, L, "fill"  # now, probe it next chunk
                else:
                    mode = chosen
                    if mode == self.STREAM:
                        b = L
                    elif L - a >= mode:
                        b = a + ((L - a) // mode) * mode
                    else:
                        mode, b, phase = 1, L, "fill"
                pose, ms = self._run_segment(mode, phase, pose, buf, sbuf,
                                             rgb, dep, a, b, g0, rgb_np,
                                             dep_np)
                if phase == "probe1":
                    self._probe1[mode] = ms
                    fresh = [self.probe_ms_per_frame[m] for m in self._fresh]
                    hopeless = bool(fresh) and ms > 3.0 * min(fresh)
                    # a sample for the table even if the video ends before
                    # the second stage
                    self.probe_ms_per_frame[mode] = round(ms, 3)
                    self._fresh.add(mode)
                    if hopeless or (mode != self.STREAM
                                    and mode >= self.probe_frames):
                        pending.pop(0)
                elif phase == "probe":
                    self.probe_ms_per_frame[mode] = round(ms, 3)
                    self._fresh.add(mode)
                    pending.pop(0)
                if not pending and chosen is None:
                    chosen = min(self.probe_ms_per_frame,
                                 key=self.probe_ms_per_frame.get)
                    self.mode = chosen
                if phase == "steady" and ms > self.reprobe_factor \
                        * self.probe_ms_per_frame[chosen]:
                    # The device changed mid-video: this segment is the
                    # chosen mode's new sample, and every other candidate is
                    # probed again. Their earlier samples stay in the table
                    # until then (JAX wipes them).
                    self.reprobes += 1
                    self.probe_ms_per_frame[chosen] = round(ms, 3)
                    self._probe1 = {chosen: ms}
                    self._fresh = {chosen}
                    pending = [c for c in self.candidates if c != chosen]
                    chosen, self.mode = None, None
                a = b
            out_chunks.append(buf.cpu().numpy())
            if sbuf is not None:
                score_chunks.append(sbuf.cpu().numpy())

        try:
            if resident:
                dep = depth_source.to(dev) if torch.is_tensor(depth_source) \
                    else trk.upload_depth(depth_source, dev)
                run_chunk(0, rgb_source.to(dev), dep)
            else:
                def source(src):
                    return src if callable(src) else (lambda a, b: src[a:b])

                get_rgb, get_dep = source(rgb_source), source(depth_source)

                def load(a, b):
                    return (np.ascontiguousarray(get_rgb(a, b)),
                            np.ascontiguousarray(get_dep(a, b)))

                with cf.ThreadPoolExecutor(1) as ex:
                    fut = ex.submit(load, 0, min(chunk_size, n_frames))
                    for a0 in range(0, n_frames, chunk_size):
                        b0 = min(a0 + chunk_size, n_frames)
                        rgb_np, dep_np = fut.result()
                        if b0 < n_frames:
                            fut = ex.submit(load, b0,
                                            min(b0 + chunk_size, n_frames))
                        run_chunk(a0, trk.upload_rgb(rgb_np, dev),
                                  trk.upload_depth(dep_np, dev), rgb_np,
                                  dep_np)
        finally:
            self.close()
        poses = np.concatenate(out_chunks, axis=0)
        scores = (np.concatenate(score_chunks, axis=0) if score_chunks
                  else None)
        self.settled = chosen is not None
        if chosen is None and self.probe_ms_per_frame:
            # The video ended mid-probe: report the mode the dispatcher
            # would settle to, marked by settled=False.
            self.mode = min(self.probe_ms_per_frame,
                            key=self.probe_ms_per_frame.get)
        return poses, scores

    def telemetry(self) -> dict:
        return {
            "mode": self.mode,
            "settled": self.settled,
            "probe_ms_per_frame": dict(self.probe_ms_per_frame),
            "reprobes": self.reprobes,
            "n_segments": len(self.segments),
        }

    def steady_ms_per_frame(self) -> float | None:
        """The best steady segment in the chosen mode: the rate the
        dispatcher delivers once settled. If the video ended mid-probe, the
        best segment of that mode, else the best segment of any."""
        post = [ms for m, n, ms, ph in self.segments
                if ph == "steady" and m == self.mode]
        if not post and self.mode is not None:
            post = [ms for m, n, ms, ph in self.segments if m == self.mode]
        if not post:
            post = [ms for m, n, ms, ph in self.segments]
        return min(post) if post else None
