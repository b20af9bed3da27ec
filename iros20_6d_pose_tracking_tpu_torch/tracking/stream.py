"""Pipelined per-frame ("live") tracking, in PyTorch: the deployment loop.

Counterpart of ``iros20_6d_pose_tracking_tpu/tracking/stream.py``. The
reference's product is a per-frame loop (reference predict.py:217-296), and
its ROS node runs that loop under a 60 Hz spin (reference
predict_ros.py:112-119). ``StreamTracker`` runs it without making the host
wait for the card:

  1. **A device-resident pose.** The 4x4 estimate stays on the device from
     frame to frame; ``push`` only enqueues work, and the consumer fetches
     poses when it needs them (``current_pose``, ``poses``).
  2. **Camera dtypes across the bus.** RGB and the two bytes of the uint16
     depth are packed into one (S, S, 5) uint8 buffer (two strided copies
     from the frame's slices) in pinned host memory, and copied with
     ``non_blocking=True`` (``tracker.upload_async``): one transfer a frame,
     and the host never waits for it. The caching host allocator keeps each
     pinned block until the copy that read it has run, so a fresh buffer a
     push is safe. On the device the frame is unpacked to uint8 RGB and
     int32 depth (byte 3 + 256 x byte 4), the integers
     ``tracker.upload_depth`` gives, so the step's crop sees what the
     full-frame path sees.
  3. **A windowed upload** (``window=True``). Only a square window around
     the object's last known position is packed and uploaded. Its centre
     comes from a lagged pose snapshot fetched on a background thread, and
     a velocity-adaptive pad absorbs the error of the constant-velocity
     prediction over the snapshot's staleness. Window sides are quantized to
     32 px with hysteresis (``_bucket``). The snapshot's copy is enqueued on
     the push thread, on a stream of its own behind the step that made the
     pose, into pinned memory; the fetch thread only waits for that copy's
     event.
  4. **Containment monitoring.** Windowing is exact only while the true ROI
     stays inside the uploaded window. Every snapshot re-checks the ROI of
     the fetched pose against the window actually used at that frame; a
     violation increments ``containment_violations``, widens the pad for
     good and recentres at once (``stats()``).
  5. **Exactness.** The ROI is computed from the true device pose in
     full-image coordinates (``track_step``'s ``frame_offset_vu``), so the
     windowed poses are the full-frame path's bits while the ROI lies inside
     the window.

At samples 1 a push replays a compiled program (``tracking/compiled.py``):
the stream keeps one program per window side (the full frame is one side),
as the JAX package keeps one jitted step per side, each captured as a CUDA
graph after its warm-up pushes; the unpacked window, its offset and the
device pose are copied into the program's static buffers. ``samples > 1``
refines N hypotheses a push (``hypotheses.track_step_multi``, eager),
their perturbations drawn from a ``torch.Generator`` on the device seeded
with the stream's frame index plus ``begin``'s ``first_frame``
(``Tracker.on_track`` seeds with its frame count: the two give the same bits
over the same frames).

Consumers: ``apps/predict.py --track_mode stream`` and
``apps/predict_ros.py``.
"""
from __future__ import annotations

import concurrent.futures as cf
from collections import deque

import numpy as np
import torch

from . import compiled
from . import hypotheses as hy
from . import tracker as trk


def pack_window_into(buf: np.ndarray, rgb_u8: np.ndarray,
                     depth_u16: np.ndarray) -> np.ndarray:
    """Pack (S, S, 3) uint8 + (S, S) uint16 views into a preallocated
    contiguous (S, S, 5) uint8 buffer: two strided copies straight from the
    frame slices, depth little-endian in bytes 3-4."""
    buf[..., :3] = rgb_u8
    buf[..., 3:5].view("<u2")[..., 0] = depth_u16
    return buf


def pack_window(rgb_u8: np.ndarray, depth_u16: np.ndarray) -> np.ndarray:
    """(S, S, 3) uint8 + (S, S) uint16 -> one contiguous (S, S, 5) uint8."""
    s = rgb_u8.shape[:2]
    return pack_window_into(np.empty(s + (5,), np.uint8), rgb_u8, depth_u16)


def unpack_window(packed: torch.Tensor):
    """(S, S, 5) uint8 -> (rgb (S, S, 3) uint8, depth (S, S) int32 mm)."""
    depth = (packed[..., 3].to(torch.int32)
             + packed[..., 4].to(torch.int32) * 256)
    return packed[..., :3], depth


class StreamTracker:
    """Per-frame pipelined tracking around a ``tracking.tracker.Tracker``.

    Usage::

        st = StreamTracker(tracker)          # or window=False for full frames
        st.begin(init_pose)
        for rgb_u8, depth_u16 in camera:     # HxWx3 uint8, HxW uint16 (mm)
            st.push(rgb_u8, depth_u16)
        poses = st.poses()                   # (T, 4, 4) float32, waits
        st.close()

    ``current_pose()`` waits for the latest estimate (for consumers that need
    per-frame output, e.g. the ROS TF broadcast); throughput-oriented
    consumers let the pipeline run free and fetch at the end.
    """

    def __init__(self, tracker, window: bool = True,
                 margin: float | None = None,
                 refetch_every: int = 8,
                 keep_history: bool = True, samples: int = 1,
                 base_pad_px: float = 24.0,
                 reinit_policy=None, on_track_lost=None):
        self.t = tracker
        # Closed-loop failure handling: ``reinit_policy`` (a
        # hypotheses.ReinitPolicy) is fed the depth-agreement health score
        # on the background fetch thread, one sample per centre refetch
        # (patience counts snapshots; detection takes about patience *
        # refetch_every frames). When it fires, ``on_track_lost(frame_idx,
        # score)`` runs on the fetch thread; a 4x4 pose it returns is
        # applied by the next push() through set_pose(). The score comes
        # from the multi-hypothesis step, hence samples >= 2.
        if reinit_policy is not None and samples < 2:
            raise ValueError("reinit_policy needs samples >= 2 "
                             "(health score comes from the "
                             "multi-hypothesis step)")
        self.reinit_policy = reinit_policy
        self.on_track_lost = on_track_lost
        self.track_lost_events = 0
        self._pending_reinit = None       # (gen, 4x4 pose) from callback
        self.window = window
        # margin=None: velocity-adaptive pad sizing; a float pins the
        # multiplicative sizing (side = ROI side * margin, 64 px quanta).
        self.margin = margin
        self.base_pad_px = float(base_pad_px)
        self._pad_boost = 0.0        # widened on containment violations
        self._rect_hist = {}         # frame_idx -> (top, left, side) used
        self.containment_violations = 0
        self.refetches = 0
        self.samples = int(samples)
        self._scores: list = []
        # Frames between refreshes of the host's window-centre estimate;
        # staleness is refetch_every + the fetch round-trip.
        self.refetch_every = max(1, refetch_every)
        # keep_history=False for unbounded live runs (the ROS node): only
        # the latest device pose is kept.
        self.keep_history = keep_history
        self._device = tracker.device
        self._K_np = tracker.K.cpu().numpy()
        self._pose_dev = None
        self._poses: list = []
        self._center_vu = None            # host estimate of the ROI centre
        self._side_px = None
        self._hw = None
        self._frame_idx = 0
        self._first_frame = 0             # draws' seed of push 0 (samples > 1)
        self._center_frame = 0            # frame the centre estimate is of
        self._offset_cache = {}           # (top, left) -> device int32 pair
        # one program a window side; big enough never to drop one
        self._programs = compiled.ProgramCache(size=64)
        self._fetcher = None              # lazy 1-thread executor
        self._fetch_future = None
        self._fetch_stream = None         # CUDA stream of the pose copies
        self._fetch_busy = False
        self._pending_center = None       # (gen, frame_idx, (centre, side))
        self._cur_bucket = None           # hysteresis state of _bucket
        self._center_hist: deque = deque(maxlen=2)  # (idx, vu) fetched
        self._gen = 0                     # bumped by begin()/set_pose(): an
                                          # in-flight fetch of an earlier
                                          # generation must not recentre
                                          # the re-initialized window

    # -- host-side ROI geometry (numpy mirror of ops/roi.compute_bbox) --
    def _host_bbox(self, pose: np.ndarray):
        K = self._K_np
        obj = pose[:3, 3] * 1000.0
        z = max(float(obj[2]), 1e-3)
        u = float(obj[0]) * K[0, 0] / z + K[0, 2]
        v = float(obj[1]) * K[1, 1] / z + K[1, 2]
        # the ROI is object_width*fx wide and object_width*fy tall: the
        # square window must cover the larger extent.
        side = self.t.cfg.object_width_mm * max(K[0, 0], K[1, 1]) / z
        return (v, u), side

    def _vel_px(self) -> float:
        """Window-centre speed (px/frame) from the last two snapshots."""
        if len(self._center_hist) == 2:
            (i0, c0), (i1, c1) = self._center_hist
            if i1 > i0:
                return float(np.linalg.norm(c1 - c0) / (i1 - i0))
        return 0.0

    def _bucket(self, side_px: float) -> int:
        """Quantized window side with hysteresis: grow as soon as the ROI
        needs it, shrink only when two quanta smaller. The pad absorbs the
        base uncertainty plus a velocity term for the unpredicted half of
        the staleness horizon; containment violations widen it for good
        (_pad_boost)."""
        if self.margin is not None:
            want = int(np.ceil(side_px * self.margin / 64.0)) * 64
        else:
            horizon = self.refetch_every + 6  # +fetch round-trip frames
            pad = (self.base_pad_px + self._pad_boost
                   + 0.5 * self._vel_px() * horizon)
            want = int(np.ceil((side_px + 2.0 * pad) / 32.0)) * 32
        H, W = self._hw
        want = int(min(max(want, 128), min(H, W)))
        cur = self._cur_bucket
        if cur is None or want > cur or want <= cur - 64:
            self._cur_bucket = want
        return self._cur_bucket

    def begin(self, init_pose: np.ndarray,
              image_hw: tuple[int, int] | None = None,
              first_frame: int = 0):
        """Start a stream at ``init_pose``. At samples > 1 the k-th push
        draws its hypotheses from a generator seeded ``first_frame + k``
        (the frame's index in a longer video)."""
        self._first_frame = int(first_frame)
        self._pose_dev = trk.upload_async(np.array(init_pose, np.float32),
                                          self._device)
        self._poses = [self._pose_dev]
        self._scores = []
        self._gen += 1          # poison in-flight pre-begin fetches
        self._pending_center = None
        self._pending_reinit = None
        self._frame_idx = 0
        self._center_frame = 0
        self._hw = image_hw
        self._center_vu, side = self._host_bbox(np.asarray(init_pose))
        self._side_px = side
        self._center_hist.clear()
        self._rect_hist = {}
        return self

    def _step(self, packed: torch.Tensor, offset):
        """One tracking update of the device pose on an uploaded packed
        window (or full frame). Returns (pose, score or None)."""
        t = self.t
        rgb, depth = unpack_window(packed)
        if self.samples > 1:
            gen = torch.Generator(self._device).manual_seed(
                self._first_frame + self._frame_idx)
            pose, score, _ = hy.track_step_multi(
                t.model, t.cfg, t.mesh, t.K, t.mean, t.std, self._pose_dev,
                rgb, depth, gen, samples=self.samples,
                frame_offset_vu=offset)
            return pose, score
        pose = self._programs.step(t.model, t.cfg, t.mesh, t.K, t.mean,
                                   t.std, self._pose_dev, rgb, depth,
                                   frame_offset_vu=offset)
        return pose, None

    def _start_fetch(self, pose: torch.Tensor, score):
        """Enqueue the copy of ``pose`` (and ``score``) to the host and
        return a function that waits for that copy alone and gives (pose
        (4, 4) numpy, score float or None). On a CUDA device the copy runs
        on a stream of its own, behind the work already queued that makes
        the pose, into pinned buffers; the tensors are recorded on that
        stream so the caching allocator does not hand their memory to a
        later step before the copy has read it."""
        if pose.device.type != "cuda":
            return lambda: (pose.numpy(),
                            None if score is None else float(score))
        if self._fetch_stream is None:
            self._fetch_stream = torch.cuda.Stream(pose.device)
        stream = self._fetch_stream
        host = torch.empty((4, 4), dtype=torch.float32, pin_memory=True)
        host_score = None if score is None else torch.empty(
            (), dtype=torch.float32, pin_memory=True)
        done = torch.cuda.Event()
        stream.wait_stream(torch.cuda.current_stream(pose.device))
        with torch.cuda.stream(stream):
            host.copy_(pose, non_blocking=True)
            pose.record_stream(stream)
            if score is not None:
                host_score.copy_(score, non_blocking=True)
                score.record_stream(stream)
            done.record(stream)

        def wait():
            done.synchronize()
            return host.numpy(), (None if host_score is None
                                  else float(host_score))

        return wait

    def _update_center(self):
        """Consume the latest background pose snapshot (if any) and, every
        ``refetch_every`` frames, start the copy of the current device pose
        and hand its wait to the fetch thread. Never waits for the
        device."""
        pending = self._pending_center
        if pending is not None:
            self._pending_center = None
            gen, idx, (vu, side) = pending
            if gen == self._gen and idx >= self._center_frame:
                self._center_vu, self._side_px = vu, side
                self._center_frame = idx
                self._center_hist.append((idx, np.asarray(vu, np.float64)))
        if (self._frame_idx - self._center_frame >= self.refetch_every
                and not self._fetch_busy):
            if self._fetcher is None:
                self._fetcher = cf.ThreadPoolExecutor(
                    1, thread_name_prefix="stream-pose-fetch")
            fut, self._fetch_future = self._fetch_future, None
            if fut is not None:
                fut.result()  # done but for its return: raise what it raised
            self._fetch_busy = True
            self.refetches += 1
            idx, gen = self._frame_idx, self._gen
            # the rect a step at `idx` will consume is the one push() is
            # about to record; idx-1's rect is the newest already recorded
            rect = self._rect_hist.get(idx - 1)
            score_dev = self._scores[-1] if self._scores else None
            fetched = self._start_fetch(self._pose_dev, score_dev)

            def work():
                try:
                    pose, sc = fetched()
                    vu_side = self._host_bbox(pose)
                    if rect is not None and self._roi_escaped(
                            vu_side[0], vu_side[1], rect):
                        # the true ROI left the uploaded window: count it,
                        # widen the pad for every future window, and let
                        # the fresh centre recentre the stream.
                        self.containment_violations += 1
                        self._pad_boost += 16.0
                    self._pending_center = (gen, idx, vu_side)
                    if self.reinit_policy is not None and sc is not None:
                        if self.reinit_policy.update(sc):
                            self.reinit_policy.bad_streak = 0
                            self.track_lost_events += 1
                            new = None
                            if self.on_track_lost is not None:
                                new = self.on_track_lost(idx, sc)
                            if new is not None:
                                self._pending_reinit = (
                                    gen, np.asarray(new, np.float32))
                finally:
                    self._fetch_busy = False

            self._fetch_future = self._fetcher.submit(work)

    def _roi_escaped(self, vu, side: float, rect) -> bool:
        """True if the (image-clipped) ROI square of a true pose sticks out
        of the window rect actually uploaded. Pixels outside the image are
        zero in both the full-frame and the windowed paths (the crop
        zero-masks them), so only the in-image part of the ROI must be
        covered. 1 px tolerance for rounding."""
        H, W = self._hw
        top, left, wside = rect
        v0 = max(vu[0] - side / 2, 0.0)
        v1 = min(vu[0] + side / 2, float(H))
        u0 = max(vu[1] - side / 2, 0.0)
        u1 = min(vu[1] + side / 2, float(W))
        tol = 1.0
        return (v0 < top - tol or u0 < left - tol
                or v1 > top + wside + tol or u1 > left + wside + tol)

    def stats(self) -> dict:
        """Live-loop health counters (cumulative). ``compiled_programs``
        counts the stream's compiled programs, one per window side used so
        far at samples 1 (each captured as a CUDA graph once warm on a CUDA
        device), as the JAX package counts its jitted steps; the eager
        samples > 1 step makes none."""
        return {
            "containment_violations": self.containment_violations,
            "pad_boost_px": self._pad_boost,
            "refetches": self.refetches,
            "bucket": self._cur_bucket,
            "compiled_programs": len(self._programs),
            "track_lost_events": self.track_lost_events,
        }

    def _predicted_center(self):
        """Constant-velocity extrapolation of the window centre through the
        last two snapshots, the horizon capped so that a bad velocity does
        not throw the window across the image."""
        if len(self._center_hist) == 2:
            (i0, c0), (i1, c1) = self._center_hist
            if i1 > i0:
                vel = (c1 - c0) / (i1 - i0)
                ahead = min(self._frame_idx - i1, 3 * self.refetch_every)
                pred = c1 + vel * ahead
                return float(pred[0]), float(pred[1])
        return self._center_vu

    def _offset_dev(self, top: int, left: int):
        key = (top, left)
        dev = self._offset_cache.get(key)
        if dev is None:
            if len(self._offset_cache) > 256:
                self._offset_cache.clear()
            dev = trk.upload_async(np.asarray([top, left], np.int32),
                                   self._device)
            self._offset_cache[key] = dev
        return dev

    def push(self, rgb_u8: np.ndarray, depth_u16: np.ndarray) -> None:
        """Enqueue one tracking update. Never waits for the device."""
        if self._hw is None:
            self._hw = rgb_u8.shape[:2]
        pending = self._pending_reinit
        if pending is not None:
            self._pending_reinit = None
            rgen, rpose = pending
            if rgen == self._gen:  # not already superseded by set_pose()
                self.set_pose(rpose)
        if not self.window:
            offset = None
        else:
            self._update_center()
            H, W = self._hw
            side = self._bucket(self._side_px)
            cv, cu = self._predicted_center()
            top = int(np.clip(round(cv - side / 2), 0, max(H - side, 0)))
            left = int(np.clip(round(cu - side / 2), 0, max(W - side, 0)))
            rgb_u8 = rgb_u8[top:top + side, left:left + side]
            depth_u16 = depth_u16[top:top + side, left:left + side]
            self._rect_hist[self._frame_idx] = (top, left, side)
            if len(self._rect_hist) > 300:
                cut = self._frame_idx - 256
                self._rect_hist = {k: v for k, v in self._rect_hist.items()
                                   if k >= cut}
            offset = self._offset_dev(top, left)
        buf = trk.staging_buffer(rgb_u8.shape[:2] + (5,), torch.uint8,
                                 self._device)
        pack_window_into(buf.numpy(), rgb_u8, depth_u16)
        new_pose, score = self._step(trk.upload_async(buf, self._device),
                                     offset)
        if score is not None:
            if self.keep_history:
                self._scores.append(score)
            else:
                self._scores = [score]
        self._pose_dev = new_pose
        if self.keep_history:
            self._poses.append(new_pose)
        self._frame_idx += 1

    def set_pose(self, pose: np.ndarray) -> None:
        """Re-initialize mid-stream (reference predict.py:539-541
        --reinit_frames semantics) without breaking the pipeline."""
        self._pose_dev = trk.upload_async(np.array(pose, np.float32),
                                          self._device)
        self._center_vu, self._side_px = self._host_bbox(np.asarray(pose))
        self._center_frame = self._frame_idx
        self._gen += 1          # poison in-flight pre-reinit fetches
        self._pending_center = None
        self._center_hist.clear()
        self._rect_hist = {}

    def current_pose(self) -> np.ndarray:
        """Latest estimate (waits until its computation completes)."""
        return self._pose_dev.cpu().numpy()

    def poses(self, include_init: bool = False) -> np.ndarray:
        """All poses so far as (T, 4, 4) float32, in one fetch. Waits."""
        out = self._poses if include_init else self._poses[1:]
        if not out:
            return np.zeros((0, 4, 4), np.float32)
        return torch.stack(out).cpu().numpy()

    def scores(self) -> np.ndarray:
        """Per-frame depth-agreement health (samples > 1 only), for
        ``hypotheses.ReinitPolicy``. Waits. With keep_history=False only
        the latest is kept."""
        if not self._scores:
            return np.zeros((0,), np.float32)
        return torch.stack(self._scores).cpu().numpy().astype(np.float32)

    def wait_fetch(self) -> None:
        """Wait for the background pose fetch in flight, if any (its centre
        update and policy check), and raise what it raised; the thread keeps
        running. A caller that waits after every push makes the stream's
        re-inits independent of the thread's timing."""
        if self._fetch_future is not None:
            self._fetch_future.result()

    def close(self) -> None:
        """Wait for the background pose fetch, stop its thread, and raise
        what it raised."""
        if self._fetcher is not None:
            self._fetcher.shutdown(wait=True)
            self._fetcher = None
        fut, self._fetch_future = self._fetch_future, None
        if fut is not None:
            fut.result()
