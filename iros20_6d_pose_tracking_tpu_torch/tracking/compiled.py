"""The compiled tracking step: one CUDA graph per static key, replayed.

Counterpart of ``jax.jit(track_step)`` and of the nested ``lax.scan`` of
``frame_scan`` in ``iros20_6d_pose_tracking_tpu/tracking/tracker.py``. In
JAX the whole step is one XLA program, compiled once per static shape, and
a video is that program under a scan: no host round trip between frames.
Eager PyTorch issues each of the step's ~520 operations from the host, so
the host, not the card, sets the rate. A :class:`StepProgram` captures the
eager :func:`~.tracker.track_step` once as a ``torch.cuda.CUDAGraph`` and
replays it on every later frame:

  - **Static buffers.** The graph reads and writes fixed addresses: the
    program owns ``slots`` frames (RGB and depth in the caller's dtypes),
    K, mean and std, the optional ``frame_offset_vu``, the carried pose,
    one output pose a slot, and the slot index ``idx``, an int64 scalar on
    the device. A call copies its inputs in and its poses out.
  - **The device-side scan.** One step reads slot ``idx``, writes
    ``poses[idx]``, carries the pose in its buffer and advances ``idx``
    modulo ``slots``, all inside the graph: a video of T frames is T
    replays with no host tensor operation between them, but one copy of
    the next ``slots`` frames after every ``slots`` replays. The step is not
    unrolled (k = 1): the per-frame entry points need one frame a replay,
    and one graph serves both. Copying a video into the static slots costs
    the card about 4 bytes of traffic a pixel channel, far below one step;
    capturing again for every new video buffer would cost a capture per
    call (``tracking/dispatch.py`` hands over a slice per segment).
  - **The key.** A program is built for one key (:func:`step_key`): the
    config, the model's class, ``training`` flag and the shape, data
    pointer and version counter of each parameter and buffer, the same of
    every mesh tensor, the frame's shape and dtype, the pose's shape (N
    views), whether ``frame_offset_vu`` is given, ``object_width_mm`` (a
    float the host reads) and ``slots``. A graph reads the pointers it was
    captured with, so a mesh sliced anew, a model moved with ``.to()`` or
    updated in place gets a program of its own; K, mean and std are copied
    in on every call and enter the key by shape only. A program asked for
    another key raises.
  - **Warm-up, then capture.** The first :data:`WARMUP_CALLS` calls of a
    program run the same body eagerly on a side stream (they are real
    frames: their poses are kept), so every kernel is loaded, cuDNN has
    chosen its algorithms and a bf16 model's bfloat16 weight copies are
    made and held (``models/tracknet.weight_as``) before the next call
    captures the body and replays it: the graph reads the held copies and
    casts no weight. The program keeps those copies, and their parameters'
    storages, for as long as it lives (``tracknet.held_weights``): no
    address its graph reads is freed or reused, so a program whose key
    matches again reads the weights it was captured with. A failed capture
    or replay raises; nothing falls back to the eager step on the card.
  - **Counters.** The step counts on the host (``utils/profiling.count``:
    the kernel wrappers' launches, the refiner's rounds and attention
    tokens, the weight casts and held copies, whatever its body counts),
    and a replay runs no Python. The capture reads every counter before
    and after its body; what moved is what the body counted. The capture
    ran nothing, so that goes back, and every replay adds it once: a
    replayed frame counts what an eager frame counts, with no list of
    names to keep.
  - **Rounds.** The model's ``refine_iterations`` rounds of a frame (two
    for FoundationPose's refiner, each rendering at the last round's pose)
    are all in the one graph: a frame is one replay.
  - **Spans and counters** (``utils/profiling.py``). A call records
    ``compiled.key`` (the key and the cache's lookup), ``compiled.load``
    (K, mean, std, the pose and one frame copied in) or, for a video,
    ``compiled.fill`` (a block of ``slots`` frames copied in) and
    ``compiled.gather`` (its poses copied out), and a frame exactly one of
    ``compiled.eager``, ``compiled.capture`` (the capture and its first
    replay) or ``compiled.replay``. Nothing is recorded inside the
    captured body: it runs once, at the capture. The counter
    ``compiled.captures`` counts captures (each stalls its caller for
    12-26 ms on the card); ``compiled.replays`` and
    ``compiled.eager_calls`` read the live programs' own counts.

On the CPU the same bookkeeping runs the body eagerly on every call: the
tests hold it against the eager loop bit for bit.

Callers: ``tracker.track_video`` (and through it ``Tracker.track_video``,
``track_video_chunked``, predict's scan, the dispatcher's ``c > 1``
segments, ``evaluate_tracking`` and ``spmd``'s serial loop),
``Tracker.on_track(samples=1)``, the dispatcher's ``c == 1`` mode
(:func:`track_step`), and ``StreamTracker`` at samples 1 (a
:class:`ProgramCache` of its own, one program a window side).
"""
from __future__ import annotations

import time
import weakref
from collections import OrderedDict

import torch

from ..models import tracknet
from ..utils import profiling
from . import tracker as trk

WARMUP_CALLS = 3
VIDEO_SLOTS = 32
CACHE_SIZE = 16

_module_lists = weakref.WeakKeyDictionary()
_live = weakref.WeakSet()  # every StepProgram not yet collected
profiling.count("compiled.captures", 0)  # listed before the first capture
profiling.register("compiled.replays",
                   lambda: sum(p.replays for p in list(_live)))
profiling.register("compiled.eager_calls",
                   lambda: sum(p.eager_calls for p in list(_live)))


def _tensor_key(t):
    if t is None:
        return None
    return (tuple(t.shape), t.data_ptr(),
            0 if t.is_inference() else t._version)


def _model_key(model):
    """Every parameter's and buffer's shape, pointer and version, read
    through the model's module list, which is taken once per model."""
    mods = _module_lists.get(model)
    if mods is None:
        mods = _module_lists[model] = list(model.modules())
    return (type(model), model.training, tuple([
        _tensor_key(t) for m in mods for d in (m._parameters, m._buffers)
        for t in d.values() if t is not None]))


def _spec(t):
    return None if t is None else (tuple(t.shape), t.dtype)


def step_key(model, cfg, mesh, K, mean, std, pose, frame_rgb,
             frame_depth_mm, object_width_mm=None, frame_offset_vu=None,
             slots: int = 1) -> tuple:
    """The static key of a program: what its graph reads by address or
    bakes in. ``pose`` and the frame are one frame's ((4, 4) or (N, 4, 4);
    (H, W, 3) and (H, W)); K, mean and std enter by shape and dtype."""
    return (cfg, _model_key(model), tuple(_tensor_key(f) for f in mesh),
            _spec(K), _spec(mean), _spec(std), _spec(pose), _spec(frame_rgb),
            _spec(frame_depth_mm), _spec(frame_offset_vu),
            None if object_width_mm is None else float(object_width_mm),
            int(slots))


class StepProgram:
    """``track_step`` for one key (:func:`step_key`), captured as a CUDA
    graph after :data:`WARMUP_CALLS` eager calls and replayed after that;
    run eagerly on every call on the CPU. ``slots`` frames are held at a
    time. Built from one call's arguments, for that call's key."""

    def __init__(self, model, cfg, mesh, K, mean, std, pose, frame_rgb,
                 frame_depth_mm, object_width_mm=None, frame_offset_vu=None,
                 slots: int = 1):
        self.key = step_key(model, cfg, mesh, K, mean, std, pose, frame_rgb,
                            frame_depth_mm, object_width_mm, frame_offset_vu,
                            slots)
        self.device = mesh.fverts.device
        self.slots = int(slots)
        self.object_width_mm = object_width_mm
        dev = self.device

        def buf(t, lead=()):
            return torch.zeros(lead + tuple(t.shape), dtype=t.dtype,
                               device=dev)

        self.rgb = buf(frame_rgb, (self.slots,))
        self.depth = buf(frame_depth_mm, (self.slots,))
        self.K, self.mean, self.std = buf(K), buf(mean), buf(std)
        self.offset = None if frame_offset_vu is None else buf(
            frame_offset_vu)
        self.pose = torch.zeros(pose.shape, dtype=torch.float32, device=dev)
        self.poses = torch.zeros((self.slots,) + tuple(pose.shape),
                                 dtype=torch.float32, device=dev)
        self.idx = torch.zeros((), dtype=torch.int64, device=dev)
        self._slot = 0            # the host's copy of idx
        self.graph = None
        self.capture_ms = None
        self.eager_calls = 0
        self.replays = 0
        self.replay_counts = {}    # counter -> what a replay adds
        self._side = None         # the warm-up's and the capture's stream
        self._weights = []        # the held weight copies the graph reads
        _live.add(self)

    @property
    def captures(self) -> bool:
        """Whether the program captures a graph: on a CUDA device."""
        return self.device.type == "cuda"

    # -- the body: one frame, the same ops eager and captured --
    def _body(self, model, cfg, mesh):
        sel = self.idx.view(1)
        rgb = torch.index_select(self.rgb, 0, sel)[0]
        depth = torch.index_select(self.depth, 0, sel)[0]
        pose, _ = trk.track_step(model, cfg, mesh, self.K, self.mean,
                                 self.std, self.pose, rgb, depth,
                                 self.object_width_mm, self.offset)
        self.poses.index_copy_(0, sel, pose.unsqueeze(0))
        self.pose.copy_(pose)
        self.idx.add_(1).remainder_(self.slots)

    def _capture(self, model, cfg, mesh):
        before = profiling.counters()
        cur = torch.cuda.current_stream(self.device)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        self._side.wait_stream(cur)
        try:
            with torch.cuda.stream(self._side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self._body(model, cfg, mesh)
                finally:
                    graph.capture_end()
        finally:
            # the capture ran nothing: what its body counted goes back
            added = {n: c - before.get(n, 0)
                     for n, c in profiling.counters().items()
                     if c != before.get(n, 0)}
            for n, c in added.items():
                profiling.count(n, -c)
        cur.wait_stream(self._side)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        profiling.count("compiled.captures")
        self.replay_counts = added
        self._weights = tracknet.held_weights(model)
        self.graph = graph

    def _run(self, model, cfg, mesh):
        """One frame at slot ``idx``: eager while warming up (and always on
        the CPU), else a replay, capturing first if this is the call after
        the warm-up."""
        if not self.captures:
            with profiling.span("compiled.eager"):
                self._body(model, cfg, mesh)
            self.eager_calls += 1
        else:
            with torch.cuda.device(self.device):
                if self.graph is None and self.eager_calls < WARMUP_CALLS:
                    with profiling.span("compiled.eager"):
                        if self._side is None:
                            self._side = torch.cuda.Stream(self.device)
                        cur = torch.cuda.current_stream(self.device)
                        self._side.wait_stream(cur)
                        with torch.cuda.stream(self._side):
                            self._body(model, cfg, mesh)
                        cur.wait_stream(self._side)
                    self.eager_calls += 1
                else:
                    with profiling.span("compiled.replay" if self.graph
                                        is not None else "compiled.capture"):
                        if self.graph is None:
                            self._capture(model, cfg, mesh)
                        self.graph.replay()
                    self.replays += 1
                    for n, c in self.replay_counts.items():
                        profiling.count(n, c)
        self._slot = (self._slot + 1) % self.slots

    def _check(self, key):
        if key != self.key:
            raise ValueError("this program was built for another key (a "
                             "model, mesh, frame shape or dtype, pose shape, "
                             "offset, object width or slot count that "
                             "differs); make one for these arguments")

    def _load(self, K, mean, std, pose):
        self.K.copy_(K)
        self.mean.copy_(mean)
        self.std.copy_(std)
        self.pose.copy_(pose)

    def step(self, model, cfg, mesh, K, mean, std, prev_pose, frame_rgb,
             frame_depth_mm, object_width_mm=None, frame_offset_vu=None):
        """One tracking update, :func:`~.tracker.track_step`'s arguments.
        Returns the new pose in a tensor of its own."""
        with profiling.span("compiled.key"):
            self._check(step_key(model, cfg, mesh, K, mean, std, prev_pose,
                                 frame_rgb, frame_depth_mm, object_width_mm,
                                 frame_offset_vu, self.slots))
        return self._step(model, cfg, mesh, K, mean, std, prev_pose,
                          frame_rgb, frame_depth_mm, frame_offset_vu)

    def _step(self, model, cfg, mesh, K, mean, std, prev_pose, frame_rgb,
              frame_depth_mm, frame_offset_vu):
        slot = self._slot
        with profiling.span("compiled.load"):
            self._load(K, mean, std, prev_pose)
            self.rgb[slot].copy_(frame_rgb)
            self.depth[slot].copy_(frame_depth_mm)
            if self.offset is not None:
                self.offset.copy_(frame_offset_vu)
        self._run(model, cfg, mesh)
        return self.poses[slot].clone()

    def video(self, model, cfg, mesh, K, mean, std, init_pose, frames_rgb,
              frames_depth_mm, object_width_mm=None):
        """:func:`~.tracker.track_video`'s arguments: T frames, ``slots``
        at a time, the pose carried in the program's buffer. Returns (T,
        ...) poses in a tensor of their own."""
        with profiling.span("compiled.key"):
            self._check(step_key(model, cfg, mesh, K, mean, std, init_pose,
                                 frames_rgb[0], frames_depth_mm[0],
                                 object_width_mm, None, self.slots))
        return self._video(model, cfg, mesh, K, mean, std, init_pose,
                           frames_rgb, frames_depth_mm)

    def _video(self, model, cfg, mesh, K, mean, std, init_pose, frames_rgb,
               frames_depth_mm):
        T = frames_rgb.shape[0]
        out = torch.empty((T,) + tuple(self.pose.shape), dtype=torch.float32,
                          device=self.device)
        with profiling.span("compiled.load"):
            self._load(K, mean, std, init_pose)
        for a in range(0, T, self.slots):
            n = min(self.slots, T - a)
            with profiling.span("compiled.fill"):
                if self._slot:
                    self.idx.zero_()
                    self._slot = 0
                self.rgb[:n].copy_(frames_rgb[a:a + n])
                self.depth[:n].copy_(frames_depth_mm[a:a + n])
            for _ in range(n):
                self._run(model, cfg, mesh)
            with profiling.span("compiled.gather"):
                out[a:a + n] = self.poses[:n]
        return out


class ProgramCache:
    """Programs by key, as ``jax.jit`` keeps its compiled programs; the
    least recently used is dropped past ``size`` (each holds its slots of
    frames and its graph's memory)."""

    def __init__(self, size: int = CACHE_SIZE):
        self.size = int(size)
        self._programs: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._programs)

    def programs(self) -> list:
        return list(self._programs.values())

    def clear(self) -> None:
        self._programs.clear()

    def _get(self, args, frame_rgb, frame_depth_mm, object_width_mm,
             frame_offset_vu, slots) -> StepProgram:
        model, cfg, mesh, K, mean, std, pose = args
        with profiling.span("compiled.key"):
            key = step_key(model, cfg, mesh, K, mean, std, pose, frame_rgb,
                           frame_depth_mm, object_width_mm, frame_offset_vu,
                           slots)
            prog = self._programs.get(key)
            if prog is not None:
                self._programs.move_to_end(key)
                return prog
        prog = StepProgram(model, cfg, mesh, K, mean, std, pose, frame_rgb,
                           frame_depth_mm, object_width_mm, frame_offset_vu,
                           slots)
        self._programs[key] = prog
        while len(self._programs) > self.size:
            self._programs.popitem(last=False)
        return prog

    def step(self, model, cfg, mesh, K, mean, std, prev_pose, frame_rgb,
             frame_depth_mm, object_width_mm=None, frame_offset_vu=None):
        """One update through the program of these arguments' key (one
        slot). Returns the new pose in a tensor of its own."""
        args = (model, cfg, mesh, K, mean, std, prev_pose)
        prog = self._get(args, frame_rgb, frame_depth_mm, object_width_mm,
                         frame_offset_vu, 1)
        return prog._step(*args, frame_rgb, frame_depth_mm, frame_offset_vu)

    def video(self, model, cfg, mesh, K, mean, std, init_pose, frames_rgb,
              frames_depth_mm, object_width_mm=None):
        """T frames through the program of these arguments' key
        (:data:`VIDEO_SLOTS` slots). Returns (T, ...) poses."""
        args = (model, cfg, mesh, K, mean, std, init_pose)
        prog = self._get(args, frames_rgb[0], frames_depth_mm[0],
                         object_width_mm, None, VIDEO_SLOTS)
        return prog._video(*args, frames_rgb, frames_depth_mm)


programs = ProgramCache()
"""The module's cache, shared by every caller in the process, as JAX's jit
cache is."""


def track_step(model, cfg, mesh, K, mean, std, prev_pose, frame_rgb,
               frame_depth_mm, object_width_mm=None, frame_offset_vu=None):
    """:func:`~.tracker.track_step` through the module's programs: the new
    pose only (no intermediates), in a tensor of its own."""
    return programs.step(model, cfg, mesh, K, mean, std, prev_pose,
                         frame_rgb, frame_depth_mm, object_width_mm,
                         frame_offset_vu)


def track_video(model, cfg, mesh, K, mean, std, init_pose, frames_rgb,
                frames_depth_mm, object_width_mm=None) -> torch.Tensor:
    """:func:`~.tracker.track_video` through the module's programs."""
    if frames_rgb.shape[0] == 0:
        return torch.empty((0,) + tuple(init_pose.shape),
                           dtype=torch.float32, device=init_pose.device)
    return programs.video(model, cfg, mesh, K, mean, std, init_pose,
                          frames_rgb, frames_depth_mm, object_width_mm)
