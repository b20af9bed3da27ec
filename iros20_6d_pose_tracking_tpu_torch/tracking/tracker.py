"""The per-frame tracking step and the Tracker API, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/tracking/tracker.py``. One
step (reference predict.py:217-296 ``Tracker.on_track``):

  1. ROI: the square ``object_width`` mm bbox at the projected previous pose;
  2. B branch: nearest crop-resize of the observed RGB-D frame;
  3. A branch: ROI-windowed render of the CAD model at the previous pose
     (pass 1 through the K1 wrapper, pass 2 through the fused
     gather-and-shade kernel's wrapper);
  4. OffsetDepth and the 8-channel NormalizeChannels;
  5. the Se3TrackNet forward at batch 1;
  6. the pose decode (tanh outputs x normalizers, Rodrigues compose).

The model decides how steps 4 and 6 go and how many rounds a frame runs
(``refine_iterations``, ``build_pair``, ``decode``): Se3TrackNet one round
as above, FoundationPose's refiner (``models/refinenet.py``) two, each
re-rendering A and re-cropping B at the pose the round before gave, its
inputs rgb / 255 and the normalised camera-frame XYZ map
(``ops/pointcloud.py``). A model with a ``round_span`` (the refiner's
``refiner.round``) records each round as that span and adds 1 to the
counter ``refine.rounds``.

Every step stays on the device of its tensors: the pose is fetched to the
host only where a caller asks for it (``Tracker.on_track`` returns numpy).
:func:`track_step` is the eager step. ``track_video`` and
``Tracker.on_track`` run it through ``tracking/compiled.py``, the
counterpart of the JAX ``jit`` and nested ``lax.scan``: on a CUDA device
the step is captured once per static key as a CUDA graph and replayed every
frame, reading frame ``idx`` of a static video buffer and carrying the pose
in the program's buffer; on the CPU the same bookkeeping runs the eager
step. ``Tracker.track_video_chunked`` feeds ``track_video`` a long video in
chunks, decoded on a background thread, with the pose carried on the device
across chunks.

:func:`track_step` also takes N prior poses (N, 4, 4): one batched step over
them (the JAX ``vmap`` of ``track_step`` over hypotheses), whose crop, culled
render, CNN and decode each run once for the N views. The multi-hypothesis
step (``tracking/hypotheses.py``, ``Tracker.on_track(samples > 1)``) is
built on it. :func:`roi_views` gives the rendered and cropped ROI pair at a
pose, for the canvases of ``apps/predict.py``.

Depth frames arrive as uint16 millimetres. PyTorch implements few ops on
uint16, so :func:`upload_depth` widens them to int32 on the device.
:func:`upload_async` is the upload of the live stream
(``tracking/stream.py``), which must never make the host wait.

``Tracker.track_video_adaptive`` chooses how a video is dispatched as it
runs (``tracking/dispatch.py``). ``TrackerConfig.dtype`` is the CNN's
activation type, float32 or bfloat16 (``models/tracknet.py``); the crop,
the render and the pose stay float32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from dataclasses import dataclass

import numpy as np
import torch

from ..models import tracknet
from ..models.convert import state_dict_from_jax
from ..ops import roi as roi_ops
from ..render import mesh as mesh_mod
from ..render import rasterizer as rz
from ..render.mesh import TriMesh
from ..utils import profiling

@dataclass(frozen=True)
class TrackerConfig:
    """Static configuration of the tracking step. The JAX config's
    ``render_impl`` has no counterpart: the tensors' device picks the
    kernels (CUDA) or their plain versions (CPU). Nor has ``fuse_pass2``:
    pass 2 always gathers in its fused kernel (the JAX
    ``fuse_pass2=True``)."""

    resolution: int = 176
    trans_normalizer: float = 0.03          # reference predict.py:128
    rot_normalizer: float = 5 * np.pi / 180
    object_width_mm: float = 250.0          # reference predict.py:136-142
    near: float = rz.NEAR_M
    far: float = rz.FAR_M
    dtype: torch.dtype = torch.float32      # the CNN's; bfloat16 too
    cull_backfaces: bool = False            # True for closed CAD meshes

    def __post_init__(self):
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {self.dtype}: float32 or bfloat16")


def _pageable_to(host: torch.Tensor, device) -> torch.Tensor:
    """``host.to(device)`` from pageable memory, counted as
    ``upload.pageable_bytes`` when it crosses to a CUDA device."""
    out = host.to(device)
    if out.is_cuda:
        profiling.count("upload.pageable_bytes", host.nbytes)
    return out


for _name in ("upload.pageable_bytes", "upload.pinned_bytes"):
    profiling.count(_name, 0)  # listed before the first upload


def upload_rgb(rgb, device) -> torch.Tensor:
    """Host RGB frame(s) -> device tensor, keeping the dtype (uint8 frames
    cross the bus as uint8)."""
    return _pageable_to(torch.from_numpy(np.ascontiguousarray(rgb)), device)


def upload_depth(depth, device) -> torch.Tensor:
    """Host depth frame(s) in mm -> device tensor. uint16 crosses the bus as
    its int16 bit pattern and is widened to int32 on the device (bit-exact);
    floating depth becomes float32."""
    depth = np.asarray(depth)
    if depth.dtype == np.uint16:
        d16 = torch.from_numpy(np.ascontiguousarray(depth).view(np.int16))
        return _pageable_to(d16, device).to(torch.int32) & 0xFFFF
    if np.issubdtype(depth.dtype, np.floating):
        depth = depth.astype(np.float32, copy=False)
    return _pageable_to(torch.from_numpy(np.ascontiguousarray(depth)), device)


def upload_async(host, device) -> torch.Tensor:
    """Host array or tensor -> ``device`` without making the host wait: on a
    CUDA device it is copied from pinned memory with ``non_blocking=True``
    (a pageable copy would wait for the stream). A host tensor already in
    pinned memory (``staging_buffer``) is copied as it is, anything else is
    first staged in a fresh pinned block. The caching host allocator hands a
    pinned block out again only after the copy that read it has run, so the
    caller may drop or reuse its buffer at once. On the CPU the tensor
    itself is returned (a numpy array is wrapped, not copied)."""
    device = torch.device(device)
    if isinstance(host, np.ndarray):
        host = torch.from_numpy(np.ascontiguousarray(host))
    if device.type == "cpu":
        return host
    if not host.is_pinned():
        host = host.pin_memory()
    profiling.count("upload.pinned_bytes", host.nbytes)
    return host.to(device, non_blocking=True)


def staging_buffer(shape, dtype, device) -> torch.Tensor:
    """An empty host tensor to fill and pass to :func:`upload_async`:
    pinned when ``device`` is a CUDA device."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.device(device).type == "cuda")


def roi_geometry(cfg: TrackerConfig, mesh: rz.MeshArrays, K, pose,
                 frame_rgb, frame_depth_mm, object_width_mm=None,
                 frame_offset_vu=None) -> dict:
    """The rendered (A) and cropped (B) ROI pair at ``pose`` (or at each of
    N poses), all float32, with the ROI: ``rgbA``, ``depthA``, ``rgbB``,
    ``depthB``, ``bbox`` ((4, 2) int32 (v, u) corners in full-image
    coordinates, ``ops/roi.compute_bbox``) and ``window`` (the render's
    (left, right, top, bottom) float32). ``object_width_mm`` and
    ``frame_offset_vu`` as in :func:`track_step`."""
    res = (cfg.resolution, cfg.resolution)
    width = cfg.object_width_mm if object_width_mm is None else object_width_mm
    bbox = roi_ops.compute_bbox(pose, K, width, (1000.0, 1000.0, 1000.0))
    bbox_local = bbox if frame_offset_vu is None else (
        bbox - frame_offset_vu.to(torch.int32))
    # B branch: the crop runs in the transfer dtype; only the ROI is cast.
    rgbB, depthB = roi_ops.crop_bbox(frame_rgb, frame_depth_mm, bbox_local,
                                     res)
    window = rz.window_from_bbox(bbox)
    rgbA, depthA = rz.render(
        mesh, pose, K, window, out_hw=res, near=cfg.near, far=cfg.far,
        cull_backfaces=cfg.cull_backfaces)
    return {"rgbA": rgbA, "depthA": depthA, "rgbB": rgbB.to(torch.float32),
            "depthB": depthB.to(torch.float32), "bbox": bbox,
            "window": window}


@torch.no_grad()
def roi_views(cfg: TrackerConfig, mesh: rz.MeshArrays, K, pose, frame_rgb,
              frame_depth_mm, object_width_mm=None, frame_offset_vu=None):
    """The rendered (A) and cropped (B) ROI pair at ``pose`` (or at each of
    N poses), all float32: the step's input before normalization, and the
    side-by-side canvas the reference shows every frame (reference
    predict.py:284-291). ``object_width_mm`` and ``frame_offset_vu`` as in
    :func:`track_step`."""
    v = roi_geometry(cfg, mesh, K, pose, frame_rgb, frame_depth_mm,
                     object_width_mm, frame_offset_vu)
    return v["rgbA"], v["depthA"], v["rgbB"], v["depthB"]


profiling.count("refine.rounds", 0)  # listed before the first step


@contextlib.contextmanager
def _round(model):
    """One round of the step: for a model that names its rounds
    (``round_span``, the refiner's ``refiner.round``) that span, and 1 more
    on the counter ``refine.rounds``; nothing for Se3TrackNet."""
    if model.round_span is None:
        yield
        return
    with profiling.span(model.round_span, device=True):
        yield
        profiling.count("refine.rounds")


@torch.no_grad()
def track_step(model: torch.nn.Module, cfg: TrackerConfig,
               mesh: rz.MeshArrays, K, mean, std, prev_pose, frame_rgb,
               frame_depth_mm, object_width_mm=None, frame_offset_vu=None):
    """One tracking update on the device of its tensors: the model's
    ``refine_iterations`` rounds of render, crop, network and compose, each
    from the pose the round before gave.

    Args:
      model: ``tracknet.Se3TrackNet`` or ``refinenet.RefineNet``, which
        builds its inputs (``build_pair``) and decodes its outputs
        (``decode``).
      prev_pose: (4, 4) float32 previous object-in-camera estimate; or N
        prior poses (N, 4, 4), refined in one batched step: the N crops in
        one gather, the N culled views in one K1 and one ``pass2_shade``
        launch, the CNN at batch N and the decode over N.
      frame_rgb: (H, W, 3) uint8 (or float32 in [0, 255]) current frame.
      frame_depth_mm: (H, W) depth in mm, int32 (see :func:`upload_depth`)
        or float32.
      object_width_mm: optional override of ``cfg.object_width_mm``.
      frame_offset_vu: optional (2,) int (row, col) of the frame's origin in
        the full camera image, where only a window of it was uploaded: the
        bbox is computed in full-image coordinates, and shifted into the
        window for the B-branch crop only.

    Returns the new (4, 4) pose, or (N, 4, 4) poses, and a dict of the last
    round's intermediates (with ``round_poses``, the pose after each round,
    where there are several). The CNN runs in ``cfg.dtype``, which must be
    the model's.
    """
    if model.dtype != cfg.dtype:
        raise ValueError(f"the model runs in {model.dtype}, the config says "
                         f"{cfg.dtype}")
    width = cfg.object_width_mm if object_width_mm is None else object_width_mm
    batched = prev_pose.dim() == 3
    pose, round_poses = prev_pose, []
    for _ in range(model.refine_iterations):
        with _round(model):
            v = roi_geometry(cfg, mesh, K, pose, frame_rgb, frame_depth_mm,
                             object_width_mm, frame_offset_vu)
            bufA, bufB = model.build_pair(v, pose, K, mean, std, width)
            out = model(bufA, bufB)
            trans, rot = out["trans"], out["rot"]
            if not batched:
                trans, rot = trans[0], rot[0]
            pose = model.decode(pose, trans, rot, cfg, width)
        round_poses.append(pose)
    aux = {k: v[k] for k in ("rgbA", "depthA", "rgbB", "depthB")}
    aux.update(trans=trans, rot=rot)
    if len(round_poses) > 1:
        aux["round_poses"] = torch.stack(round_poses)
    return pose, aux


@torch.no_grad()
def track_video(model: tracknet.Se3TrackNet, cfg: TrackerConfig,
                mesh: rz.MeshArrays, K, mean, std, init_pose, frames_rgb,
                frames_depth_mm, object_width_mm=None) -> torch.Tensor:
    """Track preloaded frames ((T, H, W, 3), (T, H, W) on the device) one
    step per frame, carrying the pose on the device. Returns (T, 4, 4), a
    tensor no later call writes. The steps run through the module's
    compiled programs (``tracking/compiled.py``): replays of one captured
    :func:`track_step` on a CUDA device, the same step eagerly on the
    CPU. Recorded as the span ``tracker.track_video``, its request the
    call's number in the process."""
    from . import compiled

    with profiling.span("tracker.track_video", request=next(_video_calls)):
        return compiled.track_video(model, cfg, mesh, K, mean, std,
                                    init_pose, frames_rgb, frames_depth_mm,
                                    object_width_mm)


_video_calls = itertools.count()


def _load_checkpoint(path: str) -> dict:
    """Network state_dict of a reference ``.pth``/``.pth.tar`` checkpoint,
    of the port's own training checkpoint (``.pt``, ``train/``), or of a
    Flax msgpack checkpoint the JAX trainer wrote (any other name, as the
    JAX ``_load_any_checkpoint`` reads it), whose ``params`` and
    ``batch_stats`` are carried across by ``state_dict_from_jax``."""
    if path.endswith((".pth", ".tar", ".pt")) or ".pth." in path:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if "model" in ckpt:  # train.checkpoint: model, optimizer, step, ...
            return ckpt["model"]
        return ckpt.get("state_dict", ckpt)
    from ..train.checkpoint import load_flax_checkpoint

    state = load_flax_checkpoint(path)
    return state_dict_from_jax({"params": state["params"],
                                "batch_stats": state["batch_stats"]})


class Tracker:
    """Host-facing tracker with the reference's API shape (reference
    predict.py:127-296): construct from ``dataset_info``, then
    ``on_track(prev_pose, rgb, depth) -> 4x4 pose`` per frame, or
    ``track_video`` over preloaded frames, or ``track_video_chunked`` over
    a long video.

    ``device`` is where the model, the mesh and every step live; there is
    no fallback to another device. Weights come from ``variables`` (Flax,
    carried across by :func:`~..models.convert.state_dict_from_jax`), a
    checkpoint at ``ckpt_dir`` (a reference ``.pth.tar``, a ``.pt`` the
    port's trainer wrote, or a Flax ``.msgpack`` the JAX trainer wrote), or
    else a seeded random init."""

    def __init__(
        self,
        dataset_info: dict,
        images_mean: np.ndarray,
        images_std: np.ndarray,
        ckpt_dir: str | None = None,
        model_path: str | None = None,
        trans_normalizer: float = 0.03,
        rot_normalizer: float = 5 * np.pi / 180,
        mesh: TriMesh | None = None,
        variables=None,
        dtype: torch.dtype = torch.float32,
        max_faces: int | None = None,
        cull_backfaces: bool | None = None,
        device="cuda",
    ):
        self.dataset_info = dataset_info
        self.device = torch.device(device)
        res = int(dataset_info["resolution"])
        cam = dataset_info["camera"]
        K = np.array([[cam["focalX"], 0, cam["centerX"]],
                      [0, cam["focalY"], cam["centerY"]],
                      [0, 0, 1]], np.float32)

        if mesh is None:
            if model_path is None:
                raise ValueError("need model_path or a prebuilt mesh")
            mesh = mesh_mod.load_mesh(model_path)
        render_mesh = mesh
        if max_faces is not None and mesh.num_faces > max_faces:
            # Raster cost is linear in face count and a 176^2 ROI resolves
            # far fewer triangles than a CAD scan carries. The object width
            # still comes from the full mesh.
            real = mesh.faces[: mesh.num_faces]
            if mesh.texture is not None and mesh.face_uvs is not None:
                v, f, c, fuv = mesh_mod.decimate(
                    mesh.verts, real, None, max_faces,
                    face_uvs=mesh.face_uvs[: mesh.num_faces])
                render_mesh = mesh_mod.build_trimesh(
                    v, f, c, face_uvs=fuv, texture=mesh.texture)
            else:
                render_mesh = mesh_mod.build_trimesh(*mesh_mod.decimate(
                    mesh.verts, real, mesh.colors, max_faces))
        self.trimesh = mesh

        # Object width: cloud diameter (voxel-downsampled 5 mm) + bbox%
        # pad, reference predict.py:131-142.
        if "object_width" in dataset_info:
            object_width = float(dataset_info["object_width"])
        else:
            cloud = mesh_mod.voxel_down_sample(mesh.verts, 0.005)
            self.object_cloud = cloud
            pad = dataset_info.get("boundingbox", 0.0)
            object_width = mesh_mod.compute_obj_max_width(cloud) * (
                1.0 + pad / 100.0)

        # Closed meshes with outward shading normals are culled (output
        # identical); inward-normal exports must not be.
        if cull_backfaces is None:
            real = render_mesh.faces[: render_mesh.num_faces]
            cull_backfaces = mesh_mod.is_closed(
                render_mesh.verts, real) and mesh_mod.is_outward_oriented(
                render_mesh.verts, real, render_mesh.normals)
        cfg = TrackerConfig(
            resolution=res, trans_normalizer=float(trans_normalizer),
            rot_normalizer=float(rot_normalizer),
            object_width_mm=float(object_width), dtype=dtype,
            cull_backfaces=bool(cull_backfaces))

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = tracknet.Se3TrackNet(image_size=res, dtype=dtype)
        state_dict = None
        if variables is not None:
            state_dict = state_dict_from_jax(variables)
        elif ckpt_dir is not None:
            state_dict = _load_checkpoint(ckpt_dir)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        model = model.to(self.device).eval()
        self._init_parts(model, cfg, rz.upload(render_mesh, self.device), K,
                         images_mean, images_std)

    @classmethod
    def from_parts(cls, model: tracknet.Se3TrackNet, cfg: TrackerConfig,
                   mesh: rz.MeshArrays, K, mean, std,
                   dtype: torch.dtype | None = None):
        """Assemble a Tracker from prebuilt pieces on one device (the
        mesh's): benchmarks, tests, pipelines without ``dataset_info``.
        ``dtype`` (default ``cfg.dtype``): the CNN's activation type, set on
        the config and on ``model``, which is used as it is, not copied."""
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
            model.dtype = dtype
        t = cls.__new__(cls)
        t.dataset_info = None
        t.trimesh = None
        t.device = mesh.fverts.device
        t._init_parts(model, cfg, mesh, K, mean, std)
        return t

    def _init_parts(self, model, cfg, mesh, K, mean, std):
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        self.object_width = cfg.object_width_mm

        def put(a):  # a host array, or a tensor on any device
            if not torch.is_tensor(a):
                a = torch.as_tensor(np.asarray(a))
            return a.detach().to(device=self.device, dtype=torch.float32)

        self.K, self.mean, self.std = put(K), put(mean), put(std)
        self.frame_cnt = 0
        self.prev_rgb = None
        self.prev_depth = None

    def on_track(self, prev_pose, current_rgb, current_depth,
                 gt_A_in_cam=None, gt_B_in_cam=None, debug: bool = False,
                 samples: int = 1) -> np.ndarray:
        """One tracking update; depth in metres (float) or millimetres
        (uint16), auto-detected like the reference's mm convention.
        Returns the new (4, 4) pose as float32 numpy.

        At ``samples == 1`` the step runs through the module's compiled
        programs (``tracking/compiled.py``: the upload is copied into the
        program's static buffers and, on a CUDA device, the captured step
        replayed); ``debug=True`` runs the eager :func:`track_step`, whose
        intermediates it keeps in ``self.last_aux``.

        ``samples > 1`` runs the multi-hypothesis step
        (:func:`~.hypotheses.track_step_multi`): the prior and ``samples -
        1`` perturbations of it, drawn from a ``torch.Generator`` on the
        tracker's device seeded with ``frame_cnt`` (the JAX
        ``PRNGKey(frame_cnt)``), refined in one batched step; the
        depth-agreement winner is kept and its score lands in
        ``self.last_score``.

        Recorded as the span ``tracker.on_track`` (request ``frame_cnt``):
        ``tracker.prepare`` (depth units, the prior pose to the device),
        ``tracker.upload`` (the frame), the step's spans, ``tracker.fetch``
        (the pose to the host)."""
        with profiling.span("tracker.on_track", request=self.frame_cnt):
            with profiling.span("tracker.prepare"):
                depth = np.asarray(current_depth)
                if np.issubdtype(depth.dtype, np.floating) and depth.size \
                        and float(depth.max()) < 100.0:
                    depth = (depth * 1000.0).astype(np.float32)  # m -> mm
                prior = _pageable_to(torch.as_tensor(
                    np.asarray(prev_pose), dtype=torch.float32), self.device)
            with profiling.span("tracker.upload"):
                frame = (upload_rgb(current_rgb, self.device),
                         upload_depth(depth, self.device))
            args = (self.model, self.cfg, self.mesh, self.K, self.mean,
                    self.std, prior) + frame
            if samples > 1:
                from . import hypotheses as hy

                gen = torch.Generator(self.device).manual_seed(self.frame_cnt)
                new_pose, score, aux = hy.track_step_multi(*args, gen,
                                                           samples=samples)
                self.last_score = float(score)
            elif debug:
                new_pose, aux = track_step(*args)
            else:
                from . import compiled

                new_pose = compiled.track_step(*args)
            self.prev_rgb = current_rgb
            self.prev_depth = depth
            self.frame_cnt += 1
            with profiling.span("tracker.fetch"):
                if debug:
                    self.last_aux = {k: v.cpu().numpy()
                                     for k, v in aux.items()}
                return new_pose.cpu().numpy()

    def track_video(self, init_pose, frames_rgb, frames_depth_mm
                    ) -> np.ndarray:
        """Track preloaded frames ((T, H, W, 3) uint8, (T, H, W) uint16 mm or
        float). Uploads them once and returns (T, 4, 4) numpy poses."""
        poses = track_video(
            self.model, self.cfg, self.mesh, self.K, self.mean, self.std,
            torch.as_tensor(np.asarray(init_pose), dtype=torch.float32).to(
                self.device),
            upload_rgb(frames_rgb, self.device),
            upload_depth(frames_depth_mm, self.device))
        return poses.cpu().numpy()

    def track_video_adaptive(self, init_pose, rgb_source, depth_source,
                             n_frames: int | None = None,
                             chunk_size: int = 100, candidates=(100, 10, 1),
                             samples: int = 1, dispatcher=None):
        """Bounded-memory whole-video tracking whose dispatch granularity
        is chosen as the video runs (``tracking/dispatch.py``): the
        candidates are probed on the video's first frames (real work, the
        poses kept) and the fastest runs the rest, probed again if its rate
        collapses. Every mode gives :meth:`track_video`'s bits.

        Returns (poses (T, 4, 4), telemetry dict), the telemetry with
        ``scores`` (T,) when samples > 1. A prebuilt ``dispatcher``
        (``AdaptiveVideoTracker``) keeps its warm state across videos.
        """
        from .dispatch import AdaptiveVideoTracker

        d = dispatcher or AdaptiveVideoTracker(
            self, candidates=candidates, samples=samples)
        poses, scores = d.track(init_pose, rgb_source, depth_source,
                                n_frames=n_frames, chunk_size=chunk_size)
        tel = d.telemetry()
        if scores is not None:
            tel["scores"] = scores
        return poses, tel

    def track_video_chunked(self, init_pose, rgb_source, depth_source,
                            chunk_size: int = 64,
                            n_frames: int | None = None) -> np.ndarray:
        """Bounded-memory whole-video tracking: the video goes to the device
        in chunks of ``chunk_size`` frames (uint8 RGB, and depth through
        :func:`upload_depth`), each uploaded once and tracked by
        :func:`track_video`, with the pose carried on the device from chunk
        to chunk. A background thread loads chunk k + 1 while chunk k
        tracks, and each chunk's poses come to the host in one fetch, made
        after the next chunk is queued.

        Args:
          rgb_source / depth_source: (T, H, W[, 3]) arrays, or callables
            ``f(start, stop) -> np.ndarray`` (lazy PNG decoders, say).
          n_frames: required when the sources are callables.

        Returns (T, 4, 4) float32 poses, bit-equal to :meth:`track_video`
        over the whole video: the step of every frame is the same. The last
        chunk is not padded and tracks only its own frames (the JAX package
        pads it with copies of its last frame so that one program compiles
        once; here every chunk replays the same program, whose static
        buffers hold ``compiled.VIDEO_SLOTS`` frames whatever the chunk's
        length).
        """
        import concurrent.futures as cf

        if n_frames is None:
            if callable(rgb_source) or callable(depth_source):
                raise ValueError("n_frames is required with callable sources")
            n_frames = len(rgb_source)
        if n_frames == 0:
            return np.zeros((0, 4, 4), np.float32)
        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")

        def source(src):
            return src if callable(src) else (lambda a, b: src[a:b])

        get_rgb, get_depth = source(rgb_source), source(depth_source)

        def load(a, b):
            return (np.ascontiguousarray(get_rgb(a, b)),
                    np.ascontiguousarray(get_depth(a, b)))

        pose = torch.as_tensor(np.asarray(init_pose), dtype=torch.float32).to(
            self.device)
        out, pending = [], None
        with cf.ThreadPoolExecutor(1) as ex:
            fut = ex.submit(load, 0, min(chunk_size, n_frames))
            for a in range(0, n_frames, chunk_size):
                b = min(a + chunk_size, n_frames)
                rgb_np, depth_np = fut.result()
                if b < n_frames:
                    fut = ex.submit(load, b, min(b + chunk_size, n_frames))
                poses = track_video(
                    self.model, self.cfg, self.mesh, self.K, self.mean,
                    self.std, pose, upload_rgb(rgb_np, self.device),
                    upload_depth(depth_np, self.device))
                pose = poses[-1]
                if pending is not None:
                    out.append(pending.cpu().numpy())
                pending = poses
        out.append(pending.cpu().numpy())
        return np.concatenate(out, axis=0)
