"""Latency-oriented scale-out: the render's faces sharded over ranks, in
PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/parallel/latency.py``. The
per-frame recurrence is sequential (frame t needs frame t-1's pose), so
this module cuts one frame's latency instead: pass 1 is parallel over
faces, so the face soup is split over a 1-D ("sp",) layout of ranks
(:func:`sp_mesh`), every rank runs K1 over its shard into a full ROI
z-buffer, and three collectives merge the result:

  1. ``all_reduce(MAX)`` of the best inverse depth: the z-test across ranks;
  2. ``all_reduce(MAX)`` of each rank's global winner id where its depth is
     the best (-1 elsewhere): the largest global id wins a tie across
     ranks (JAX's rule; the single render's tie-break, ROADMAP F2, differs
     at exact ties);
  3. ``all_reduce(SUM)`` of the owned attribute rows, gathered on each rank
     by K2 (``gather_rows``) with ``covered`` = "my winner": the owner
     contributes the row, every other rank zeros.

Shading, the ROI crop, the CNN and the pose update stay replicated. The
caller initialises ``torch.distributed`` (NCCL for CUDA tensors on cards
of their own, gloo for the CPU or for ranks that share one card); nothing
here switches backend.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..core import se3
from ..models import tracknet
from ..ops import roi as roi_ops
from ..render import raster_kernels as rk
from ..render import rasterizer as rz
from ..tracking import tracker as trk
from .spmd import world_size


@dataclass(frozen=True)
class SpMesh:
    """``n`` ranks in a line, the ("sp",) layout; ``rank`` this process's.
    Its collectives run over the default process group."""

    n: int = 1
    rank: int = 0
    axis_names: tuple = ("sp",)

    @property
    def size(self) -> int:
        return self.n


def sp_mesh(n_devices: int | None = None) -> SpMesh:
    """The ("sp",) layout of ``n_devices`` ranks (default: every rank of the
    process group, which must have that many; 1 needs none)."""
    world = world_size()
    n = world if n_devices is None else int(n_devices)
    if n != 1 and n != world:
        raise ValueError(f"a layout of {n} ranks needs a process group of "
                         f"{n}; this one has {world}")
    return SpMesh(n, dist.get_rank() if n > 1 else 0)


def shard_mesh_faces(mesh_arrays: rz.MeshArrays,
                     mesh: SpMesh) -> rz.MeshArrays:
    """This rank's shard of the face soup: the faces padded to a multiple
    of 1024 x ranks (padding faces with ``fmask`` False, the single render's
    poisoning) and split evenly in order, so shard r holds global faces
    [r F_loc, (r + 1) F_loc). Texture and UVs are dropped: the sharded
    render shades vertex colours only (its rows are fixed at 30 columns);
    bake a texture to vertex colours first
    (``render/mesh.bake_texture_to_colors``)."""
    n = mesh.size
    F = mesh_arrays.fverts.shape[0]
    granule = 1024 * n
    F_pad = -(-F // granule) * granule

    def pad(x, fill=0):
        if F_pad == F:
            return x
        tail = torch.full((F_pad - F,) + tuple(x.shape[1:]), fill,
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, tail])

    F_loc = F_pad // n
    part = slice(mesh.rank * F_loc, (mesh.rank + 1) * F_loc)
    return rz.MeshArrays(
        fverts=pad(mesh_arrays.fverts)[part].contiguous(),
        fcolors=pad(mesh_arrays.fcolors)[part].contiguous(),
        fnormals=pad(mesh_arrays.fnormals)[part].contiguous(),
        fmask=pad(mesh_arrays.fmask, fill=False)[part].contiguous())


def sharded_render(cfg: trk.TrackerConfig, mesh: SpMesh):
    """The face-parallel render: ``render(shard, pose, K, bbox) -> (rgb,
    depth_mm)``, the whole ROI on every rank, from this rank's
    :func:`shard_mesh_faces` shard.

    Per rank: the shard is projected; ``cfg.cull_backfaces`` applies as a
    mask with no compaction (the shard's face order must stay aligned with
    its global offset for the winner merge); K1 searches the shard; then
    the three collectives of the module docstring, the owned rows gathered
    by K2, and ``shade_rows`` with depth from the winner's 1/z form.
    ``parts``, where given, is a dict that receives the rank's K1 inputs
    (coef, block_bbox, face_block) and K2 inputs (attr, local winner,
    covered), for checks of the kernels at these shapes."""
    res = (cfg.resolution, cfg.resolution)

    def render(shard: rz.MeshArrays, pose, K, bbox, parts=None):
        window = rz.window_from_bbox(bbox)
        fx, fy, fiz, fvalid, R, t = rk.project_faces(shard, pose, K, window,
                                                     res, cfg.near)
        if cfg.cull_backfaces:
            fvalid = fvalid & ~rk.backface_mask(shard, R, t)
        coef, _ = rk.build_face_coefficients(fx, fy, fiz, fvalid)
        fb = rk.pick_face_block(fx.shape[-2])
        block_bbox = rk.build_block_bboxes(fx, fy, fvalid, fb)
        iz, win = rk.pass1_winners(coef, block_bbox, res, fb)
        F_loc = shard.fverts.shape[0]
        off = mesh.rank * F_loc
        giz = iz.clone()
        if mesh.size > 1:
            dist.all_reduce(giz, op=dist.ReduceOp.MAX)  # the z-test
        cand = torch.where((iz >= giz) & (iz > 1e-9), win + off, -1)
        gwin = cand.to(torch.int32)
        if mesh.size > 1:
            dist.all_reduce(gwin, op=dist.ReduceOp.MAX)  # the winner
        zmin = 1.0 / torch.clamp(giz, min=1e-9)
        hit = (giz > 1e-9) & (zmin < cfg.far)
        attr = rk.face_attr_forms(fx, fy, fiz, fvalid, shard)
        lidx = (gwin - off).reshape(-1)
        mine = (lidx >= 0) & (lidx < F_loc)
        lidx = torch.clamp(lidx, 0, F_loc - 1)
        if parts is not None:
            parts.update(k1=(coef, block_bbox, res, fb),
                         k2=(attr, lidx, mine))
        rows = rk.gather_rows(attr, lidx, mine)
        if mesh.size > 1:
            dist.all_reduce(rows)  # the owner's row
        return rk.shade_rows(R, t, rows, hit.reshape(-1), res)

    return render


def sp_track_step(model: tracknet.Se3TrackNet, cfg: trk.TrackerConfig,
                  mesh: SpMesh):
    """The tracking step with its render face-sharded (:func:`sharded_render`).

    Returns ``step(shard, K, mean, std, prev_pose, frame_rgb,
    frame_depth_mm) -> new (4, 4) pose``, the same on every rank: the crop,
    the CNN (``model``, in eval mode) and the decode of
    ``tracking/tracker.track_step`` around the sharded render. (JAX's step
    takes the Flax variables first; the port's model holds its weights.)"""
    render = sharded_render(cfg, mesh)
    res = (cfg.resolution, cfg.resolution)

    @torch.no_grad()
    def step(shard, K, mean, std, prev_pose, frame_rgb, frame_depth_mm):
        bbox = roi_ops.compute_bbox(prev_pose, K, cfg.object_width_mm,
                                    (1000.0, 1000.0, 1000.0))
        rgbB, depthB = roi_ops.crop_bbox(frame_rgb, frame_depth_mm, bbox, res)
        rgbA, depthA = render(shard, prev_pose, K, bbox)
        bufA, bufB = tracknet.normalize_pair(
            rgbA, depthA, rgbB.to(torch.float32), depthB.to(torch.float32),
            prev_pose, mean, std)
        model.eval()
        out = model(bufA[None], bufB[None])
        return se3.decode_delta(prev_pose, out["trans"][0], out["rot"][0],
                                cfg.trans_normalizer, cfg.rot_normalizer)

    return step
