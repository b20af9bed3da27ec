"""Triangle rasterizer (z-buffered, ROI-windowed, diffuse-shaded), in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/render/rasterizer.py``. The
rendering model is the same: the ROI window is rendered directly at the
output resolution, every face carries screen-linear forms (three edges, 1/z
and the perspective-correct attributes), pass 1 picks each pixel's winning
face and pass 2 shades it from the winner's forms.

The port follows the JAX package's Pallas path (``impl='pallas'``):

  - the front end, from the pose to pass 1's and pass 2's tables (the
    corners in the camera, the near test, the window's pixel coordinates,
    the coefficient rows, the attribute forms, the back-face cull and its
    compaction, the face blocks' bboxes), is one launch on the card,
    :func:`~.raster_kernels.render_setup`; on the CPU it is its plain
    version, :func:`~.raster_kernels.render_setup_ref`, beside it;
  - pass 1 is the packed-key winner search of
    :func:`~.raster_kernels.pass1_winners` (a CUDA kernel on the card, its
    plain version on the CPU), or with ``worklist=True`` the same search
    over the work list of intersecting (pixel tile, face block) pairs,
    :func:`~.raster_kernels.pass1_worklist`, which gives the same bits and
    suits sparse full-frame renders. The XLA sweep ``_pass1_xla`` and its
    zmin-argmin tie-break are not ported: the kernel's plain version takes
    their place as the reference;
  - depth comes from the winner's 1/z form (``depth_from_form=True``);
  - ``cull_backfaces`` compacts the front faces to the front of every
    per-face table (:func:`~.raster_kernels.culled_pass1_inputs`), so
    whole trailing face blocks are skipped;
  - pass 2 gathers each pixel's winner row and shades it in one kernel,
    :func:`~.raster_kernels.pass2_shade` (the JAX ``fuse_pass2=True``
    gather fused with :func:`~.raster_kernels.shade_rows`; plain indexing
    is not ported).

:func:`render` also takes B poses (B, 4, 4) with B windows, through K1,
with or without the cull: the B views of one mesh (the JAX ``jax.vmap`` over
``render``, as the training sampler and the multi-hypothesis step use it) in
one K1 launch and one pass-2 launch. Every step is batched, not looped: the
culled views are compacted each along its own face axis, and view b is the
same bits as ``render`` of pose b alone.

Depth is metric millimetres, 0 where no surface or beyond ``far``. Lighting
is the reference's: diffuse 0.4 x max(n . l, 0) + ambient 0.65, clamped, with
a camera-attached light.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import roi
from . import raster_kernels as rk
from .mesh import TriMesh

NEAR_M = 0.1
FAR_M = 2.0


class MeshArrays(NamedTuple):
    """Static mesh data on one device, in face-soup layout: attributes are
    expanded per face corner, so the per-frame prologue is elementwise."""

    fverts: torch.Tensor    # (F, 3, 3) f32 corner positions (object space)
    fcolors: torch.Tensor   # (F, 3, 3) f32 corner albedo in [0, 1]
    fnormals: torch.Tensor  # (F, 3, 3) f32 corner normals
    fmask: torch.Tensor     # (F,) bool, False for padding rows
    fuvs: torch.Tensor | None = None     # (F, 3, 2) per-corner UVs (OBJ
                                         # convention, origin bottom-left)
    texture: torch.Tensor | None = None  # (Th, Tw, 3) f32 albedo in [0, 1]


def upload(mesh: TriMesh, device) -> MeshArrays:
    """Copy a :class:`TriMesh` to ``device`` in face-soup layout."""
    f = mesh.faces

    def put(a):
        return torch.as_tensor(a, dtype=torch.float32).to(device)

    textured = mesh.face_uvs is not None and mesh.texture is not None
    return MeshArrays(
        fverts=put(mesh.verts[f]),
        fcolors=put(mesh.colors[f]),
        fnormals=put(mesh.normals[f]),
        fmask=torch.arange(f.shape[0], device=device) < mesh.num_faces,
        fuvs=put(mesh.face_uvs) if textured else None,
        texture=put(mesh.texture) if textured else None,
    )


def full_frame_window(width: int, height: int):
    """Window covering the full image with integer-centred pixels."""
    return (-0.5, width - 0.5, -0.5, height - 0.5)


def window_from_bbox(bbox: torch.Tensor) -> torch.Tensor:
    """(..., 4) float32 (left, right, top, bottom) from (..., 4, 2) int
    (v, u) bboxes (the ``ops.roi.compute_bbox`` output)."""
    b = bbox.to(torch.float32)
    return torch.stack([b[..., 1].amin(-1), b[..., 1].amax(-1),
                        b[..., 0].amin(-1), b[..., 0].amax(-1)], dim=-1)


def mesh_of(stack: MeshArrays, b: int) -> MeshArrays:
    """Mesh b of a stack (views of its fields)."""
    return MeshArrays(*(None if f is None else f[b] for f in stack))


def render(
    mesh: MeshArrays,
    pose: torch.Tensor,
    K: torch.Tensor,
    window,
    out_hw: tuple[int, int] = (176, 176),
    near: float = NEAR_M,
    far: float = FAR_M,
    cull_backfaces: bool = False,
    lighting: torch.Tensor | None = None,
    worklist: bool = False,
):
    """Render the mesh at ``pose`` (OpenCV camera frame) into the ROI window.

    Args:
      mesh: one mesh, or a stack of B meshes (``parallel/spmd
        .stack_meshes``: (B, F, ...) fields, no texture) for B poses, view b
        of mesh b.
      pose: (4, 4) object-in-camera, on the mesh's device, like ``K``; or
        B poses (B, 4, 4), rendered through K1 (culled or not) in one K1 and
        one pass-2 launch, view b the same bits as ``render`` of pose b
        alone.
      window: (left, right, top, bottom) in full-image pixel coordinates,
        four numbers or a (4,) tensor, or (B, 4) for B poses
        (:func:`window_from_bbox`); the output grid resamples this
        rectangle at ``out_hw``.
      cull_backfaces: compact away faces whose oriented geometric normal
        points away from the camera before pass 1. Output-identical for
        closed meshes seen from outside; leave False for open geometry.
      worklist: run pass 1 through K3, the work list of intersecting (pixel
        tile, face block) pairs (:func:`~.raster_kernels.pass1_worklist`),
        instead of K1. The output is the same bit for bit; the full-frame
        renders of a small object (``eval/synthetic_benchmark.py``) ask for
        it, the tracking step's ROI renders keep K1.

    Returns rgb (H, W, 3) float32 in [0, 255] and depth_mm (H, W) float32
    (0 = no hit); (B, H, W, 3) and (B, H, W) for B poses.
    """
    if pose.dim() == 3 and worklist:
        raise ValueError("a batch of poses renders through K1: worklist "
                         "takes one pose")
    # On the culled path the attribute forms are compacted together with
    # the pass-1 tables, so winner ids index the permuted space throughout.
    coef, bbox, fb, attr_coef = rk.render_setup(mesh, pose, K, window, out_hw,
                                                near, cull_backfaces)
    pass1 = rk.pass1_worklist if worklist else rk.pass1_winners
    iz, winner = pass1(coef, bbox, out_hw, fb)
    # zmin, coverage, hit (zmin < far) and the winner clamp are pass 2's.
    return rk.pass2_shade(attr_coef, iz, winner, pose[..., :3, :3],
                          pose[..., :3, 3], out_hw, far, texture=mesh.texture,
                          lighting=lighting)


def render_at_bbox(mesh: MeshArrays, pose: torch.Tensor, K: torch.Tensor,
                   object_width_mm, out_hw: tuple[int, int] = (176, 176),
                   **kw):
    """Render the pose-conditioned ROI, the tracker's A branch: the square
    ``object_width_mm`` window of the reference (``ops/roi.compute_bbox``
    at scale 1000, reference predict.py:232), rendered directly. ``kw``
    are :func:`render`'s keywords. Returns (rgb, depth, bbox)."""
    bbox = roi.compute_bbox(pose, K, object_width_mm,
                            (1000.0, 1000.0, 1000.0))
    rgb, depth = render(mesh, pose, K, window_from_bbox(bbox), out_hw, **kw)
    return rgb, depth, bbox
