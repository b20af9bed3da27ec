"""Triangle rasterizer (z-buffered, ROI-windowed, diffuse-shaded), in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/render/rasterizer.py``. The
rendering model is the same: the ROI window is rendered directly at the
output resolution, every face carries screen-linear forms (three edges, 1/z
and the perspective-correct attributes), pass 1 picks each pixel's winning
face and pass 2 shades it from the winner's forms.

The port follows the JAX package's Pallas path (``impl='pallas'``):

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
    per-face table (:func:`_compact_front`), so whole trailing face blocks
    are skipped;
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


def _rotate(x: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """x @ R^T over the last axis (object -> camera rotation); x (..., 3)
    with R (3, 3), or x (B, ..., 3) with one R (B, 3, 3) per view."""
    return x @ R.transpose(-1, -2)


def _rotate_views(x: torch.Tensor, R: torch.Tensor,
                  stacked: bool = False) -> torch.Tensor:
    """One x (..., 3) rotated by each of B rotations R (B, 3, 3): (B, ...,
    3). One matrix product against the B rotations side by side, whose
    columns are each view's x @ R_b^T. ``stacked``: x is (B, ..., 3), one
    per view (the meshes of ``parallel/spmd.stack_meshes``), and view b
    is x[b] @ R_b^T."""
    if R.dim() == 2:
        return _rotate(x, R)
    if stacked:
        B = R.shape[0]
        return (x.reshape(B, -1, 3) @ R.transpose(-1, -2)).reshape(x.shape)
    B = R.shape[0]
    cols = R.permute(2, 0, 1).reshape(3, 3 * B)  # [j, 3b + i] = R[b, i, j]
    out = x.reshape(-1, 3) @ cols
    return out.reshape(x.shape[:-1] + (B, 3)).movedim(-2, 0)


def is_stacked(mesh: MeshArrays) -> bool:
    """True for a stack of B meshes, one per view: fverts (B, F, 3, 3)."""
    return mesh.fverts.dim() == 4


def mesh_of(stack: MeshArrays, b: int) -> MeshArrays:
    """Mesh b of a stack (views of its fields)."""
    return MeshArrays(*(None if f is None else f[b] for f in stack))


def _project(mesh: MeshArrays, pose, K, window, out_hw, near):
    """Face corners -> window pixel space. ``window`` is four numbers or a
    (..., 4) tensor (:func:`window_from_bbox`). Returns (fx, fy, fiz,
    fvalid, R, t) with (F, 3) screen coordinates and inverse depths per
    face. A batch of poses (B, 4, 4) with windows (B, 4) gives (B, F, 3),
    from one mesh or from a stack of B meshes, view b from mesh b."""
    H, W = out_hw
    dev = mesh.fverts.device
    lead = pose.shape[:-2]
    if torch.is_tensor(window):
        window = window.unbind(-1)
    left, right, top, bottom = [
        torch.as_tensor(w, dtype=torch.float32, device=dev).reshape(
            lead + (1, 1)) for w in window]
    R = pose[..., :3, :3]
    t = pose[..., :3, 3]
    xc = _rotate_views(mesh.fverts, R, is_stacked(mesh)) \
        + t[..., None, None, :]  # (.., F, 3, 3)
    z = xc[..., 2]
    valid = z > near
    inv_z = torch.where(valid, 1.0 / torch.where(valid, z, 1.0), 0.0)
    u = xc[..., 0] * K[0, 0] * inv_z + K[0, 2]
    v = xc[..., 1] * K[1, 1] * inv_z + K[1, 2]
    # Window pixel space: output pixel (i, j) has centre (j, i). A number
    # over a tensor is reciprocal-then-multiply in torch, which can round
    # differently from the division JAX computes; divide tensors instead.
    sx = torch.full_like(right, W) / (right - left)
    sy = torch.full_like(bottom, H) / (bottom - top)
    fx = (u - left) * sx - 0.5
    fy = (v - top) * sy - 0.5
    fvalid = valid.all(dim=-1) & mesh.fmask
    return fx, fy, inv_z, fvalid, R, t


def _face_attr_coefficients(fx, fy, fiz, fvalid, mesh: MeshArrays):
    """Per-face linear forms of the perspective-correct attributes:
    attr(p) = (alpha px + beta py + gamma) / izpix(p).

    Returns (F, 30): [izpix a, b, c | albedo 9 | normal 9 | position 9],
    or (F, 36) with 6 UV forms appended for textured meshes; (B, F, ...)
    for a batch of views."""
    x0, x1, x2 = fx[..., 0], fx[..., 1], fx[..., 2]
    y0, y1, y2 = fy[..., 0], fy[..., 1], fy[..., 2]
    a = torch.stack([y1 - y2, y2 - y0, y0 - y1], dim=-1)  # (F, 3)
    b = torch.stack([x2 - x1, x0 - x2, x1 - x0], dim=-1)
    c = torch.stack(
        [x1 * y2 - x2 * y1, x2 * y0 - x0 * y2, x0 * y1 - x1 * y0], dim=-1)
    area = a[..., 0] * x0 + b[..., 0] * y0 + c[..., 0]
    ok = fvalid & (torch.abs(area) > 1e-4)
    inv_area = torch.where(ok, 1.0 / torch.where(ok, area, 1.0), 0.0)
    w = fiz * inv_area[..., None]  # (F, 3)
    aw, bw, cw = a * w, b * w, c * w
    iz_abc = torch.stack([aw.sum(-1), bw.sum(-1), cw.sum(-1)], dim=-1)

    def attr_forms(vattr):  # (F, 3, C) -> (F, 3C): [a_c..., b_c..., c_c...]
        return torch.cat([(k[..., None] * vattr).sum(-2)
                          for k in (aw, bw, cw)], dim=-1)

    packs = [iz_abc, attr_forms(mesh.fcolors), attr_forms(mesh.fnormals),
             attr_forms(mesh.fverts)]
    if mesh.fuvs is not None:
        packs.append(attr_forms(mesh.fuvs))
    return torch.cat(packs, dim=-1).to(torch.float32)


def _compact_front(keep, *tables):
    """Stable-partition the rows with ``keep`` True to the front of every
    table at once (one row scatter over their concatenation). ``keep`` is
    (F,) with tables (F, C_i), or (B, F) with tables (B, F, C_i), each view
    partitioned along its own face axis. Returns the permuted tables, each
    contiguous."""
    k = keep.to(torch.int64)
    nkeep = k.sum(-1, keepdim=True)
    dest = torch.where(keep, torch.cumsum(k, -1) - 1,
                       nkeep + torch.cumsum(1 - k, -1) - 1)
    cat = torch.cat([t.to(torch.float32) for t in tables], dim=-1)
    out = torch.empty_like(cat).scatter_(
        -2, dest[..., None].expand(cat.shape), cat)
    parts = torch.split(out, [t.shape[-1] for t in tables], dim=-1)
    return [p.contiguous() for p in parts]


def _backface_mask(mesh: MeshArrays, R, t) -> torch.Tensor:
    """(F,) True for faces whose geometric normal (oriented by the stored
    outward shading normals) points away from the camera: they cannot be the
    closest visible surface of a closed mesh seen from outside. Degenerate
    faces and zero shading normals give sign 0 and are kept. B poses, R (B,
    3, 3) and t (B, 3), give (B, F), view b the same bits as pose b alone
    (the rotations go through :func:`_rotate_views`, as in the projection);
    a stack of B meshes gives view b from mesh b."""
    per_view = is_stacked(mesh)
    v_cam = _rotate_views(mesh.fverts, R, per_view) + t[..., None, None, :]
    gn = torch.linalg.cross(v_cam[..., 1, :] - v_cam[..., 0, :],
                            v_cam[..., 2, :] - v_cam[..., 0, :], dim=-1)
    n_avg = _rotate_views(mesh.fnormals.mean(dim=-2), R, per_view)
    gn = gn * torch.sign(torch.sum(gn * n_avg, dim=-1, keepdim=True))
    centroid = v_cam.mean(dim=-2)
    return torch.sum(gn * centroid, dim=-1) > 0.0


def pick_face_block(F: int) -> int:
    """Pass-1 face-block size: the biggest of {1024, 512, 256} dividing F
    (mesh padding guarantees 256 | F)."""
    return next((b for b in (1024, 512, 256) if F % b == 0), F)


def _pass1_kernel(worklist: bool):
    """The pass-1 wrapper: K3 (work list) or K1. Both give the same bits."""
    return rk.pass1_worklist if worklist else rk.pass1_winners


def _pass1_iz(fx, fy, fiz, fvalid, out_hw, worklist: bool = False):
    """(iz, winner) of :func:`pass1`, without the metric depth."""
    coef, _ = rk.build_face_coefficients(fx, fy, fiz, fvalid)
    fb = pick_face_block(fx.shape[-2])
    bbox = rk.build_block_bboxes(fx, fy, fvalid, fb)
    return _pass1_kernel(worklist)(coef, bbox, out_hw, fb)


def pass1(fx, fy, fiz, fvalid, out_hw, worklist: bool = False):
    """Pass-1 winner search over projected faces, without cull compaction,
    through K1 or, with ``worklist``, K3. Returns (zmin, iz, winner): metric
    depth (inf where no face), the best inverse depth (-1 where none) and
    the winning face index. A batch of views (B, F, 3) is one K1 launch."""
    iz, winner = _pass1_iz(fx, fy, fiz, fvalid, out_hw, worklist)
    return rk.zmin_from_iz(iz), iz, winner


def culled_pass1_inputs(mesh: MeshArrays, fx, fy, fiz, fvalid, R, t,
                        attr_coef):
    """Pass-1 inputs with back faces culled: (coef (12, F), block_bbox,
    face_block, attr_coef), the front faces stable-partitioned to the front
    of coef, of the per-face bboxes and of the attribute forms together, so
    whole trailing face blocks get empty bboxes and are skipped, and winner
    ids index ``attr_coef`` directly. B views ((B, F, 3) projections, R (B,
    3, 3), t (B, 3), attr_coef (B, F, C)) give coef (B, 12, F), block_bbox
    (B, n_blocks, 4) and attr_coef (B, F, C), each view compacted along its
    own face axis: view b the same bits as its inputs alone."""
    coef, _ = rk.build_face_coefficients(fx, fy, fiz, fvalid)
    fb = pick_face_block(fx.shape[-2])
    keep = fvalid & ~_backface_mask(mesh, R, t)
    poison = torch.zeros((12, 1), dtype=coef.dtype, device=coef.device)
    poison[rk.ROW_C0:rk.ROW_C2 + 1:rk.ROW_C1 - rk.ROW_C0] = -1.0  # c0 c1 c2
    coef = torch.where(keep[..., None, :], coef, poison)
    face_bbox = rk.build_face_bboxes(fx, fy, keep)
    coef_t, face_bbox, attr_coef = _compact_front(
        keep, coef.transpose(-1, -2), face_bbox, attr_coef)
    return (coef_t.transpose(-1, -2).contiguous(),
            rk.reduce_block_bboxes(face_bbox, fb), fb, attr_coef)


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
    fuse_pass2: bool = True,
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
      fuse_pass2: kept from the JAX signature, and only True is accepted:
        the winner rows are always gathered, and shaded, by the fused pass-2
        wrapper (:func:`~.raster_kernels.pass2_shade`).
      worklist: run pass 1 through K3, the work list of intersecting (pixel
        tile, face block) pairs (:func:`~.raster_kernels.pass1_worklist`),
        instead of K1. The output is the same bit for bit; the full-frame
        renders of a small object (``eval/synthetic_benchmark.py``) ask for
        it, the tracking step's ROI renders keep K1.

    Returns rgb (H, W, 3) float32 in [0, 255] and depth_mm (H, W) float32
    (0 = no hit); (B, H, W, 3) and (B, H, W) for B poses.
    """
    if not fuse_pass2:
        raise ValueError("fuse_pass2=False (plain row indexing) is not part "
                         "of the port: pass 2 always gathers in its kernel")
    if pose.dim() == 3 and worklist:
        raise ValueError("a batch of poses renders through K1: worklist "
                         "takes one pose")
    fx, fy, fiz, fvalid, R, t = _project(mesh, pose, K, window, out_hw, near)
    # On the culled path the attribute forms are compacted together with
    # the pass-1 tables, so winner ids index the permuted space throughout.
    attr_coef = _face_attr_coefficients(fx, fy, fiz, fvalid, mesh)
    if cull_backfaces:
        coef, bbox, fb, attr_coef = culled_pass1_inputs(
            mesh, fx, fy, fiz, fvalid, R, t, attr_coef)
        iz, winner = _pass1_kernel(worklist)(coef, bbox, out_hw, fb)
    else:
        iz, winner = _pass1_iz(fx, fy, fiz, fvalid, out_hw, worklist)
    # zmin, coverage, hit (zmin < far) and the winner clamp are pass 2's.
    return rk.pass2_shade(attr_coef, iz, winner, R, t, out_hw, far,
                          texture=mesh.texture, lighting=lighting)


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
