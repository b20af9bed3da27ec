"""Pass-1 and pass-2 raster kernels: wrappers and their plain versions.

Counterpart of ``iros20_6d_pose_tracking_tpu/render/pallas_raster.py``:

  - the per-face builders (``build_face_coefficients``,
    ``build_face_bboxes``, ``reduce_block_bboxes``, ``build_block_bboxes``)
    with the same (12, F) row layout ``ROW_*``;
  - :func:`pass1_winners`, the z-buffer winner search (the TPU kernel
    ``_kernel`` / ``pallas_pass1``), CUDA source ``csrc/raster_pass1.cu``:
    pixel patches whose warps bin the faces with :func:`pass1_may_cover`;
  - :func:`pass2_shade`, pass 2 fused: the winner-row gather (the TPU
    kernel ``_gather_kernel`` / ``pallas_gather_rows``) and the shading
    that consumes the rows (:func:`shade_rows`, with :func:`zmin_from_iz`
    and ``_sample_texture`` part of its plain version) in one kernel, CUDA
    source ``csrc/pass2_shade.cu``. Every render's pass 2 runs through it;
  - :func:`gather_rows`, the row gather alone, CUDA source
    ``csrc/gather_rows.cu``: the standalone counterpart of
    ``pallas_gather_rows``, off the render path since :func:`pass2_shade`;
  - :func:`pass1_worklist`, the work-list pass 1 (the TPU kernel
    ``_wl_kernel`` / ``pallas_pass1_worklist``, with its list from
    :func:`build_worklist`), CUDA source ``csrc/raster_pass1_worklist.cu``.
    It gives K1's winners, computed only over the (pixel tile, face block)
    pairs that intersect, from an unordered list of (patch, chunk) items
    (:func:`worklist_items`) built on the device and folded with a packed
    max that makes the order of the items irrelevant.

``split_f32_to_bf16_terms`` is not ported: the TPU kernel gathers rows
with one-hot bf16 matmuls and needs the 3-term split to stay exact, while
Hopper loads the rows directly.

Each wrapper runs its plain version (``*_ref``, beside it) when its tensors
lie on the CPU, and launches its CUDA kernel when they lie on a CUDA
device; anything else raises. Each counts its kernel launches in a plain
integer attribute (``pass1_winners.launches``, ``pass2_shade.launches``,
``gather_rows.launches``, ``pass1_worklist.launches``), which
``utils.profiling.counters()`` reports as ``launches.<wrapper>``.
"""
from __future__ import annotations

import torch

from ..kernels import build as kbuild
from ..utils import profiling

# Coefficient row layout in the (12, F) matrix.
ROW_A0, ROW_B0, ROW_C0 = 0, 1, 2
ROW_A1, ROW_B1, ROW_C1 = 3, 4, 5
ROW_A2, ROW_B2, ROW_C2 = 6, 7, 8
ROW_AW, ROW_BW, ROW_CW = 9, 10, 11

# Pixels per tile of pass 1: the run of consecutive pixels whose row range
# the block-bbox skip test takes (K1, K3 and their plain versions). The TPU
# kernel's tile is 512 (DEF_PIX_TILE).
PIX_TILE = 128

_BIG = 3.0e8
# (pixel, face) pairs the plain pass-1 versions evaluate at a time: about
# 16 MB per float32 temporary, a few hundred MB at the peak.
_PAIRS_PER_CHUNK = 1 << 22


def build_face_coefficients(fx, fy, fiz, fvalid):
    """Per-face linear-form coefficients (..., 12, F), sign-folded, invalid
    faces poisoned to never-covered (0, 0, -1). Returns (coef, ok).

    fx, fy: (..., F, 3) screen coords of the triangle corners; fiz:
    (..., F, 3) per-corner 1/z; fvalid: (..., F) bool. Leading axes are
    views: every op is elementwise, so a view's coefficients are the same
    bits batched or alone."""
    x0, x1, x2 = fx[..., 0], fx[..., 1], fx[..., 2]
    y0, y1, y2 = fy[..., 0], fy[..., 1], fy[..., 2]
    a0, b0, c0 = y1 - y2, x2 - x1, x1 * y2 - x2 * y1
    a1, b1, c1 = y2 - y0, x0 - x2, x2 * y0 - x0 * y2
    a2, b2, c2 = y0 - y1, x1 - x0, x0 * y1 - x1 * y0
    area = a0 * x0 + b0 * y0 + c0
    ok = fvalid & (torch.abs(area) > 1e-4)
    s = torch.where(area >= 0, 1.0, -1.0)
    inv_area = torch.where(ok, 1.0 / torch.where(ok, area, 1.0), 0.0)
    w0, w1, w2 = (fiz[..., 0] * inv_area, fiz[..., 1] * inv_area,
                  fiz[..., 2] * inv_area)
    aw = a0 * w0 + a1 * w1 + a2 * w2
    bw = b0 * w0 + b1 * w1 + b2 * w2
    cw = c0 * w0 + c1 * w1 + c2 * w2

    def fold(v):
        return torch.where(ok, v * s, 0.0)

    def fold_c(v):
        return torch.where(ok, v * s, -1.0)

    coef = torch.stack([
        fold(a0), fold(b0), fold_c(c0),
        fold(a1), fold(b1), fold_c(c1),
        fold(a2), fold(b2), fold_c(c2),
        torch.where(ok, aw, 0.0), torch.where(ok, bw, 0.0),
        torch.where(ok, cw, 0.0),
    ], dim=-2)
    return coef.to(torch.float32), ok


def build_face_bboxes(fx, fy, fvalid):
    """Per-face screen bbox (..., F, 4): [xmin, xmax, ymin, ymax]; invalid
    faces get an empty bbox (xmin > xmax)."""
    v = fvalid[..., None]
    xmin = torch.where(v, fx, _BIG).amin(dim=-1)
    ymin = torch.where(v, fy, _BIG).amin(dim=-1)
    xmax = torch.where(v, fx, -_BIG).amax(dim=-1)
    ymax = torch.where(v, fy, -_BIG).amax(dim=-1)
    return torch.stack([xmin, xmax, ymin, ymax], dim=-1).to(torch.float32)


def reduce_block_bboxes(face_bbox, face_block: int):
    """Union per-face bboxes (..., F, 4) into per-face-block bboxes
    (..., F / face_block, 4). F must be a multiple of ``face_block``."""
    F = face_bbox.shape[-2]
    if F % face_block:
        raise ValueError(f"{F} faces is not a multiple of {face_block}")
    r = face_bbox.reshape(face_bbox.shape[:-2]
                          + (F // face_block, face_block, 4))
    return torch.stack([r[..., 0].amin(dim=-1), r[..., 1].amax(dim=-1),
                        r[..., 2].amin(dim=-1), r[..., 3].amax(dim=-1)],
                       dim=-1)


def build_block_bboxes(fx, fy, fvalid, face_block: int):
    """Per-face-block screen bbox (..., ceil(F / face_block), 4); a
    trailing partial block is padded with empty faces, and blocks without
    valid faces get an empty bbox (xmin > xmax)."""
    F = fx.shape[-2]
    pad = -F % face_block
    if pad:
        lead = fx.shape[:-2]
        fx = torch.cat([fx, fx.new_zeros(lead + (pad, 3))], dim=-2)
        fy = torch.cat([fy, fy.new_zeros(lead + (pad, 3))], dim=-2)
        fvalid = torch.cat([fvalid, fvalid.new_zeros(lead + (pad,))], dim=-1)
    return reduce_block_bboxes(build_face_bboxes(fx, fy, fvalid), face_block)


def _check_cuda(*named, strided=()):
    """Every (name, tensor, dtype) must be a tensor of that dtype on one
    CUDA device, contiguous unless its name is in ``strided``."""
    dev = named[0][1].device
    for name, t, dtype in named:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name} is on {t.device}: the kernel takes tensors on one "
                f"CUDA device (first on {dev}); the plain version takes them "
                "all on the CPU")
        if t.dtype != dtype or not (name in strided or t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor, "
                             f"got {t.dtype}")


# ---------------------------------------------------------------------------
# K1: pass-1 winner search.
# ---------------------------------------------------------------------------

def _check_pass1_args(coef, block_bbox, hw, face_block, pix_tile):
    """Validate K1/K3 arguments, (12, F) and (n_blocks, 4) for one view or
    (B, 12, F) and (B, n_blocks, 4) for B views. Returns n_blocks."""
    H, W = hw
    if coef.dim() not in (2, 3) or coef.shape[-2] != 12:
        raise ValueError(f"coef must be (12, F) or (B, 12, F), got "
                         f"{tuple(coef.shape)}")
    if face_block <= 0 or face_block & (face_block - 1):
        raise ValueError(f"face_block must be a power of two, got {face_block}")
    n_blocks = -(-coef.shape[-1] // face_block)
    want = coef.shape[:-2] + (n_blocks, 4)
    if tuple(block_bbox.shape) != want:
        raise ValueError(f"block_bbox must be {want}, got "
                         f"{tuple(block_bbox.shape)}")
    if pix_tile % 32 or not 32 <= pix_tile <= 1024:
        raise ValueError(f"pix_tile must be a multiple of 32 in [32, 1024], "
                         f"got {pix_tile}")
    if H < 0 or W <= 0:
        raise ValueError(f"bad window size {hw}")
    return n_blocks


def _padded_coef(coef, n_blocks: int, face_block: int):
    """coef with poisoned (never covered) lanes appended up to
    ``n_blocks * face_block`` faces."""
    pad = n_blocks * face_block - coef.shape[1]
    if not pad:
        return coef
    pad_coef = coef.new_zeros((12, pad))
    pad_coef[ROW_C0:ROW_C2 + 1:ROW_C1 - ROW_C0] = -1.0  # c0 c1 c2
    return torch.cat([coef, pad_coef], dim=1)


def _pixel_centres(P: int, W: int, dev):
    """(px, py) float32 of the flat pixel indices 0 .. P-1, and the indices."""
    q = torch.arange(P, dtype=torch.int32, device=dev)
    return (q % W).to(torch.float32), (q // W).to(torch.float32), q


def _update_block(acc_key, acc_idx, sel, px, py, c, block_start: int,
                  face_block: int):
    """Fold face block ``c`` (12, face_block) into the running (key, winner)
    of the pixels ``sel``: evaluate the four forms of every face as
    ``(px * a + py * b) + c`` (one rounding per op), take the max packed key
    ``(bits(iz) & ~(fb - 1)) | lane`` over the covered faces, and replace
    the running key only where it is strictly greater. Pixels go in chunks
    of at most ``_PAIRS_PER_CHUNK`` (pixel, face) pairs, so memory stays
    bounded whatever the frame size."""
    lane_mask = face_block - 1
    lanes = torch.arange(face_block, dtype=torch.int32, device=c.device)
    rows = max(1, _PAIRS_PER_CHUNK // face_block)
    for sel_c in torch.split(sel, rows):
        qx, qy = px[sel_c, None], py[sel_c, None]

        def form(row):
            return (qx * c[row][None, :] + qy * c[row + 1][None, :]) \
                + c[row + 2][None, :]

        e0, e1, e2 = form(ROW_A0), form(ROW_A1), form(ROW_A2)
        izp = form(ROW_AW)
        covered = (torch.minimum(torch.minimum(e0, e1), e2) >= 0.0) \
            & (izp > 0.0)
        key = torch.where(covered,
                          (izp.view(torch.int32) & ~lane_mask) | lanes, -1)
        best = key.amax(dim=1)
        old = acc_key[sel_c]
        better = best > old
        acc_key[sel_c] = torch.where(better, best, old)
        acc_idx[sel_c] = torch.where(better, (best & lane_mask) + block_start,
                                     acc_idx[sel_c])


def _winners_from_key(acc_key, acc_idx, hw, face_block: int):
    """(iz, winner) (H, W) from the running keys: iz -1 where no face
    covers."""
    iz = torch.where(acc_key < 0, -1.0,
                     (acc_key & ~(face_block - 1)).view(torch.float32))
    return iz.reshape(hw), acc_idx.reshape(hw)


def pass1_winners_ref(coef, block_bbox, hw: tuple[int, int],
                      face_block: int, pix_tile: int = PIX_TILE):
    """Plain version of :func:`pass1_winners`: the same algorithm in
    tensor ops, one face block at a time, in pixel chunks so memory stays
    bounded; a batch of views is a loop over them.

    Per face block, in ascending order: pixels whose tile (``pix_tile``
    consecutive pixels) passes the block-bbox test are folded in by
    :func:`_update_block`. With ``pix_tile=512`` this is the TPU kernel's
    exact algorithm, tile grid included."""
    n_blocks = _check_pass1_args(coef, block_bbox, hw, face_block, pix_tile)
    if coef.dim() == 3:
        views = [pass1_winners_ref(c, b, hw, face_block, pix_tile)
                 for c, b in zip(coef, block_bbox)]
        return (torch.stack([v[0] for v in views]),
                torch.stack([v[1] for v in views]))
    H, W = hw
    P = H * W
    dev = coef.device
    coef = _padded_coef(coef, n_blocks, face_block)
    px, py, q = _pixel_centres(P, W, dev)
    first_q = (q // pix_tile) * pix_tile
    y0 = (first_q // W).to(torch.float32)
    y1 = ((first_q + pix_tile - 1) // W).to(torch.float32)
    acc_key = torch.full((P,), -1, dtype=torch.int32, device=dev)
    acc_idx = torch.zeros((P,), dtype=torch.int32, device=dev)
    for j in range(n_blocks):
        xmin, xmax, ymin, ymax = block_bbox[j]
        hit = ((xmax >= 0.0) & (xmin <= W - 1.0) & (ymax >= y0)
               & (ymin <= y1))
        sel = torch.nonzero(hit).squeeze(1)
        if sel.numel() == 0:
            continue
        s = j * face_block
        _update_block(acc_key, acc_idx, sel, px, py,
                      coef[:, s:s + face_block], s, face_block)
    return _winners_from_key(acc_key, acc_idx, hw, face_block)


def pass1_may_cover(coef, rect):
    """K1's and K3's skip predicate, the warp-level binning of
    ``csrc/raster_pass1_block.cuh`` in tensor ops: False only where a face
    provably covers no pixel of a rectangle.

    coef (12, F); rect (..., 4) [xlo, xhi, ylo, yhi], the pixel-centre
    bounds of a warp's pixels. The rectangle is widened by one pixel, and a
    face is dropped when one of its edge forms has a maximum over the
    widened corners below 0, or its 1/z form a maximum <= 0. Returns (...,
    F) bool. The widening leaves a margin of |a| + |b| at every pixel of the
    rectangle, far above the forms' rounding, so a face the exact forms of
    :func:`_update_block` mark covered at a pixel always passes for that
    pixel's rectangle."""
    rect = torch.as_tensor(rect, dtype=torch.float32, device=coef.device)
    xlo, xhi, ylo, yhi = (rect[..., k, None] for k in range(4))
    xlo, ylo, xhi, yhi = xlo - 1.0, ylo - 1.0, xhi + 1.0, yhi + 1.0

    def rect_max(row):
        a, b, c = coef[row], coef[row + 1], coef[row + 2]
        return (a * torch.where(a >= 0.0, xhi, xlo)
                + b * torch.where(b >= 0.0, yhi, ylo) + c)

    return ~((rect_max(ROW_A0) < 0.0) | (rect_max(ROW_A1) < 0.0)
             | (rect_max(ROW_A2) < 0.0) | (rect_max(ROW_AW) <= 0.0))


def pass1_winners(coef, block_bbox, hw: tuple[int, int], face_block: int):
    """Pass-1 z-buffer winner search over the (12, F) coefficients for an
    (H, W) window. Returns (iz (H, W) f32, the winner's 1/z or -1 where no
    face covers; winner (H, W) int32, 0 where none). ``block_bbox`` is
    (ceil(F / face_block), 4); ``face_block`` a power of two.

    The kernel runs 16 x 16 pixel blocks, each warp an 8 x 4 patch that
    evaluates only the faces :func:`pass1_may_cover` keeps for it; what it
    leaves out cannot cover its pixels, so the result is the plain
    version's, bit for bit.

    A batch of B views, coef (B, 12, F) and block_bbox (B, n_blocks, 4),
    gives iz and winner (B, H, W) from one launch; view b equals the call
    on view b alone, bit for bit.

    CPU tensors run :func:`pass1_winners_ref`; CUDA tensors launch
    ``csrc/raster_pass1.cu`` on the current stream."""
    if coef.device.type == "cpu" and block_bbox.device.type == "cpu":
        return pass1_winners_ref(coef, block_bbox, hw, face_block)
    n_blocks = _check_pass1_args(coef, block_bbox, hw, face_block, PIX_TILE)
    _check_cuda(("coef", coef, torch.float32),
                ("block_bbox", block_bbox, torch.float32))
    H, W = hw
    lead = coef.shape[:-2]
    B = coef.shape[0] if lead else 1
    dev = coef.device
    iz = torch.empty(lead + (H, W), dtype=torch.float32, device=dev)
    winner = torch.empty(lead + (H, W), dtype=torch.int32, device=dev)
    if B == 0:
        return iz, winner
    lib = kbuild.load("raster_pass1")
    with torch.cuda.device(dev):
        err = lib.raster_pass1(coef.data_ptr(), block_bbox.data_ptr(),
                               iz.data_ptr(), winner.data_ptr(),
                               coef.shape[-1], n_blocks, face_block, H, W,
                               PIX_TILE, B,
                               torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(lib, "raster_pass1", err)
    pass1_winners.launches += 1
    return iz, winner


pass1_winners.launches = 0


# ---------------------------------------------------------------------------
# Pass 2 fused: row gather and shading.
# ---------------------------------------------------------------------------

# The reference's shading: diffuse 0.4 x max(n . l, 0) + ambient 0.65,
# clamped, with a camera-space light slightly above the optical axis.
AMBIENT = 0.65
DIFFUSE = 0.4
LIGHT_CAM = (0.0, -0.1, -0.9)


def zmin_from_iz(iz):
    """Metric depth from pass 1's best 1/z: inf where no face covers."""
    return torch.where(iz > 1e-9, 1.0 / torch.clamp(iz, min=1e-9),
                       torch.inf)


def _sample_texture(texture, u, v):
    """Bilinear texture fetch at OBJ-convention UVs (origin bottom-left,
    wrap addressing). texture (Th, Tw, 3); u, v (..., P). Returns
    (..., P, 3)."""
    th, tw = texture.shape[:2]
    # Wrap, then flip v: image row 0 is the top of the texture.
    x = (u - torch.floor(u)) * (tw - 1)
    y = (1.0 - (v - torch.floor(v))) * (th - 1)
    x0 = torch.clamp(torch.floor(x), 0, tw - 1)
    y0 = torch.clamp(torch.floor(y), 0, th - 1)
    x1 = torch.clamp(x0 + 1, max=tw - 1)
    y1 = torch.clamp(y0 + 1, max=th - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat = texture.reshape(-1, 3)
    xi0, yi0 = x0.to(torch.int64), y0.to(torch.int64)
    xi1, yi1 = x1.to(torch.int64), y1.to(torch.int64)
    c00 = flat[yi0 * tw + xi0]
    c01 = flat[yi0 * tw + xi1]
    c10 = flat[yi1 * tw + xi0]
    c11 = flat[yi1 * tw + xi1]
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def shade_rows(R, t, row, hit_f, out_hw, texture=None, lighting=None):
    """Shade pre-gathered per-pixel attribute rows (P, 30), or (P, 36) with
    UV forms, in which case ``texture`` is sampled for the albedo. Depth is
    taken from the row's 1/z form (the JAX Pallas path's
    ``depth_from_form=True``). Part of :func:`pass2_shade_ref`; the kernel
    computes the same per pixel.

    ``lighting``: optional (5,) [ambient, diffuse, lx, ly, lz] overriding
    the reference's shading constants. Returns rgb (H, W, 3) in [0, 255]
    and depth (H, W) in mm, both 0 where ``hit_f`` is False. A batch of
    views, R (B, 3, 3), t (B, 3), rows (B, P, C) and ``hit_f`` (B, P),
    gives (B, H, W, 3) and (B, H, W)."""
    H, W = out_hw
    lead = row.shape[:-2]
    dev = row.device
    if lighting is None:
        ambient, diffuse, light_cam = AMBIENT, DIFFUSE, LIGHT_CAM
    else:
        lighting = torch.as_tensor(lighting, dtype=torch.float32, device=dev)
        ambient, diffuse, light_cam = lighting[0], lighting[1], lighting[2:5]
    pxg, pyg = torch.meshgrid(
        torch.arange(W, dtype=torch.float32, device=dev),
        torch.arange(H, dtype=torch.float32, device=dev), indexing="xy")
    pix_x = pxg.reshape(-1)
    pix_y = pyg.reshape(-1)

    izpix = row[..., 0] * pix_x + row[..., 1] * pix_y + row[..., 2]
    inv_iz = 1.0 / torch.clamp(izpix, min=1e-9)

    def attr(base, c=3):
        al = row[..., base:base + c]
        be = row[..., base + c:base + 2 * c]
        ga = row[..., base + 2 * c:base + 3 * c]
        num = al * pix_x[:, None] + be * pix_y[:, None] + ga
        return num * inv_iz[..., None]

    if texture is not None and row.shape[-1] >= 36:
        uv = attr(30, c=2)
        albedo = _sample_texture(texture, uv[..., 0], uv[..., 1])
    else:
        albedo = attr(3)
    # x @ R^T: object -> camera rotation, one R per view.
    n_cam = attr(12) @ R.transpose(-1, -2)
    n_cam = n_cam / torch.clamp(
        torch.linalg.vector_norm(n_cam, dim=-1, keepdim=True), min=1e-9)
    p_cam = attr(21) @ R.transpose(-1, -2) + t[..., None, :]
    # Per component, so the default light stays Python floats: a
    # torch.tensor() of it would be a host copy that waits for the stream.
    l_vec = torch.stack([light_cam[i] - p_cam[..., i] for i in range(3)], -1)
    l_dir = l_vec / torch.clamp(
        torch.linalg.vector_norm(l_vec, dim=-1, keepdim=True), min=1e-9)
    ndotl = torch.clamp(torch.sum(n_cam * l_dir, dim=-1), min=0.0)
    shade = torch.clamp(albedo * (ambient + diffuse * ndotl)[..., None],
                        0.0, 1.0)
    rgb = torch.where(hit_f[..., None], shade * 255.0, 0.0).reshape(
        lead + (H, W, 3))
    depth_mm = torch.where(hit_f, inv_iz * 1000.0, 0.0).reshape(
        lead + (H, W))
    return rgb, depth_mm


def pass2_shade_ref(attr, iz, winner, R, t, out_hw: tuple[int, int],
                    far: float, texture=None, lighting=None):
    """Plain version of :func:`pass2_shade`: the unfused pass 2, op for op.
    zmin from pass 1's 1/z, coverage and hit, the winner clamp,
    :func:`gather_rows_ref` and :func:`shade_rows`."""
    zmin = zmin_from_iz(iz)
    winner = torch.clamp(winner, 0, attr.shape[-2] - 1)
    hit = torch.isfinite(zmin) & (zmin < far)
    flat = zmin.shape[:-2] + (-1,)
    covered = torch.isfinite(zmin.reshape(flat))
    row = gather_rows_ref(attr, winner.reshape(flat), covered)
    return shade_rows(R, t, row, hit.reshape(flat), out_hw,
                      texture=texture, lighting=lighting)


def pass2_shade(attr, iz, winner, R, t, out_hw: tuple[int, int],
                far: float, texture=None, lighting=None):
    """Pass 2: each pixel's winner row of the attribute forms, gathered and
    shaded. Returns rgb (H, W, 3) in [0, 255] and depth (H, W) in mm, both
    0 where pass 1 found no surface nearer than ``far`` (metres).

    attr (F, 30), or (F, 36) with UV forms (then ``texture`` (Th, Tw, 3)
    is sampled for the albedo); iz and winner (H, W), pass 1's outputs; R
    (3, 3) and t (3,) object to camera (views of the pose matrix are fine);
    ``lighting`` None or (5,) [ambient, diffuse, lx, ly, lz]. A batch of B
    views takes attr (B, F, C), iz and winner (B, H, W), R (B, 3, 3) and t
    (B, 3), in one launch, and gives (B, H, W, 3) and (B, H, W).

    CPU tensors run :func:`pass2_shade_ref`; CUDA tensors launch
    ``csrc/pass2_shade.cu`` on the current stream: depth and hit the plain
    version's bits, rgb within float32 rounding of it. The gathered rows are
    never written."""
    f32 = torch.float32
    named = [("attr", attr, f32), ("iz", iz, f32),
             ("winner", winner, torch.int32), ("R", R, f32), ("t", t, f32)]
    if texture is not None:
        named.append(("texture", texture, f32))
    if torch.is_tensor(lighting):
        named.append(("lighting", lighting, f32))
    if all(v.device.type == "cpu" for _, v, _ in named):
        return pass2_shade_ref(attr, iz, winner, R, t, out_hw, far,
                               texture=texture, lighting=lighting)
    H, W = out_hw
    lead = iz.shape[:-2]
    C = attr.shape[-1]
    if len(lead) > 1 or tuple(iz.shape) != lead + (H, W) or \
            tuple(winner.shape) != tuple(iz.shape) or \
            attr.dim() != len(lead) + 2 or attr.shape[:-2] != lead or \
            C not in (30, 36) or tuple(R.shape) != lead + (3, 3) or \
            tuple(t.shape) != lead + (3,):
        raise ValueError(
            f"need attr ([B,] F, 30|36), iz and winner ([B,] {H}, {W}), R "
            f"([B,] 3, 3), t ([B,] 3); got {tuple(attr.shape)}, "
            f"{tuple(iz.shape)}, {tuple(winner.shape)}, {tuple(R.shape)}, "
            f"{tuple(t.shape)}")
    if lighting is not None and not torch.is_tensor(lighting):
        lighting = torch.as_tensor(lighting, dtype=f32, device=iz.device)
        named.append(("lighting", lighting, f32))
    if lighting is not None and lighting.shape != (5,):
        raise ValueError(f"lighting must be (5,), got {tuple(lighting.shape)}")
    _check_cuda(*named, strided=("R", "t"))
    if texture is not None and (texture.dim() != 3 or texture.shape[2] != 3):
        raise ValueError(f"texture must be (Th, Tw, 3), got "
                         f"{tuple(texture.shape)}")
    if attr.data_ptr() % 8:
        raise ValueError("attr rows must be 8-byte aligned")
    B = lead[0] if lead else 1
    F = attr.shape[-2]
    if B * F * C >= 2 ** 31:
        raise ValueError(f"{B} x {F} x {C} attribute floats do not fit int32")
    r_sv, r_si, r_sj = R.stride() if lead else (0,) + R.stride()
    t_sv, t_si = t.stride() if lead else (0,) + t.stride()
    th, tw = texture.shape[:2] if texture is not None else (0, 0)
    dev = iz.device
    rgb = torch.empty(lead + (H, W, 3), dtype=torch.float32, device=dev)
    depth = torch.empty(lead + (H, W), dtype=torch.float32, device=dev)
    lib = kbuild.load("pass2_shade")
    with torch.cuda.device(dev):
        err = lib.pass2_shade(
            attr.data_ptr(), iz.data_ptr(), winner.data_ptr(), R.data_ptr(),
            t.data_ptr(), lighting.data_ptr() if lighting is not None else None,
            texture.data_ptr() if texture is not None else None,
            rgb.data_ptr(), depth.data_ptr(), B, H, W, F, C, r_sv, r_si, r_sj,
            t_sv, t_si, th, tw, float(far),
            torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(lib, "pass2_shade", err)
    pass2_shade.launches += 1
    return rgb, depth


pass2_shade.launches = 0


# ---------------------------------------------------------------------------
# K2: pass-2 row gather.
# ---------------------------------------------------------------------------

def _flat_views(attr, winner, covered):
    """A batch of views as one gather: attr (B, F, C) -> (B * F, C) and
    each view's winners offset by b * F (int32)."""
    B, F, C = attr.shape
    offset = (torch.arange(B, dtype=torch.int32, device=winner.device)
              * F)[:, None]
    return (attr.reshape(B * F, C), (winner + offset).reshape(-1),
            covered.reshape(-1))


def gather_rows_ref(attr, winner, covered):
    """Plain version of :func:`gather_rows`."""
    if attr.dim() == 3:
        rows = gather_rows_ref(*_flat_views(attr, winner, covered))
        return rows.reshape(winner.shape + (attr.shape[-1],))
    return torch.where(covered[:, None], attr[winner], 0.0)


def gather_rows(attr, winner, covered):
    """rows[p, :] = attr[winner[p], :] where ``covered[p]``, else 0: the
    standalone counterpart of ``pallas_gather_rows``. A render's pass 2 no
    longer calls it; :func:`pass2_shade` gathers and shades in one kernel.

    attr (F, C) float32; winner (P,) int32, in [0, F) where covered;
    covered (P,) bool. A batch of B views, attr (B, F, C), winner and
    covered (B, P), is one launch over the views' rows stacked (each
    view's winners offset by b * F) and gives rows (B, P, C).

    CPU tensors run :func:`gather_rows_ref`; CUDA tensors launch
    ``csrc/gather_rows.cu`` on the current stream."""
    tensors = (("attr", attr, torch.float32), ("winner", winner, torch.int32),
               ("covered", covered, torch.bool))
    if all(t.device.type == "cpu" for _, t, _ in tensors):
        return gather_rows_ref(attr, winner, covered)
    batched = attr.dim() == 3
    if attr.dim() - 1 != winner.dim() or winner.dim() not in (1, 2) or \
            tuple(covered.shape) != tuple(winner.shape) or \
            (batched and winner.shape[0] != attr.shape[0]):
        raise ValueError(f"need attr (F, C), winner (P,), covered (P,) or "
                         f"attr (B, F, C), winner (B, P), covered (B, P); got "
                         f"{tuple(attr.shape)}, {tuple(winner.shape)}, "
                         f"{tuple(covered.shape)}")
    _check_cuda(*tensors)
    out_shape = winner.shape + (attr.shape[-1],)
    if batched:
        if attr.shape[0] * attr.shape[1] >= 2 ** 31:
            raise ValueError(f"{attr.shape[0]} x {attr.shape[1]} rows do not "
                             "fit int32 winner ids")
        attr, winner, covered = _flat_views(attr, winner, covered)
    F, C = attr.shape
    P = winner.shape[0]
    dev = attr.device
    rows = torch.empty((P, C), dtype=torch.float32, device=dev)
    lib = kbuild.load("gather_rows")
    with torch.cuda.device(dev):
        err = lib.gather_rows(attr.data_ptr(), winner.data_ptr(),
                              covered.data_ptr(), rows.data_ptr(), F, C, P,
                              torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(lib, "gather_rows", err)
    gather_rows.launches += 1
    return rows.reshape(out_shape)


gather_rows.launches = 0


# ---------------------------------------------------------------------------
# K3: work-list pass 1.
# ---------------------------------------------------------------------------

# K3's patches (the pixels its thread block bins and searches at a time)
# are K3_PATCH x K3_PATCH pixels; an item searches one chunk of at most
# K3_CHUNK faces of one face block (the faces a thread block stages at a
# time, csrc/raster_pass1_block.cuh kChunk).
K3_PATCH = 16
K3_CHUNK = 256


def _run_hits(block_bbox, hw: tuple[int, int], pix_tile: int):
    """(n_tiles, n_blocks) bool: block j's bbox meets the window's columns
    and the rows of tile t, the run of ``pix_tile`` consecutive pixels
    from t * pix_tile (K1's skip test, the TPU list's intersection test)."""
    H, W = hw
    n_tiles = -(-(H * W) // pix_tile)
    tile_first = torch.arange(n_tiles, device=block_bbox.device) * pix_tile
    y0 = (tile_first // W).to(torch.float32)
    y1 = ((tile_first + pix_tile - 1) // W).to(torch.float32)
    xmin, xmax, ymin, ymax = block_bbox.unbind(1)
    return ((xmax[None, :] >= 0.0) & (xmin[None, :] <= W - 1.0)
            & (ymax[None, :] >= y0[:, None]) & (ymin[None, :] <= y1[:, None]))


def build_worklist(block_bbox, hw: tuple[int, int], pix_tile: int = PIX_TILE):
    """Tile-major compacted list of the (pixel tile, face block) pairs that
    intersect, as the JAX ``build_worklist`` makes it: (tile_ids, block_ids,
    init_flags, valid_flags), each (n_tiles * n_blocks,) int32.

    A pair intersects when the block's bbox meets the window's columns and
    the tile's pixel rows (K1's skip test). The real entries come first, in
    tile-major order with each tile's blocks ascending; the padding entries
    repeat the last real tile with block 0 and valid 0. ``init_flags`` marks
    each tile's first entry. The partition is a stable scatter, not a sort,
    and the count of real entries stays on the device.

    The counterpart of the TPU function, and the tests' yardstick for the
    pairs K3 visits; :func:`pass1_worklist` and its plain version no longer
    call it (they build :func:`worklist_items`)."""
    nb = block_bbox.shape[0]
    dev = block_bbox.device
    flat = _run_hits(block_bbox, hw, pix_tile).reshape(-1)
    k = flat.to(torch.int64)
    n_real = k.sum()
    dest = torch.where(flat, torch.cumsum(k, 0) - 1,
                       n_real + torch.cumsum(1 - k, 0) - 1)
    idx = torch.arange(flat.numel(), device=dev)
    order = torch.empty_like(dest).scatter_(0, dest, idx)
    valid = idx < n_real
    tiles, blocks = order // nb, order % nb
    last_real_tile = tiles.index_select(0, torch.clamp(n_real - 1, min=0)
                                        .reshape(1))
    tiles = torch.where(valid, tiles, last_real_tile)
    blocks = torch.where(valid, blocks, 0)
    first = valid & ((idx == 0) | (tiles != torch.roll(tiles, 1)))
    return tuple(a.to(torch.int32) for a in (tiles, blocks, first, valid))


def _one_view(coef):
    if coef.dim() != 2:
        raise ValueError("the work-list pass 1 takes one view, coef (12, F); "
                         f"got {tuple(coef.shape)}")


def _k3_scratch_bytes(hw: tuple[int, int], n_blocks: int, face_block: int):
    """Bytes of the scratch buffer K3's C entry takes, whole 8-byte words:
    an item counter per chunk (int32), an accumulator per pixel (64-bit)
    and each chunk's room for one item (int32, a patch) per patch."""
    H, W = hw
    n_patches = -(-H // K3_PATCH) * -(-W // K3_PATCH)
    n_chunks = n_blocks * (face_block // min(K3_CHUNK, face_block))
    return 8 * (-(-n_chunks // 2) + H * W + -(-n_chunks * n_patches // 2))


def worklist_items(block_bbox, hw: tuple[int, int], n_faces: int,
                   face_block: int, pix_tile: int = PIX_TILE,
                   generator: torch.Generator | None = None):
    """K3's work list as its phase A builds it: (n_items, 3) int64 rows
    (patch, block, chunk). Patch p is the K3_PATCH x K3_PATCH pixels from
    (p % gx, p // gx) * K3_PATCH, gx = ceil(W / K3_PATCH); chunk k of block j
    the faces from j * face_block + k * min(K3_CHUNK, face_block), never past
    the block's end nor past ``n_faces``.

    A block is listed for a patch when the run test (:func:`_run_hits`)
    passes for the run of some pixel of the patch inside the window; the
    patch then gets one item per chunk of the block. The kernel appends
    each chunk's items to that chunk's list, in no set order; here they come
    patch-major, blocks and chunks ascending, or, with ``generator`` (a CPU
    generator), in an order it draws."""
    H, W = hw
    dev = block_bbox.device
    nb = block_bbox.shape[0]
    gx = -(-W // K3_PATCH)
    n_patches = -(-H // K3_PATCH) * gx
    run_hit = _run_hits(block_bbox, hw, pix_tile)
    q = torch.arange(H * W, device=dev)
    patch = (q // W // K3_PATCH) * gx + q % W // K3_PATCH
    # The (patch, run) pairs of the window's pixels; a block is needed by a
    # patch when it passes the run test of one of them.
    n_tiles = run_hit.shape[0]
    pairs = torch.unique(patch * n_tiles + q // pix_tile)
    need = torch.zeros((n_patches, nb), dtype=torch.int32, device=dev)
    need.index_add_(0, pairs // n_tiles, run_hit[pairs % n_tiles].to(
        torch.int32))
    p_ids, j_ids = torch.nonzero(need).unbind(1)
    cs = min(K3_CHUNK, face_block)
    per_block = torch.clamp(
        (n_faces - torch.arange(nb, device=dev) * face_block + cs - 1) // cs,
        max=face_block // cs)[j_ids]
    item_of = torch.repeat_interleave(torch.arange(p_ids.numel(), device=dev),
                                      per_block)
    first = torch.cumsum(per_block, 0) - per_block
    chunk = torch.arange(item_of.numel(), device=dev) - first[item_of]
    items = torch.stack([p_ids[item_of], j_ids[item_of], chunk], 1)
    if generator is not None:
        items = items[torch.randperm(items.shape[0], generator=generator)
                      .to(dev)]
    return items


def pass1_worklist_ref(coef, block_bbox, hw: tuple[int, int],
                       face_block: int, pix_tile: int = PIX_TILE,
                       generator: torch.Generator | None = None):
    """Plain version of :func:`pass1_worklist`: the kernel's algorithm in
    tensor ops. The items (:func:`worklist_items`; in the order
    ``generator`` draws, when given) are folded in, a batch at a time, into
    an int64 accumulator per pixel: for each item, each pixel of its patch
    inside the window whose run passes the test for the item's block takes
    the max packed key ``(bits(iz) & ~(fb - 1)) | lane`` over the chunk's
    covered faces (forms rounded after every op, as :func:`_update_block`)
    and, where one covers it, ``((key + 1) << 32) | (n_blocks - 1 - j)`` is
    max-ed into its accumulator. Decoding: where 0, iz -1 and winner 0;
    else key and block j from the two halves. The packed max is the
    lexicographic max of (key, -j), where the TPU's ascending, strict-``>``
    walk over the blocks ends, so the order of the items does not matter."""
    n_blocks = _check_pass1_args(coef, block_bbox, hw, face_block, pix_tile)
    _one_view(coef)
    H, W = hw
    P = H * W
    dev = coef.device
    F = coef.shape[1]
    items = worklist_items(block_bbox, hw, F, face_block, pix_tile, generator)
    coef = _padded_coef(coef, n_blocks, face_block)
    run_hit = _run_hits(block_bbox, hw, pix_tile)
    gx = -(-W // K3_PATCH)
    cs = min(K3_CHUNK, face_block)
    lane_mask = face_block - 1
    t = torch.arange(K3_PATCH * K3_PATCH, device=dev)
    lanes = torch.arange(cs, device=dev)
    # acc[P] takes the pixels an item does not search.
    acc = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    per_batch = max(1, _PAIRS_PER_CHUNK // (t.numel() * cs))
    for batch in torch.split(items, per_batch):
        patch, j, k = batch.unbind(1)
        x = (patch % gx * K3_PATCH)[:, None] + t % K3_PATCH
        y = (patch // gx * K3_PATCH)[:, None] + t // K3_PATCH
        q = y * W + x
        hit = (x < W) & (y < H) & run_hit[
            torch.clamp(q // pix_tile, max=run_hit.shape[0] - 1), j[:, None]]
        faces = (j * face_block + k * cs)[:, None] + lanes
        c = coef[:, faces][:, :, None, :]  # (12, items, 1, cs)
        px = x.to(torch.float32)[:, :, None]
        py = y.to(torch.float32)[:, :, None]

        def form(row):
            return (px * c[row] + py * c[row + 1]) + c[row + 2]

        e0, e1, e2 = form(ROW_A0), form(ROW_A1), form(ROW_A2)
        izp = form(ROW_AW)
        covered = (torch.minimum(torch.minimum(e0, e1), e2) >= 0.0) \
            & (izp > 0.0)
        key = torch.where(covered, (izp.view(torch.int32) & ~lane_mask)
                          | (faces & lane_mask).to(torch.int32)[:, None, :],
                          -1)
        best = key.amax(dim=2).to(torch.int64)
        packed = torch.where(best >= 0, ((best + 1) << 32)
                             | (n_blocks - 1 - j)[:, None], 0)
        acc.scatter_reduce_(0, torch.where(hit, q, P).reshape(-1),
                            packed.reshape(-1), "amax")
    hi = acc[:P] >> 32
    key = hi - 1
    j = n_blocks - 1 - (acc[:P] & 0xFFFFFFFF)
    iz = torch.where(hi == 0, -1.0,
                     (key & ~lane_mask).to(torch.int32).view(torch.float32))
    winner = torch.where(hi == 0, 0, (key & lane_mask) + j * face_block)
    return iz.reshape(hw), winner.to(torch.int32).reshape(hw)


def pass1_worklist(coef, block_bbox, hw: tuple[int, int], face_block: int):
    """Pass 1 over the work list of intersecting (pixel tile, face block)
    pairs: the same (iz, winner) as :func:`pass1_winners` on the same
    arguments.

    CPU tensors run :func:`pass1_worklist_ref`; CUDA tensors launch
    ``csrc/raster_pass1_worklist.cu`` on the current stream: one cooperative
    kernel builds the list on the device (:func:`worklist_items`,
    unordered), searches it on every SM and decodes, with nothing on the
    host waiting for it. The only torch calls are the allocations of the
    outputs and of one scratch buffer."""
    if coef.device.type == "cpu" and block_bbox.device.type == "cpu":
        return pass1_worklist_ref(coef, block_bbox, hw, face_block)
    n_blocks = _check_pass1_args(coef, block_bbox, hw, face_block, PIX_TILE)
    _one_view(coef)
    _check_cuda(("coef", coef, torch.float32),
                ("block_bbox", block_bbox, torch.float32))
    if block_bbox.data_ptr() % 16:
        raise ValueError("block_bbox rows must be 16-byte aligned")
    H, W = hw
    dev = coef.device
    iz = torch.empty((H, W), dtype=torch.float32, device=dev)
    winner = torch.empty((H, W), dtype=torch.int32, device=dev)
    scratch_bytes = _k3_scratch_bytes(hw, n_blocks, face_block)
    scratch = torch.empty(scratch_bytes // 8, dtype=torch.int64, device=dev)
    lib = kbuild.load("raster_pass1_worklist")
    with torch.cuda.device(dev):
        err = lib.raster_pass1_worklist(
            coef.data_ptr(), block_bbox.data_ptr(), scratch.data_ptr(),
            scratch_bytes, iz.data_ptr(), winner.data_ptr(), coef.shape[1],
            n_blocks, face_block, H, W, PIX_TILE,
            torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(lib, "raster_pass1_worklist", err)
    pass1_worklist.launches += 1
    return iz, winner


pass1_worklist.launches = 0


for _name in ("pass1_winners", "pass2_shade", "gather_rows",
              "pass1_worklist"):
    # read through the module, where a caller may have swapped the wrapper
    profiling.register(f"launches.{_name}", lambda n=_name: getattr(
        globals()[n], "launches", 0))
