"""The pass-1 skip predicate (``raster_kernels.pass1_may_cover``, the warp
binning of ``csrc/raster_pass1_block.cuh``) never drops a face that covers a
pixel of its rectangle, so K1 and K3 stay bit-equal to their plain versions.

Triangles are made with numpy from a seed: random ones over and past the
window, sliver-heavy ones, ones with every corner on a pixel centre, and
ones at 176^2 and 480x640 window coordinates. Rectangles are K1's 8 x 4
pixel patches and K3's runs of 32 consecutive pixels (a warp each)."""
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk

torch.set_num_threads(2)

PATCH_W, PATCH_H = 8, 4  # a K1 warp's pixels
WARP = 32                # a K3 warp's consecutive pixels


def _triangles(kind, F, hw, seed):
    """(fx, fy, fiz, fvalid) of F triangles over an (H, W) window."""
    rng = np.random.RandomState(seed)
    H, W = hw
    cx = rng.uniform(-10, W + 10, (F, 1))
    cy = rng.uniform(-10, H + 10, (F, 1))
    if kind == "slivers":
        # Two far corners and a third within a fraction of a pixel of the
        # line between them: long, thin, near-degenerate faces.
        ang = rng.uniform(0, np.pi, (F, 1))
        half = rng.uniform(3, 120, (F, 1))
        d = np.concatenate([np.cos(ang), np.sin(ang)], 1)
        off = rng.uniform(-1, 1, (F, 1)) * 10.0 ** rng.uniform(-3, 0, (F, 1))
        s = rng.uniform(-1, 1, (F, 1))
        c = np.concatenate([cx, cy], 1)
        pts = np.stack([c - half * d, c + half * d,
                        c + s * half * d + off * d[:, ::-1] * [-1, 1]], 1)
        fx, fy = pts[..., 0], pts[..., 1]
    else:
        size = rng.uniform(1.0, 25.0, (F, 1))
        fx = cx + rng.uniform(-1, 1, (F, 3)) * size
        fy = cy + rng.uniform(-1, 1, (F, 3)) * size
        if kind == "corners_on_centres":
            fx, fy = np.round(fx), np.round(fy)
    fiz = rng.uniform(0.5, 3.0, (F, 3))
    fvalid = rng.rand(F) > 0.05
    return tuple(torch.as_tensor(a, dtype=torch.float32) if a.dtype != bool
                 else torch.as_tensor(a) for a in (fx, fy, fiz, fvalid))


CASES = {  # kind, faces, window, face block
    "random": ("random", 700, (37, 53), 256),
    "slivers": ("slivers", 600, (57, 203), 512),
    "corners_on_centres": ("corners_on_centres", 500, (41, 67), 256),
    "roi176": ("random", 2048, (176, 176), 1024),
    "frame480x640": ("random", 300, (480, 640), 256),
}


def _case(name, seed=0):
    kind, F, hw, fb = CASES[name]
    fx, fy, fiz, fvalid = _triangles(kind, F, hw, seed)
    coef, ok = rk.build_face_coefficients(fx, fy, fiz, fvalid)
    return coef, rk.build_block_bboxes(fx, fy, fvalid, fb), hw, fb, ok


def _rects(hw, layout):
    """(pixel -> rectangle index (P,), rectangles (n, 4)) of K1's patches or
    K3's warps over an (H, W) window, each the bounds of its pixels."""
    H, W = hw
    q = torch.arange(H * W)
    x, y = q % W, q // W
    if layout == "k1":
        idx = (y // PATCH_H) * (-(-W // PATCH_W)) + x // PATCH_W
    else:
        idx = q // WARP
    n = int(idx.max()) + 1
    big = 1 << 30
    rect = torch.stack([
        torch.full((n,), big).scatter_reduce(0, idx, x, "amin"),
        torch.full((n,), -big).scatter_reduce(0, idx, x, "amax"),
        torch.full((n,), big).scatter_reduce(0, idx, y, "amin"),
        torch.full((n,), -big).scatter_reduce(0, idx, y, "amax")], 1)
    return idx, rect.to(torch.float32)


def _covered(coef, hw, sel):
    """(len(sel), F) bool: the exact forms of ``_update_block`` (one
    rounding per op) mark the face covering the pixel."""
    W = hw[1]
    qx = (sel % W).to(torch.float32)[:, None]
    qy = (sel // W).to(torch.float32)[:, None]

    def form(row):
        return (qx * coef[row][None, :] + qy * coef[row + 1][None, :]) \
            + coef[row + 2][None, :]

    e = torch.minimum(torch.minimum(form(rk.ROW_A0), form(rk.ROW_A1)),
                      form(rk.ROW_A2))
    return (e >= 0.0) & (form(rk.ROW_AW) > 0.0)


@pytest.mark.parametrize("layout", ["k1", "k3"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_covered_pairs_pass_the_skip_predicate(name, layout):
    """Every (pixel, face) pair the exact forms mark covered passes the
    predicate for the pixel's rectangle, and the predicate drops most
    faces of most rectangles (it is not vacuous)."""
    coef, _, hw, _, ok = _case(name)
    idx, rects = _rects(hw, layout)
    keep = rk.pass1_may_cover(coef, rects)  # (n rectangles, F)
    P = hw[0] * hw[1]
    n_cov = 0
    chunk = max(1, (1 << 21) // coef.shape[1])
    for sel in torch.split(torch.arange(P), chunk):
        cov = _covered(coef, hw, sel)
        n_cov += int(cov.sum())
        missed = cov & ~keep[idx[sel]]
        assert not missed.any(), (name, layout, torch.nonzero(missed)[:5])
    assert n_cov > 1000
    # Kept shares measured: 0.2-1.3% of the faces per K1 patch at 176^2
    # and 480x640, 5-9% in the small windows; K3's 32-pixel runs, up to 37%.
    assert keep.float().mean() < 0.4, float(keep.float().mean())
    assert not keep[:, ~ok].any()  # poisoned (invalid) faces never survive


def _culled_pass1(coef, bbox, hw, fb, layout):
    """The plain pass 1 (the block skip per pix_tile run and the packed-key
    update of ``pass1_winners_ref``), with each rectangle's pixels searching
    only the faces the predicate keeps for it (the others poisoned)."""
    H, W = hw
    P = H * W
    n_blocks = bbox.shape[0]
    coef = rk._padded_coef(coef, n_blocks, fb)
    px, py, q = rk._pixel_centres(P, W, "cpu")
    first_q = (q // rk.PIX_TILE) * rk.PIX_TILE
    y0 = (first_q // W).to(torch.float32)
    y1 = ((first_q + rk.PIX_TILE - 1) // W).to(torch.float32)
    idx, rects = _rects(hw, layout)
    keep = rk.pass1_may_cover(coef, rects)
    poison = torch.zeros((12, 1))
    poison[rk.ROW_C0:rk.ROW_C2 + 1:rk.ROW_C1 - rk.ROW_C0] = -1.0
    acc_key = torch.full((P,), -1, dtype=torch.int32)
    acc_idx = torch.zeros((P,), dtype=torch.int32)
    order = torch.argsort(idx, stable=True)
    starts = torch.searchsorted(idx[order], torch.arange(len(rects) + 1))
    for r in range(len(rects)):
        pix = order[starts[r]:starts[r + 1]]
        culled = torch.where(keep[r][None, :], coef, poison)
        for j in range(n_blocks):
            xmin, xmax, ymin, ymax = bbox[j]
            hit = ((xmax >= 0.0) & (xmin <= W - 1.0) & (ymax >= y0[pix])
                   & (ymin <= y1[pix]))
            sel = pix[hit]
            if sel.numel():
                s = j * fb
                rk._update_block(acc_key, acc_idx, sel, px, py,
                                 culled[:, s:s + fb], s, fb)
    return rk._winners_from_key(acc_key, acc_idx, hw, fb)


@pytest.mark.parametrize("layout", ["k1", "k3"])
@pytest.mark.parametrize("name", ["random", "slivers", "corners_on_centres",
                                  "roi176"])
def test_culling_leaves_pass1_bit_equal(name, layout):
    """Culling each rectangle's faces with the predicate before the plain
    search leaves iz and winners bit-equal to ``pass1_winners_ref``."""
    coef, bbox, hw, fb, _ = _case(name, seed=1)
    iz, win = rk.pass1_winners_ref(coef, bbox, hw, fb)
    iz_c, win_c = _culled_pass1(coef, bbox, hw, fb, layout)
    assert (iz > 0).sum() > 300
    assert torch.equal(win_c, win)
    assert torch.equal(iz_c.view(torch.int32), iz.view(torch.int32))


def test_skip_predicate_takes_one_rectangle_and_nan():
    """One rectangle gives (F,); a NaN coefficient is never dropped (it
    reaches the exact forms, which do not count it as covered)."""
    coef, _, hw, _, _ = _case("random")
    keep = rk.pass1_may_cover(coef, (10.0, 17.0, 4.0, 7.0))
    assert keep.shape == (coef.shape[1],)
    assert torch.equal(keep, rk.pass1_may_cover(
        coef, torch.tensor([[10.0, 17.0, 4.0, 7.0]]))[0])
    c = coef.clone()
    c[rk.ROW_A0, 0] = float("nan")
    c[rk.ROW_C1, 0] = -1e9  # would drop it on edge 1 alone
    assert bool(rk.pass1_may_cover(c, (0.0, 7.0, 0.0, 3.0))[0]) is False
    c[rk.ROW_C1, 0] = coef[rk.ROW_C1, 0]
    c[:, 1] = float("nan")
    assert bool(rk.pass1_may_cover(c, (0.0, 7.0, 0.0, 3.0))[1])
