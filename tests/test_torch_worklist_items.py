"""K3's unordered work list and its order-free fold, against the JAX package.

The items K3's phase A appends (``worklist_items``: (patch, block, chunk))
must make every pixel search exactly the face blocks that JAX's
``build_worklist`` lists for its tile, every chunk of each once. The plain
K3 folds them with the packed lexicographic max of (key, -block), so any
order of the items gives the bits of ``pallas_pass1_worklist`` in
interpret mode and of the port's K1, ties across blocks going to the lowest
block. Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.render import mesh as M
from iros20_6d_pose_tracking_tpu.render import pallas_raster as pr
from iros20_6d_pose_tracking_tpu.render import rasterizer as Rz
from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk

torch.set_num_threads(2)

K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]], np.float32)
HW = (128, 128)
WIN = (150.0, 450.0, 100.0, 400.0)
POSE = np.array([[0.87, -0.29, 0.40, 0.03], [0.35, 0.93, -0.07, 0.02],
                 [-0.35, 0.21, 0.91, 0.55], [0, 0, 0, 1]], np.float32)
SEEDS = (0, 1, 2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _orders():
    """No generator (patch-major order) and three seeded permutations."""
    return [None] + [torch.Generator().manual_seed(s) for s in SEEDS]


@pytest.fixture(scope="module")
def projected():
    """The subdiv-3 icosphere (1280 faces padded to 2048) projected into a
    128^2 window, as numpy (fx, fy, fiz, fvalid)."""
    mesh = Rz.upload(M.make_icosphere(subdiv=3, radius=0.04))
    fx, fy, fiz, fvalid, _, _ = Rz._project(mesh, jnp.asarray(POSE),
                                            jnp.asarray(K), WIN, HW, 0.1)
    return tuple(np.asarray(a) for a in (fx, fy, fiz, fvalid))


def _triangles(rng, F, hw, size):
    """F random triangles up to ``size`` pixels across over (and past) an
    (H, W) window, as float32 numpy (fx, fy, fiz) and fvalid."""
    H, W = hw
    cx = rng.uniform(-5, W + 5, (F, 1))
    cy = rng.uniform(-5, H + 5, (F, 1))
    fx = (cx + rng.uniform(-1, 1, (F, 3)) * size).astype(np.float32)
    fy = (cy + rng.uniform(-1, 1, (F, 3)) * size).astype(np.float32)
    fiz = rng.uniform(0.5, 3.0, (F, 3)).astype(np.float32)
    return fx, fy, fiz, rng.rand(F) > 0.1


def _ragged(seed=5, F=768, hw=(37, 53), fb=256):
    """Large random triangles over a window whose pixel count is no multiple
    of any tile: numpy coef (12, F) and block bboxes."""
    rng = np.random.RandomState(seed)
    H, W = hw
    fx = rng.uniform(-5, W + 5, (F, 3)).astype(np.float32)
    fy = rng.uniform(-5, H + 5, (F, 3)).astype(np.float32)
    fiz = rng.uniform(0.5, 3.0, (F, 3)).astype(np.float32)
    fvalid = rng.rand(F) > 0.1
    coef, _ = pr.build_face_coefficients(fx, fy, fiz, fvalid)
    return np.asarray(coef), np.asarray(
        pr.build_block_bboxes(fx, fy, fvalid, fb))


def _bboxes():
    """Block bboxes of three kinds: a sparse object in a wide frame, ragged
    random triangles, and a frame nothing reaches (no real entry)."""
    mesh = Rz.upload(M.make_icosphere(subdiv=3, radius=0.04))
    k = K.copy()
    k[1, 2] = 48.0
    fx, fy, _, fvalid, _, _ = Rz._project(
        mesh, jnp.asarray(POSE), jnp.asarray(k), Rz.full_frame_window(640, 96),
        (96, 640), 0.1)
    sparse = np.asarray(pr.build_block_bboxes(fx, fy, fvalid, 256))
    empty = np.tile(np.array([[900.0, 950.0, -40.0, -20.0]], np.float32),
                    (3, 1))
    return {"sparse": (sparse, (96, 640)), "ragged": (_ragged()[1], (37, 53)),
            "empty": (empty, (37, 53))}


def _jax_pixel_blocks(bbox, hw, pix_tile):
    """The (pixel, block) pairs of JAX's list, expanded to pixels, encoded
    as pixel * n_blocks + block, sorted."""
    H, W = hw
    nb = bbox.shape[0]
    tiles, blocks, _, valid = (np.asarray(a) for a in pr.build_worklist(
        jnp.asarray(bbox), hw, pix_tile, W))
    v = valid == 1
    q = (tiles[v].astype(np.int64)[:, None] * pix_tile
         + np.arange(pix_tile)).reshape(-1)
    j = np.repeat(blocks[v].astype(np.int64), pix_tile)
    keep = q < H * W
    return np.unique(q[keep] * nb + j[keep])


def _item_pixel_blocks(items, bbox, hw, pix_tile):
    """The (pixel, block) pairs the items make a pixel search: each pixel of
    the item's patch inside the window whose own run passes the bbox test
    of the item's block (computed here in numpy), encoded as above."""
    H, W = hw
    nb = bbox.shape[0]
    gx = -(-W // rk.K3_PATCH)
    patch, j = items[:, 0], items[:, 1]
    t = np.arange(rk.K3_PATCH * rk.K3_PATCH)
    x = (patch % gx * rk.K3_PATCH)[:, None] + t % rk.K3_PATCH
    y = (patch // gx * rk.K3_PATCH)[:, None] + t // rk.K3_PATCH
    q = y * W + x
    first = q // pix_tile * pix_tile
    y0 = (first // W).astype(np.float32)
    y1 = ((first + pix_tile - 1) // W).astype(np.float32)
    b = bbox[j][:, None, :]
    hit = ((x < W) & (y < H) & (b[..., 1] >= 0.0)
           & (b[..., 0] <= np.float32(W - 1.0)) & (b[..., 3] >= y0)
           & (b[..., 2] <= y1))
    return np.unique((q * nb + j[:, None])[hit])


@pytest.mark.parametrize("case", ["sparse", "ragged", "empty"])
@pytest.mark.parametrize("face_block", [128, 256, 1024])
def test_items_visit_the_pairs_of_jax_list(case, face_block):
    """Expanded to pixels, the items name exactly the (pixel, block) pairs
    of JAX's list at the port's tile; each listed (patch, block) holds every
    chunk of the block once (fewer in a partial last block), and the
    scratch the kernel is given holds a counter per chunk, an accumulator
    per pixel and a room of one slot per patch for each chunk."""
    bbox, hw = _bboxes()[case]
    nb = bbox.shape[0]
    n_faces = (nb - 1) * face_block + face_block // 2 - 1  # a partial block
    items = rk.worklist_items(_t(bbox), hw, n_faces, face_block).numpy()
    np.testing.assert_array_equal(
        _item_pixel_blocks(items, bbox, hw, rk.PIX_TILE),
        _jax_pixel_blocks(bbox, hw, rk.PIX_TILE))
    cs = min(rk.K3_CHUNK, face_block)
    assert len(np.unique(items, axis=0)) == len(items)
    for (p, j), n in zip(*np.unique(items[:, :2], axis=0, return_counts=True)):
        want = min(face_block // cs, -(-(n_faces - j * face_block) // cs))
        chunks = np.sort(items[(items[:, 0] == p) & (items[:, 1] == j), 2])
        np.testing.assert_array_equal(chunks, np.arange(want))
    n_chunks = nb * (face_block // cs)
    n_patches = -(-hw[0] // rk.K3_PATCH) * -(-hw[1] // rk.K3_PATCH)
    assert items[:, 0].max(initial=0) < n_patches
    assert rk._k3_scratch_bytes(hw, nb, face_block) >= (
        4 * n_chunks + 8 * hw[0] * hw[1] + 4 * n_chunks * n_patches)
    if case == "empty":
        assert len(items) == 0
    else:
        assert len(items) > 0


def test_items_order_is_drawn_from_the_generator():
    """A generator permutes the items and nothing else; the same seed gives
    the same order."""
    bbox, hw = _bboxes()["ragged"]
    base = rk.worklist_items(_t(bbox), hw, 768, 256).numpy()
    drawn = [rk.worklist_items(_t(bbox), hw, 768, 256,
                               generator=torch.Generator().manual_seed(s))
             .numpy() for s in (7, 7, 8)]
    np.testing.assert_array_equal(drawn[0], drawn[1])
    assert not np.array_equal(drawn[0], base)
    assert not np.array_equal(drawn[0], drawn[2])
    for d in drawn:
        np.testing.assert_array_equal(np.unique(d, axis=0),
                                      np.unique(base, axis=0))


@pytest.mark.parametrize("face_block", [256, 512, 1024])
def test_plain_k3_in_any_order_bit_equal_to_pallas(projected, face_block):
    """The plain K3 under three seeded permutations of its items gives
    winners and iz bits equal to the interpreted work-list kernel on JAX's
    coefficients and block bboxes."""
    coef, _ = pr.build_face_coefficients(*projected)
    bbox = pr.build_block_bboxes(projected[0], projected[1], projected[3],
                                 face_block)
    iz_j, win_j = pr.pallas_pass1_worklist(coef, bbox, HW,
                                           face_block=face_block,
                                           interpret=True)
    iz_j, win_j = np.asarray(iz_j), np.asarray(win_j)
    assert (iz_j > 0).sum() > 1000
    for gen in _orders()[1:]:
        iz, win = rk.pass1_worklist_ref(_t(coef), _t(bbox), HW, face_block,
                                        generator=gen)
        np.testing.assert_array_equal(win.numpy(), win_j)
        np.testing.assert_array_equal(iz.numpy().view(np.int32),
                                      iz_j.view(np.int32))


def test_plain_k3_in_any_order_ragged_against_pallas():
    """Ragged random triangles under three permutations: winners equal to
    the interpreted kernel everywhere, iz within one packed-key step on
    under 0.1% of pixels and equal elsewhere (ROADMAP F9), and every order
    the same bits."""
    coef, bbox = _ragged()
    hw, fb = (37, 53), 256
    iz_j, win_j = pr.pallas_pass1_worklist(jnp.asarray(coef),
                                           jnp.asarray(bbox), hw,
                                           face_block=fb, interpret=True)
    iz_j = np.asarray(iz_j)
    assert (iz_j > 0).sum() > 1000
    outs = [rk.pass1_worklist_ref(_t(coef), _t(bbox), hw, fb, generator=g)
            for g in _orders()]
    for iz, win in outs:
        np.testing.assert_array_equal(win.numpy(), np.asarray(win_j))
        steps = np.abs(iz.numpy().view(np.int32).astype(np.int64)
                       - iz_j.view(np.int32)) // fb
        assert (steps != 0).mean() < 1e-3 and steps.max() <= 1
        assert torch.equal(iz.view(torch.int32), outs[0][0].view(torch.int32))


def _tied_blocks(copies=3, fb=256, hw=(40, 56), seed=11):
    """Blocks 0 .. copies - 1 hold the same faces at the same lanes (block
    0's 200 random triangles, then poisoned lanes): every covered pixel's
    key ties across all blocks. Returns numpy coef and block bboxes."""
    rng = np.random.RandomState(seed)
    fx, fy, fiz, fvalid = _triangles(rng, 200, hw, 20.0)
    pad = fb - 200
    fx, fy, fiz = (np.concatenate([a, np.zeros((pad, 3), np.float32)])
                   for a in (fx, fy, fiz))
    fvalid = np.concatenate([fvalid, np.zeros(pad, bool)])
    fx, fy, fiz = (np.tile(a, (copies, 1)) for a in (fx, fy, fiz))
    fvalid = np.tile(fvalid, copies)
    coef, _ = pr.build_face_coefficients(fx, fy, fiz, fvalid)
    return np.asarray(coef), np.asarray(
        pr.build_block_bboxes(fx, fy, fvalid, fb))


def test_ties_across_blocks_go_to_block_0_in_any_order():
    """Equal keys in every block: block 0's face wins at every covered
    pixel, in every order of the items, as in the interpreted kernel and
    the port's K1."""
    coef, bbox = _tied_blocks()
    hw, fb = (40, 56), 256
    iz_j, win_j = pr.pallas_pass1_worklist(jnp.asarray(coef),
                                           jnp.asarray(bbox), hw,
                                           face_block=fb, interpret=True)
    iz1, win1 = rk.pass1_winners_ref(_t(coef), _t(bbox), hw, fb)
    covered = iz1 > 0
    assert covered.sum() > 500
    assert (win1[covered] < fb).all()
    np.testing.assert_array_equal(win1.numpy(), np.asarray(win_j))
    for gen in _orders():
        iz, win = rk.pass1_worklist_ref(_t(coef), _t(bbox), hw, fb,
                                        generator=gen)
        assert torch.equal(win, win1)
        assert torch.equal(iz.view(torch.int32), iz1.view(torch.int32))


@pytest.mark.parametrize("F", [768, 700])
def test_face_block_below_the_chunk_equals_plain_k1(F):
    """Face block 128, below the 256-face chunk (one chunk per block), with
    a whole and a partial last block: the plain K3 in any order gives plain
    K1's bits."""
    fb, hw = 128, (37, 53)
    coef, bbox = _ragged(F=F, fb=fb)
    iz1, win1 = rk.pass1_winners_ref(_t(coef), _t(bbox), hw, fb)
    assert (iz1 > 0).sum() > 500
    for gen in _orders():
        iz, win = rk.pass1_worklist_ref(_t(coef), _t(bbox), hw, fb,
                                        generator=gen)
        assert torch.equal(win, win1)
        assert torch.equal(iz.view(torch.int32), iz1.view(torch.int32))
