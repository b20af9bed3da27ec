"""K3, the work-list pass 1 of the PyTorch port, against the JAX package.

The work list, the plain K3 (``pass1_worklist_ref``) and the wrapper on the
CPU are held against ``pallas_raster.build_worklist`` and
``pallas_pass1_worklist`` in interpret mode, and against the port's own K1.
Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.render import mesh as M
from iros20_6d_pose_tracking_tpu.render import pallas_raster as pr
from iros20_6d_pose_tracking_tpu.render import rasterizer as Rz
from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as TRz
from iros20_6d_pose_tracking_tpu_torch.utils import profiling

torch.set_num_threads(2)

K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]], np.float32)
HW = (128, 128)
WIN = (150.0, 450.0, 100.0, 400.0)
POSE = np.array([[0.87, -0.29, 0.40, 0.03], [0.35, 0.93, -0.07, 0.02],
                 [-0.35, 0.21, 0.91, 0.55], [0, 0, 0, 1]], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def projected():
    """The subdiv-3 icosphere (1280 faces padded to 2048) projected into a
    128^2 window, as numpy (fx, fy, fiz, fvalid)."""
    mesh = Rz.upload(M.make_icosphere(subdiv=3, radius=0.04))
    fx, fy, fiz, fvalid, _, _ = Rz._project(mesh, jnp.asarray(POSE),
                                            jnp.asarray(K), WIN, HW, 0.1)
    return tuple(np.asarray(a) for a in (fx, fy, fiz, fvalid))


def _ragged(seed=5, F=768, hw=(37, 53), fb=256):
    """Large random triangles over (and past) a window whose pixel count is
    no multiple of any tile."""
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


@pytest.mark.parametrize("case", ["sparse", "ragged", "empty"])
@pytest.mark.parametrize("pix_tile", [512, rk.PIX_TILE])
def test_build_worklist_equals_jax(case, pix_tile):
    """The four arrays equal JAX's exactly, at the TPU kernel's 512-pixel
    tile and at the port's."""
    bbox, hw = _bboxes()[case]
    ref = pr.build_worklist(jnp.asarray(bbox), hw, pix_tile, hw[1])
    ours = rk.build_worklist(_t(bbox), hw, pix_tile)
    for name, o, r in zip(("tiles", "blocks", "init", "valid"), ours, ref):
        assert o.dtype == torch.int32, name
        np.testing.assert_array_equal(o.numpy(), np.asarray(r), err_msg=name)
    n_real = int(ours[3].sum())
    if case == "empty":
        assert n_real == 0
    elif case == "sparse":  # the object's rows only
        assert 0 < n_real < ours[3].numel() // 2
    else:
        assert n_real > 0


@pytest.mark.parametrize("face_block", [256, 512, 1024])
def test_plain_k3_bit_equal_to_pallas(projected, face_block):
    """The plain K3 fed JAX's coefficients and block bboxes gives winners
    and iz bit-equal to the interpreted work-list kernel, at its 512-pixel
    tile and at the port's tile."""
    coef, _ = pr.build_face_coefficients(*projected)
    bbox = pr.build_block_bboxes(projected[0], projected[1], projected[3],
                                 face_block)
    iz_j, win_j = pr.pallas_pass1_worklist(coef, bbox, HW,
                                           face_block=face_block,
                                           interpret=True)
    iz_j, win_j = np.asarray(iz_j), np.asarray(win_j)
    assert (iz_j > 0).sum() > 1000
    for pix_tile in (512, rk.PIX_TILE):
        iz, win = rk.pass1_worklist_ref(_t(coef), _t(bbox), HW, face_block,
                                        pix_tile=pix_tile)
        np.testing.assert_array_equal(win.numpy(), win_j)
        np.testing.assert_array_equal(iz.numpy().view(np.int32),
                                      iz_j.view(np.int32))


def test_plain_k3_ragged_against_pallas():
    """Ragged random triangles, P no multiple of the tile. Winners equal
    everywhere; iz within one packed-key step on under 0.1% of pixels and
    equal elsewhere (ROADMAP F9: XLA contracts the interpreted kernel's
    forms into FMAs, the port rounds after every op)."""
    coef, bbox = _ragged()
    hw, fb = (37, 53), 256
    iz_j, win_j = pr.pallas_pass1_worklist(jnp.asarray(coef),
                                           jnp.asarray(bbox), hw,
                                           face_block=fb, interpret=True)
    iz_j = np.asarray(iz_j)
    assert (iz_j > 0).sum() > 1000
    iz, win = rk.pass1_worklist_ref(_t(coef), _t(bbox), hw, fb)
    np.testing.assert_array_equal(win.numpy(), np.asarray(win_j))
    steps = np.abs(iz.numpy().view(np.int32).astype(np.int64)
                   - iz_j.view(np.int32)) // fb
    assert (steps != 0).mean() < 1e-3 and steps.max() <= 1


@pytest.mark.parametrize("case", ["icosphere", "ragged", "partial_block"])
def test_plain_k3_equals_plain_k1(projected, case):
    """K3's plain version equals K1's bit for bit, also with a face count
    that is no multiple of the face block (poisoned padding lanes)."""
    if case == "icosphere":
        fb, hw = 512, HW
        coef = rk.build_face_coefficients(*map(_t, projected))[0]
        bbox = rk.build_block_bboxes(_t(projected[0]), _t(projected[1]),
                                     _t(projected[3]), fb)
    elif case == "ragged":
        fb, hw = 256, (37, 53)
        coef, bbox = map(_t, _ragged())
    else:
        fb, hw = 256, (37, 53)
        coef = _t(_ragged()[0])[:, :700].contiguous()
        bbox = _t(_ragged(F=700)[1])
    iz1, win1 = rk.pass1_winners_ref(coef, bbox, hw, fb)
    iz3, win3 = rk.pass1_worklist_ref(coef, bbox, hw, fb)
    assert (iz1 > 0).sum() > 500
    assert torch.equal(win3, win1)
    assert torch.equal(iz3.view(torch.int32), iz1.view(torch.int32))


def test_empty_tiles_get_the_init_values():
    """Tiles the work list does not name keep iz -1 and winner 0: a frame no
    face reaches, and the rows of a sparse frame above and below the
    object."""
    coef, _ = _ragged()
    bbox, hw = _bboxes()["empty"]
    coef = _t(coef)[:, :768].contiguous()
    iz, win = rk.pass1_worklist_ref(coef, _t(bbox), hw, 256)
    assert torch.equal(iz, torch.full(hw, -1.0))
    assert torch.equal(win, torch.zeros(hw, dtype=torch.int32))
    fx, fy, fiz, fvalid = map(_t, (np.array([[10.0, 30.0, 10.0]]),
                                   np.array([[20.0, 20.0, 24.0]]),
                                   np.ones((1, 3)), np.array([True])))
    coef = rk.build_face_coefficients(fx.float(), fy.float(), fiz.float(),
                                      fvalid)[0]
    coef = rk._padded_coef(coef, 1, 256)
    bbox = rk.build_block_bboxes(fx.float(), fy.float(), fvalid, 256)
    iz, win = rk.pass1_worklist_ref(coef, bbox, (64, 40), 256)
    rows_hit = (iz > 0).any(dim=1).nonzero().squeeze(1)
    assert 0 < rows_hit.numel() <= 5 and 20 <= int(rows_hit.min())
    assert (iz[:16] == -1.0).all() and (iz[32:] == -1.0).all()
    assert not win.any()


def test_wrapper_on_cpu_runs_plain_version(projected):
    fx, fy, fiz, fvalid = map(_t, projected)
    coef, _ = rk.build_face_coefficients(fx, fy, fiz, fvalid)
    bbox = rk.build_block_bboxes(fx, fy, fvalid, 1024)
    n = profiling.counters()["launches.pass1_worklist"]
    iz, win = rk.pass1_worklist(coef, bbox, HW, 1024)
    iz_r, win_r = rk.pass1_worklist_ref(coef, bbox, HW, 1024)
    assert torch.equal(win, win_r) and torch.equal(iz, iz_r)
    assert profiling.counters()["launches.pass1_worklist"] == n


def test_wrapper_refuses_non_cpu_mixes():
    """A tensor off the CPU never takes the plain version: a device the
    kernel does not run on, or a mix of devices, raises."""
    coef = torch.zeros((12, 256))
    with pytest.raises(ValueError, match="CUDA"):
        rk.pass1_worklist(coef, torch.zeros((1, 4), device="meta"), (8, 8),
                          256)
    with pytest.raises(ValueError, match="CUDA"):
        rk.pass1_worklist(coef.to("meta"), torch.zeros((1, 4)), (8, 8), 256)
    with pytest.raises(ValueError, match="power of two"):
        rk.pass1_worklist(coef, torch.zeros((1, 4)), (8, 8), 200)


@pytest.mark.parametrize("cull", [False, True])
def test_render_through_k3_equals_k1(cull, monkeypatch):
    """``render(worklist=True)`` runs pass 1 through the K3 wrapper once,
    and its full-frame output equals the K1 render bit for bit."""
    tmh = TRz.upload(M.make_icosphere(subdiv=3, radius=0.04), "cpu")
    hw = (96, 160)
    win = TRz.full_frame_window(hw[1], hw[0])
    assert win == Rz.full_frame_window(hw[1], hw[0])
    k = K.copy()
    k[0, 2], k[1, 2] = 80.0, 48.0
    ref = TRz.render(tmh, _t(POSE), _t(k), win, out_hw=hw,
                     cull_backfaces=cull)
    calls = []
    for name in ("pass1_winners", "pass1_worklist"):
        fn = getattr(rk, name)
        monkeypatch.setattr(rk, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    out = TRz.render(tmh, _t(POSE), _t(k), win, out_hw=hw,
                     cull_backfaces=cull, worklist=True)
    assert calls == ["pass1_worklist"]
    assert (ref[1] > 0).sum() > 300
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
