"""Raster kernels and rasterizer of the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and go through both sides. The JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them on the CPU; the port's kernel wrappers run their plain versions,
because the tensors lie on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.core import se3 as jse3
from iros20_6d_pose_tracking_tpu.render import mesh as M
from iros20_6d_pose_tracking_tpu.render import pallas_raster as pr
from iros20_6d_pose_tracking_tpu.render import rasterizer as Rz
from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as TRz
from iros20_6d_pose_tracking_tpu_torch.utils import profiling

torch.set_num_threads(2)

K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]], np.float32)
WIN = (150.0, 450.0, 100.0, 400.0)
HW = (128, 128)


def _pose(t, w=(0.0, 0.0, 0.0)):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(jse3.so3_exp(jnp.asarray(w, jnp.float32)))
    T[:3, 3] = t
    return T


POSE = _pose([0.03, 0.02, 0.55], (0.4, -0.2, 0.3))

MESHES = {
    "icosphere": lambda: M.make_icosphere(subdiv=3, radius=0.04),
    "cube": lambda: M.make_cube(0.08),
}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def projected():
    """Eager JAX projection of the subdiv-3 icosphere (1280 faces padded to
    2048) into a 128^2 window, as numpy."""
    mesh = Rz.upload(MESHES["icosphere"]())
    fx, fy, fiz, fvalid, _, _ = Rz._project(mesh, jnp.asarray(POSE),
                                            jnp.asarray(K), WIN, HW, 0.1)
    return tuple(np.asarray(a) for a in (fx, fy, fiz, fvalid))


def test_project_matches_jax(projected):
    mesh = TRz.upload(MESHES["icosphere"](), "cpu")
    out = rk.project_faces(mesh, _t(POSE), _t(K), WIN, HW, 0.1)
    for ours, ref in zip(out[:4], projected):
        np.testing.assert_array_equal(ours.numpy(), ref)


def test_builders_bit_equal(projected):
    fx, fy, fiz, fvalid = projected
    coef_j, ok_j = pr.build_face_coefficients(*map(jnp.asarray, projected))
    coef, ok = rk.build_face_coefficients(*map(_t, projected))
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok.numpy(), ok_j)
    assert ok_j.sum() > 500
    np.testing.assert_array_equal(coef.numpy()[:, ok_j],
                                  np.asarray(coef_j)[:, ok_j])
    np.testing.assert_array_equal(
        rk.build_face_bboxes(_t(fx), _t(fy), _t(fvalid)).numpy(),
        np.asarray(pr.build_face_bboxes(fx, fy, fvalid)))
    for fb in (256, 512, 1024, 768):  # 768: a trailing partial block
        np.testing.assert_array_equal(
            rk.build_block_bboxes(_t(fx), _t(fy), _t(fvalid), fb).numpy(),
            np.asarray(pr.build_block_bboxes(fx, fy, fvalid, fb)))
    face_bbox = np.asarray(pr.build_face_bboxes(fx, fy, fvalid))
    np.testing.assert_array_equal(
        rk.reduce_block_bboxes(_t(face_bbox), 512).numpy(),
        np.asarray(pr.reduce_block_bboxes(face_bbox, 512)))


@pytest.mark.parametrize("face_block", [256, 512, 1024])
def test_pass1_plain_bit_equal_to_pallas(projected, face_block):
    """The plain K1 fed JAX's own coefficients and block bboxes gives
    winners and iz bit-equal to the Pallas kernel, at its 512-pixel tile
    and at the CUDA kernel's 128-pixel tile."""
    fx, fy, fiz, fvalid = projected
    coef, _ = pr.build_face_coefficients(fx, fy, fiz, fvalid)
    bbox = pr.build_block_bboxes(fx, fy, fvalid, face_block)
    iz_j, win_j = pr.pallas_pass1(coef, bbox, HW, face_block=face_block,
                                  interpret=True)
    iz_j, win_j = np.asarray(iz_j), np.asarray(win_j)
    assert (iz_j > 0).sum() > 1000
    for pix_tile in (512, rk.PIX_TILE):
        iz, win = rk.pass1_winners_ref(_t(coef), _t(bbox), HW, face_block,
                                       pix_tile=pix_tile)
        np.testing.assert_array_equal(win.numpy(), win_j)
        np.testing.assert_array_equal(iz.numpy().view(np.int32),
                                      iz_j.view(np.int32))


def test_pass1_ragged_face_count():
    """F not a multiple of the face block, P not a multiple of the tile,
    large random triangles. Winners equal everywhere. iz is bit-equal on
    all but 0.1% of pixels and within one step of the packed key's
    truncation elsewhere: the interpreted Pallas kernel is compiled by XLA,
    which contracts ``px * a + py * b`` into an FMA, and on these inputs
    that moves one pixel's 1/z across a truncation step (1 of 1,961). The
    plain K1 and the CUDA kernel round after every op."""
    rng = np.random.RandomState(5)
    F, hw, fb = 700, (37, 53), 256
    fx = rng.uniform(-5, 58, (F, 3)).astype(np.float32)
    fy = rng.uniform(-5, 42, (F, 3)).astype(np.float32)
    fiz = rng.uniform(0.5, 3.0, (F, 3)).astype(np.float32)
    fvalid = rng.rand(F) > 0.1
    coef, _ = pr.build_face_coefficients(fx, fy, fiz, fvalid)
    bbox = pr.build_block_bboxes(fx, fy, fvalid, fb)
    iz_j, win_j = pr.pallas_pass1(coef, bbox, hw, face_block=fb,
                                  interpret=True)
    iz_j = np.asarray(iz_j)
    assert (iz_j > 0).sum() > 1000
    iz, win = rk.pass1_winners_ref(_t(coef), _t(bbox), hw, fb)
    np.testing.assert_array_equal(win.numpy(), np.asarray(win_j))
    steps = np.abs(iz.numpy().view(np.int32).astype(np.int64)
                   - iz_j.view(np.int32)) // fb
    assert (steps != 0).mean() < 1e-3 and steps.max() <= 1


def test_gather_rows_plain_equals_pallas():
    rng = np.random.RandomState(0)
    F, C, P = 1280, 36, 7013  # shapes of tests/test_rasterizer.py
    attr = (rng.randn(F, C) * 100).astype(np.float32)
    winner = rng.randint(0, F, (P,)).astype(np.int32)
    covered = rng.rand(P) > 0.3
    ref = np.asarray(pr.pallas_gather_rows(jnp.asarray(attr),
                                           jnp.asarray(winner),
                                           jnp.asarray(covered),
                                           interpret=True))
    rows = rk.gather_rows_ref(_t(attr), _t(winner), _t(covered)).numpy()
    np.testing.assert_array_equal(rows[covered], ref[covered])
    assert not rows[~covered].any()


def _launches():
    c = profiling.counters()
    return c["launches.pass1_winners"], c["launches.gather_rows"]


def test_wrappers_on_cpu_run_plain_version(projected):
    fx, fy, fiz, fvalid = map(_t, projected)
    coef, _ = rk.build_face_coefficients(fx, fy, fiz, fvalid)
    bbox = rk.build_block_bboxes(fx, fy, fvalid, 1024)
    n1, n2 = _launches()
    iz, win = rk.pass1_winners(coef, bbox, HW, 1024)
    iz_r, win_r = rk.pass1_winners_ref(coef, bbox, HW, 1024)
    assert torch.equal(win, win_r) and torch.equal(iz, iz_r)
    attr = torch.randn(coef.shape[1], 30)
    cov = iz.reshape(-1) > 0
    rows = rk.gather_rows(attr, win.reshape(-1), cov)
    assert torch.equal(rows, rk.gather_rows_ref(attr, win.reshape(-1), cov))
    assert _launches() == (n1, n2)


def test_wrappers_refuse_non_cpu_mixes():
    """A tensor off the CPU never takes the plain version: a device the
    kernels do not run on, or a mix of devices, raises."""
    coef = torch.zeros((12, 256))
    bbox_meta = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rk.pass1_winners(coef, bbox_meta, (8, 8), 256)
    with pytest.raises(ValueError, match="CUDA"):
        rk.gather_rows(torch.zeros((4, 30), device="meta"),
                       torch.zeros(5, dtype=torch.int32),
                       torch.zeros(5, dtype=torch.bool))
    with pytest.raises(ValueError, match="power of two"):
        rk.pass1_winners(coef, torch.zeros((1, 4)), (8, 8), 200)


def test_backface_mask_and_compact_front_match_jax():
    tm = MESHES["icosphere"]()
    jm, tmh = Rz.upload(tm), TRz.upload(tm, "cpu")
    R, t = POSE[:3, :3], POSE[:3, 3]
    mask_j = np.asarray(Rz._backface_mask(jm, jnp.asarray(R),
                                          jnp.asarray(t)))
    mask = rk.backface_mask(tmh, _t(R), _t(t)).numpy()
    assert (mask != mask_j).sum() <= 2  # sign of near-zero dot products
    rng = np.random.RandomState(1)
    keep = rng.rand(300) > 0.4
    a, b = rng.randn(300, 12).astype(np.float32), rng.randn(300, 4)
    ref = Rz._compact_front(jnp.asarray(keep), jnp.asarray(a),
                            jnp.asarray(b.astype(np.float32)))
    ours = rk._compact_front(_t(keep), _t(a), _t(b))
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        assert o.is_contiguous()


def _render_pair(name, cull, jit):
    tm = MESHES[name]()
    jm, tmh = Rz.upload(tm), TRz.upload(tm, "cpu")

    def jax_render():
        return Rz.render(jm, jnp.asarray(POSE), jnp.asarray(K), WIN,
                         out_hw=HW, impl="pallas_interpret",
                         cull_backfaces=cull, fuse_pass2=True)

    if jit:
        rgb_j, d_j = jax_render()
    else:
        with jax.disable_jit():
            rgb_j, d_j = jax_render()
    rgb, d = TRz.render(tmh, _t(POSE), _t(K), WIN, out_hw=HW,
                        cull_backfaces=cull)
    return np.asarray(rgb_j), np.asarray(d_j), rgb.numpy(), d.numpy()


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("cull", [False, True])
def test_render_matches_jax_op_by_op(name, cull):
    """Against the JAX render run op by op (``jax.disable_jit``), whose
    float32 ops round like the port's. Depth within 0.01 mm everywhere and
    rgb within 2.0 (of 255) on all but 0.1% of pixels: the margin covers
    ulp-level differences in the attribute sums."""
    rgb_j, d_j, rgb, d = _render_pair(name, cull, jit=False)
    assert (d_j > 0).sum() > 500
    np.testing.assert_array_equal(d > 0, d_j > 0)
    np.testing.assert_allclose(d, d_j, atol=0.01, rtol=0)
    assert (np.abs(rgb - rgb_j).max(-1) > 2.0).mean() < 1e-3


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("cull", [False, True])
def test_render_matches_jax_jit(name, cull):
    """Against the jitted JAX render. XLA contracts products such as
    x1*y2 - x2*y1 into FMAs inside jit, so the edge and attribute forms of
    small faces, whose terms cancel, differ from op-by-op rounding. Measured
    on these inputs: one silhouette pixel of 16,384 changes coverage, and
    depth differs by up to 1.8e-3 relative. Bars: coverage equal on 99.9%
    of pixels, depth within 2e-3 relative where both cover, rgb within 2.0
    on all but 0.1% of pixels."""
    rgb_j, d_j, rgb, d = _render_pair(name, cull, jit=True)
    assert ((d > 0) != (d_j > 0)).mean() < 1e-3
    both = (d > 0) & (d_j > 0)
    np.testing.assert_allclose(d[both], d_j[both], rtol=2e-3)
    assert (np.abs(rgb - rgb_j).max(-1) > 2.0).mean() < 1e-3


@pytest.mark.parametrize("jit", [False, True])
def test_winners_match_jax(jit):
    """Pass-1 winners of the port's own projection against the JAX Pallas
    path: equal on every pixel against JAX run op by op, and on at least
    99.9% of pixels against jitted JAX (XLA's FMA contraction in the
    projection moves shared-edge ties; measured 0.06% of pixels here)."""
    tm = MESHES["icosphere"]()
    jm, tmh = Rz.upload(tm), TRz.upload(tm, "cpu")

    def jax_winners(pose, K):
        fx, fy, fiz, fvalid, _, _ = Rz._project(jm, pose, K, WIN, HW, 0.1)
        return Rz.pass1(fx, fy, fiz, fvalid, HW, impl="pallas_interpret")

    if jit:
        _, iz_j, win_j = jax.jit(jax_winners)(jnp.asarray(POSE),
                                              jnp.asarray(K))
    else:
        with jax.disable_jit():
            _, iz_j, win_j = jax_winners(jnp.asarray(POSE), jnp.asarray(K))
    fx, fy, fiz, fvalid, _, _ = rk.project_faces(tmh, _t(POSE), _t(K), WIN,
                                                 HW, 0.1)
    coef, _ = rk.build_face_coefficients(fx, fy, fiz, fvalid)
    fb = rk.pick_face_block(fx.shape[-2])
    iz, win = rk.pass1_winners(coef, rk.build_block_bboxes(fx, fy, fvalid, fb),
                               HW, fb)
    assert (np.asarray(iz_j) > 0).sum() > 1000
    differ = win.numpy() != np.asarray(win_j)
    if jit:
        assert differ.mean() < 1e-3
    else:
        assert not differ.any()
        np.testing.assert_array_equal(iz.numpy(), np.asarray(iz_j))


def test_sample_texture_matches_jax():
    rng = np.random.RandomState(2)
    tex = rng.rand(37, 53, 3).astype(np.float32)
    u = rng.uniform(-1.5, 2.5, 500).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, 500).astype(np.float32)
    ref = np.asarray(Rz._sample_texture(jnp.asarray(tex), jnp.asarray(u),
                                        jnp.asarray(v)))
    ours = rk._sample_texture(_t(tex), _t(u), _t(v)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_textured_box_render_matches_jax():
    tm = M.make_textured_box()
    jm, tmh = Rz.upload(tm), TRz.upload(tm, "cpu")
    assert tmh.texture is not None
    pose = _pose([0.01, -0.01, 0.5], (0.5, 0.3, -0.2))
    with jax.disable_jit():
        rgb_j, d_j = Rz.render(jm, jnp.asarray(pose), jnp.asarray(K), WIN,
                               out_hw=(96, 96), impl="pallas_interpret",
                               cull_backfaces=True, fuse_pass2=True)
    rgb, d = TRz.render(tmh, _t(pose), _t(K), WIN, out_hw=(96, 96),
                        cull_backfaces=True)
    rgb_j = np.asarray(rgb_j)
    assert (np.asarray(d_j) > 0).sum() > 500
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), atol=0.01)
    assert (np.abs(rgb.numpy() - rgb_j).max(-1) > 2.0).mean() < 1e-3


@pytest.mark.parametrize("cull", [False, True])
def test_render_gathers_rows_through_k2(cull, monkeypatch):
    """Every render runs pass 1 and pass 2 through the kernel wrappers once
    each: K1 and the fused gather-and-shade pass 2 (the standalone K2 row
    gather is off the render path)."""
    tmh = TRz.upload(MESHES["icosphere"](), "cpu")
    calls = []
    for name in ("pass1_winners", "pass2_shade", "gather_rows"):
        fn = getattr(rk, name)
        monkeypatch.setattr(rk, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    rgb, d = TRz.render(tmh, _t(POSE), _t(K), WIN, out_hw=HW,
                        cull_backfaces=cull)
    assert calls == ["pass1_winners", "pass2_shade"]
    assert (d > 0).sum() > 500 and torch.isfinite(rgb).all()
