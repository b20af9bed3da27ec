"""Pass 2 fused (``raster_kernels.pass2_shade`` and its plain version
``pass2_shade_ref``) against the unfused pass 2 it replaces and against the
JAX package's Pallas path.

Inputs come from the port's own projection and pass 1 of seeded poses
(numpy), untextured and textured, one view and a batch, with the default
lighting and an override. On the CPU the wrapper runs the plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.render import mesh as JM
from iros20_6d_pose_tracking_tpu.render import pallas_raster as pr
from iros20_6d_pose_tracking_tpu.render import rasterizer as Rz
from iros20_6d_pose_tracking_tpu_torch.core import se3
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as TRz

torch.set_num_threads(2)

K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]], np.float32)
WIN = (150.0, 450.0, 100.0, 400.0)
HW = (72, 72)
FAR = TRz.FAR_M
LIGHT = np.array([0.5, 0.7, 0.3, -0.4, -1.2], np.float32)
MESHES = {"icosphere": lambda m: m.make_icosphere(subdiv=3, radius=0.04),
          "textured_box": lambda m: m.make_textured_box()}


def _poses(n, seed):
    rng = np.random.RandomState(seed)
    w = torch.as_tensor(rng.randn(n, 3) * 0.6, dtype=torch.float32)
    t = torch.as_tensor(rng.uniform([-0.02, -0.02, 0.45], [0.02, 0.02, 0.6],
                                    (n, 3)), dtype=torch.float32)
    return se3.make_pose(se3.so3_exp(w), t)


def _pass2_inputs(name, views, cull=False, seed=0):
    """(mesh, attr, iz, winner, R, t) of ``views`` poses (one pose unbatched
    when views == 1) through the port's projection and pass 1 on the CPU."""
    mesh = TRz.upload(MESHES[name](M), "cpu")
    pose = _poses(views, seed)
    if views == 1:
        pose = pose[0]
    window = torch.tensor(WIN).expand(pose.shape[:-2] + (4,))
    fx, fy, fiz, fvalid, R, t = rk.project_faces(
        mesh, pose, torch.from_numpy(K), window, HW, TRz.NEAR_M)
    attr = rk.face_attr_forms(fx, fy, fiz, fvalid, mesh)
    if cull:
        coef, bbox, fb, attr = rk.culled_pass1_inputs(mesh, fx, fy, fiz,
                                                      fvalid, R, t, attr)
    else:
        coef, _ = rk.build_face_coefficients(fx, fy, fiz, fvalid)
        fb = rk.pick_face_block(fx.shape[-2])
        bbox = rk.build_block_bboxes(fx, fy, fvalid, fb)
    iz, winner = rk.pass1_winners(coef, bbox, HW, fb)
    return mesh, attr, iz, winner, R, t


def _unfused_pass2(mesh, attr, iz, winner, R, t, lighting):
    """The port's pass 2 before the fused kernel, as ``render`` ran it:
    zmin, the winner clamp, hit, coverage, the K2 row gather and
    ``shade_rows``."""
    zmin = rk.zmin_from_iz(iz)
    winner = torch.clamp(winner, 0, attr.shape[-2] - 1)
    hit = torch.isfinite(zmin) & (zmin < FAR)
    flat = zmin.shape[:-2] + (-1,)
    covered = torch.isfinite(zmin.reshape(flat))
    row = rk.gather_rows(attr, winner.reshape(flat), covered)
    return rk.shade_rows(R, t, row, hit.reshape(flat), HW,
                         texture=mesh.texture, lighting=lighting)


CASES = [("icosphere", 1, False, None), ("icosphere", 1, True, None),
         ("icosphere", 1, True, LIGHT), ("icosphere", 4, False, None),
         ("textured_box", 1, True, None), ("textured_box", 3, False, LIGHT)]


@pytest.mark.parametrize("name,views,cull,lighting", CASES)
def test_plain_version_equals_unfused_pass2(name, views, cull, lighting):
    """``pass2_shade_ref``, and the wrapper on the CPU, give the unfused
    pass 2's rgb and depth bit for bit."""
    mesh, attr, iz, winner, R, t = _pass2_inputs(name, views, cull)
    light = None if lighting is None else torch.from_numpy(lighting)
    want = _unfused_pass2(mesh, attr, iz, winner, R, t, light)
    assert (want[1] > 0).sum() > 300 * views
    for fn in (rk.pass2_shade_ref, rk.pass2_shade):
        rgb, depth = fn(attr, iz, winner, R, t, HW, FAR,
                        texture=mesh.texture, lighting=light)
        assert rgb.shape == want[0].shape and depth.shape == want[1].shape
        assert torch.equal(rgb, want[0]) and torch.equal(depth, want[1])


@pytest.mark.parametrize("views", [1, 3])
@pytest.mark.parametrize("lit", [False, True])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_matches_jax_gather_and_shade(name, lit, views):
    """Against JAX's ``pallas_gather_rows`` (interpret mode) and
    ``shade_rows(depth_from_form=True)`` run op by op on the same pass-1
    outputs and attribute forms, view by view: depth within 0.01 mm and
    rgb within 2.0 (of 255) on all but 0.1% of pixels, the bars of the
    render comparisons in tests/test_torch_raster.py."""
    mesh, attr, iz, winner, R, t = _pass2_inputs(name, views, seed=2)
    light = LIGHT if lit else None
    rgb, depth = rk.pass2_shade(
        attr, iz, winner, R, t, HW, FAR, texture=mesh.texture,
        lighting=None if light is None else torch.from_numpy(light))
    texture = None if mesh.texture is None else jnp.asarray(
        MESHES[name](JM).texture)
    if views == 1:  # one unbatched view: give everything a batch axis
        attr, iz, winner, R, t, rgb, depth = (
            a[None] for a in (attr, iz, winner, R, t, rgb, depth))
    for v in range(views):
        a, z, w, Rv, tv = (x[v].numpy() for x in (attr, iz, winner, R, t))
        z = z.reshape(-1)
        zmin = np.where(z > 1e-9, 1.0 / np.maximum(z, 1e-9),
                        np.inf).astype(np.float32)
        covered = np.isfinite(zmin)
        hit = covered & (zmin < FAR)
        w = np.clip(w.reshape(-1), 0, a.shape[0] - 1).astype(np.int32)
        rows = pr.pallas_gather_rows(jnp.asarray(a), jnp.asarray(w),
                                     jnp.asarray(covered), interpret=True)
        with jax.disable_jit():
            rgb_j, d_j = Rz.shade_rows(
                jnp.asarray(Rv), jnp.asarray(tv), rows, jnp.asarray(zmin),
                jnp.asarray(hit), HW, depth_from_form=True, texture=texture,
                lighting=None if light is None else jnp.asarray(light))
        got_rgb, got_d = rgb[v].numpy(), depth[v].numpy()
        d_j = np.asarray(d_j)
        assert (d_j > 0).sum() > 300
        np.testing.assert_array_equal(got_d > 0, d_j > 0)
        np.testing.assert_allclose(got_d, d_j, atol=0.01, rtol=0)
        assert (np.abs(got_rgb - np.asarray(rgb_j)).max(-1) > 2.0).mean() \
            < 1e-3


def test_render_launches_pass2_once_and_never_writes_rows(monkeypatch):
    """A render's pass 2 is one call of ``pass2_shade``; the row gather is
    never called."""
    mesh = TRz.upload(MESHES["textured_box"](M), "cpu")
    calls = []
    for name in ("pass2_shade", "gather_rows"):
        fn = getattr(rk, name)
        monkeypatch.setattr(rk, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    pose = _poses(1, 3)[0]
    rgb, depth = TRz.render(mesh, pose, torch.from_numpy(K), WIN, HW,
                            cull_backfaces=True, lighting=torch.from_numpy(
                                LIGHT))
    assert calls == ["pass2_shade"]
    assert (depth > 0).sum() > 300 and torch.isfinite(rgb).all()


def test_wrapper_refuses_mixed_and_non_cpu_devices():
    """Tensors all on the CPU take the plain version; any tensor elsewhere
    sends the call to the kernel, which takes tensors on one CUDA device
    only: a mix of devices, or a device the kernel does not run on,
    raises."""
    _, attr, iz, winner, R, t = _pass2_inputs("icosphere", 1)
    meta = {"attr": attr.to("meta"), "iz": iz.to("meta"),
            "winner": winner.to("meta"), "R": R.to("meta"),
            "t": t.to("meta")}
    for name in meta:
        args = {"attr": attr, "iz": iz, "winner": winner, "R": R, "t": t}
        args[name] = meta[name]
        with pytest.raises(ValueError, match="CUDA"):
            rk.pass2_shade(args["attr"], args["iz"], args["winner"],
                           args["R"], args["t"], HW, FAR)
    with pytest.raises(ValueError, match="CUDA"):
        rk.pass2_shade(attr, iz, winner, R, t, HW, FAR,
                       lighting=torch.zeros(5, device="meta"))
    with pytest.raises(ValueError, match=r"\(\[B,\] F"):
        rk.pass2_shade(meta["attr"][:, :29], meta["iz"], meta["winner"],
                       meta["R"], meta["t"], HW, FAR)
