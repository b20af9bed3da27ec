"""The port's pair factory (``datagen/pair_producer.py``, ``apps/datagen.py``,
``datagen/blender_gen.py``) against the JAX package's, at 160x120 frames.

The JAX renders run the Pallas kernels in interpret mode, op by op
(``jax.disable_jit``, ``pair_producer.rz.render`` patched to
``impl="pallas_interpret"`` in the test only): JAX's default XLA pass 1
breaks ties by the zmin argmin, which the port does not port. Both sides get
the same draws: JAX's own, rebuilt from its keys and passed to the port
(ROADMAP F7). The port runs on the CPU, so its kernel wrappers take their
plain versions (K3 for the full-frame layers, K1 for the pairs' A renders).
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from iros20_6d_pose_tracking_tpu.core import se3 as jse3
from iros20_6d_pose_tracking_tpu.datagen import pair_producer as jpp
from iros20_6d_pose_tracking_tpu.render import mesh as JM
from iros20_6d_pose_tracking_tpu.render import rasterizer as JRz
from iros20_6d_pose_tracking_tpu_torch.core import se3
from iros20_6d_pose_tracking_tpu_torch.data.dataset import PairDataset
from iros20_6d_pose_tracking_tpu_torch.datagen import pair_producer as pp
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
from iros20_6d_pose_tracking_tpu_torch.utils import profiling

from bpy_stub import make_fake_bpy

torch.set_num_threads(2)

W, H = 160, 120
K = np.array([[150.0, 0, 80.0], [0, 150.0, 60.0], [0, 0, 1.0]], np.float32)
RES = 48
# The frame bars of tests/test_torch_synthetic_eval.py::_assert_frames_close:
# depth within 0.01 mm, rgb within 2.0 (of 255) on all but 0.1% of pixels.
DEPTH_BAR = 0.01


def _assert_frames_close(rgb, dep, rgb_j, dep_j):
    assert rgb.shape == rgb_j.shape and dep.shape == dep_j.shape
    np.testing.assert_array_equal(dep > 0, dep_j > 0)
    np.testing.assert_allclose(dep, dep_j, atol=DEPTH_BAR, rtol=0)
    assert (np.abs(rgb - rgb_j).max(-1) > 2.0).mean() < 1e-3


@pytest.fixture
def jax_pallas(monkeypatch):
    """JAX's pair factory rendering through its Pallas kernels in interpret
    mode (a patch of the test, not of the package)."""
    monkeypatch.setattr(jpp.rz, "render", functools.partial(
        JRz.render, impl="pallas_interpret"))


@pytest.fixture(scope="module")
def sphere():
    tm = M.make_icosphere(subdiv=2, radius=0.05)
    return tm, rz.upload(tm, "cpu"), JRz.upload(
        JM.make_icosphere(subdiv=2, radius=0.05))


def _jax_photometry(key, noise=True):
    """JAX render_dr_scene's draws from ``key``, as the port's dict."""
    k1, k2, k3 = jax.random.split(key, 3)
    d = {"noise": jax.random.uniform(k1, (H // 8, W // 8, 3)) if noise
         else None,
         "gain": jax.random.uniform(k2, (3,), minval=0.75, maxval=1.25),
         "bright": jax.random.uniform(jax.random.fold_in(k2, 1), (),
                                      minval=0.4, maxval=1.4),
         "bg_depth": jax.random.uniform(k3, (), minval=1200.0,
                                        maxval=1999.0)}
    return {k: None if v is None else torch.from_numpy(np.array(v))
            for k, v in d.items()}


def _pose(x, y, z):
    p = np.eye(4, dtype=np.float32)
    p[:3, 3] = [x, y, z]
    return p


def test_render_dr_scene_matches_jax(sphere, jax_pallas, monkeypatch):
    """Target plus occluder, the procedural noise background: depth and rgb
    within the frame bars, seg equal except where the two layers' depths lie
    within the depth bar, and the occluder clips the target's seg."""
    tm, mesh, jmesh = sphere
    key = jax.random.PRNGKey(0)
    pose, occ = _pose(0, 0, 0.6), _pose(0.045, 0, 0.3)
    with jax.disable_jit():
        rgb_j, dep_j, seg_j = jpp.render_dr_scene(
            jmesh, K, jnp.asarray(pose), key, width=W, height=H,
            extra_layers=[(jmesh, jnp.asarray(occ))])
    n3 = profiling.counters()["launches.pass1_worklist"]
    calls = []
    render = rz.render

    def counting(*a, **kw):
        calls.append(kw.get("worklist"))
        return render(*a, **kw)

    monkeypatch.setattr(pp.rz, "render", counting)
    rgb, dep, seg = pp.render_dr_scene(mesh, K, pose, _jax_photometry(key),
                                       W, H, extra_layers=[(mesh, occ)])
    monkeypatch.setattr(pp.rz, "render", render)
    assert calls == [True, True]  # one full-frame K3 render a layer
    assert profiling.counters()["launches.pass1_worklist"] == n3  # CPU
    rgb, dep, seg = rgb.numpy(), dep.numpy(), seg.numpy()
    rgb_j, dep_j, seg_j = map(np.asarray, (rgb_j, dep_j, seg_j))
    assert seg.dtype == np.uint8 and rgb.shape == (H, W, 3)
    _assert_frames_close(rgb, dep, rgb_j, dep_j)
    layers = [rz.render(mesh, torch.from_numpy(p), torch.from_numpy(K),
                        rz.full_frame_window(W, H), out_hw=(H, W))[1].numpy()
              for p in (pose, occ)]
    tie = (layers[0] > 0) & (layers[1] > 0) & (
        np.abs(layers[0] - layers[1]) <= DEPTH_BAR)
    np.testing.assert_array_equal(seg[~tie], seg_j[~tie])
    clear = layers[0] > 0
    assert 0 < seg.sum() < clear.sum()
    assert ((dep >= 1200) == ~(clear | (layers[1] > 0))).all()


def _captured(module, monkeypatch):
    """Capture (pose, draws or key, background, layers) of each
    render_dr_scene call of ``module`` instead of rendering."""
    seen = []

    def capture(mesh, K_, pose, draws, width, height, background=None,
                extra_layers=()):
        seen.append((np.asarray(pose), np.asarray(background),
                     [(m, np.asarray(p)) for m, p in extra_layers]))
        return None

    monkeypatch.setattr(module, "render_dr_scene", capture)
    return seen


def _which(prims, m):
    return next(i for i, q in enumerate(prims) if q is m)


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "procedural"])
def test_dr_scene_generator_matches_jax(sphere, tmp_path, monkeypatch, pool):
    """Seed 3, 6 scenes: the same primitives, layouts and layer poses
    (within 1e-6) and the same backgrounds (a pool texture verbatim; the
    procedural one within 1e-3 of 255) as JAX's DRSceneGenerator."""
    tm, mesh, jmesh = sphere
    tex_dir = None
    if pool:
        tex_dir = tmp_path / "textures"
        tex_dir.mkdir()
        Image.fromarray(np.full((H, W, 3), [7, 200, 90], np.uint8)).save(
            tex_dir / "flat.png")
        Image.fromarray(np.full((H, W, 3), [1, 2, 3], np.uint8)).save(
            tex_dir / "flat2.png")
    kw = dict(width=W, height=H, max_distractors=2, occluder_prob=0.5,
              texture_dir=None if tex_dir is None else str(tex_dir))
    gen = pp.DRSceneGenerator(mesh, K, pp.DRSceneConfig(**kw), seed=3)
    jgen = jpp.DRSceneGenerator(jmesh, K, jpp.DRSceneConfig(**kw), seed=3)
    for prim, jprim in zip(gen._prims, jgen._prims):
        np.testing.assert_array_equal(prim.fverts.numpy(),
                                      np.asarray(jprim.fverts))
        np.testing.assert_array_equal(prim.fcolors.numpy(),
                                      np.asarray(jprim.fcolors))
    ours, theirs = _captured(pp, monkeypatch), _captured(jpp, monkeypatch)
    for i in range(6):
        pose = _pose(0.01 * i, -0.005 * i, 0.6)
        gen.scene(pose, None)
        jgen.scene(jnp.asarray(pose), jax.random.PRNGKey(i))
    assert gen.layers == sum(1 + len(s[2]) for s in ours)
    assert sum(len(s[2]) for s in ours) >= 3  # clutter and occluders drawn
    for (p, bg, layers), (pj, bgj, layers_j) in zip(ours, theirs):
        np.testing.assert_array_equal(p, pj)
        if pool:
            np.testing.assert_array_equal(bg, bgj)
        else:
            np.testing.assert_allclose(bg, bgj, atol=1e-3, rtol=0)
        assert [_which(gen._prims, m) for m, _ in layers] == \
            [_which(jgen._prims, m) for m, _ in layers_j]
        for (_, q), (_, qj) in zip(layers, layers_j):
            np.testing.assert_allclose(q, qj, atol=1e-6, rtol=0)


def test_dr_scene_generator_renders(sphere, tmp_path):
    """A rendered scene of the port's generator: the target visible, the
    pool texture verbatim where nothing renders, the same scene again from
    the same seed and draws."""
    tm, mesh, _ = sphere
    tex_dir = tmp_path / "textures"
    tex_dir.mkdir()
    Image.fromarray(np.full((H, W, 3), [7, 200, 90], np.uint8)).save(
        tex_dir / "flat.png")
    cfg = pp.DRSceneConfig(width=W, height=H, max_distractors=2,
                           occluder_prob=0.5, texture_dir=str(tex_dir))
    draws = pp.draw_dr_photometry(torch.Generator().manual_seed(1), H, W,
                                  "cpu", noise=False)
    outs = [pp.DRSceneGenerator(mesh, K, cfg, seed=3).scene(
        _pose(0, 0, 0.6), draws) for _ in range(2)]
    rgb, depth, seg = (x.numpy() for x in outs[0])
    assert seg.sum() > 50
    bg = depth >= 1200.0
    assert bg.any()
    np.testing.assert_array_equal(rgb[bg][0].astype(np.uint8), [7, 200, 90])
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)


def _jax_perturbations(key, n, cfg):
    """The B-in-A poses JAX's PairProducer.generate draws from ``key``."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jse3.random_gaussian_magnitude(
            sub, cfg.max_translation, cfg.max_rotation_deg)))
    return np.stack(out)


def _capture_saves(producer, monkeypatch):
    saved = []

    def save(out_dir, rgbA, depthA, rgbB, depthB, segB, A, B):
        saved.append(dict(rgbA=np.asarray(rgbA), depthA=np.asarray(depthA),
                          rgbB=np.asarray(rgbB), depthB=np.asarray(depthB),
                          segB=np.asarray(segB), A=np.asarray(A),
                          B=np.asarray(B)))
        producer.count += 1

    monkeypatch.setattr(producer, "_save", save)
    return saved


def test_pair_producer_generate_matches_jax(sphere, tmp_path, monkeypatch,
                                            jax_pallas):
    """JAX's perturbations injected, the object at the image's left edge
    with a seg: the same off-image and visibility rejections, the B crops
    bit for bit, A within the frame bars, the poses within 1e-6."""
    tm, mesh, jmesh = sphere
    B = _pose(-0.26, 0.0, 0.5)  # the object's centre 2 px inside the edge
    rgb, depth = rz.render(mesh, torch.from_numpy(B), torch.from_numpy(K),
                           rz.full_frame_window(W, H), out_hw=(H, W))
    rgb, depth = rgb.numpy(), depth.numpy()
    seg = (depth > 0).astype(np.uint8) * 2
    n = 6
    kw = dict(resolution=RES, object_width_mm=110.0, max_translation=0.02,
              max_rotation_deg=15.0, min_visible_px=920, width=W, height=H)
    key = jax.random.PRNGKey(4)
    ours = pp.PairProducer(mesh, K, pp.ProducerConfig(**kw))
    theirs = jpp.PairProducer(jmesh, K, jpp.ProducerConfig(**kw))
    saved, saved_j = (_capture_saves(ours, monkeypatch),
                      _capture_saves(theirs, monkeypatch))
    perturb = _jax_perturbations(key, n, theirs.cfg)
    with jax.disable_jit():
        n_j = theirs.generate(str(tmp_path), B, rgb, depth, n, class_id=2,
                              current_seg=seg, key=key)
    got = ours.generate(str(tmp_path), B, rgb, depth, n, class_id=2,
                        current_seg=seg, perturb=torch.from_numpy(perturb))
    # both kinds of rejection happened
    t = (B @ np.linalg.inv(perturb))[:, :3, 3]
    off = (t[:, 0] * K[0, 0] / t[:, 2] + K[0, 2]) < 0
    assert 0 < off.sum() and got + off.sum() < n, (got, off)
    assert got == n_j == len(saved) == len(saved_j) and got > 0
    for s, sj in zip(saved, saved_j):
        for k in ("rgbB", "depthB", "segB"):
            np.testing.assert_array_equal(s[k], sj[k], err_msg=k)
        _assert_frames_close(s["rgbA"], s["depthA"], sj["rgbA"],
                             sj["depthA"])
        np.testing.assert_allclose(s["A"], sj["A"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(s["B"], sj["B"], atol=1e-6, rtol=0)


def test_produce_dataset_roundtrip(sphere, tmp_path):
    """produce_dataset -> the port's PairDataset reads the pairs -> labels
    within the normalizer bounds -> one train step's preprocessing (the JAX
    package's slow test, at 160x120 and RES 48)."""
    from iros20_6d_pose_tracking_tpu_torch.data import augment
    from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

    tm, mesh, _ = sphere
    cfg = pp.ProducerConfig(resolution=RES, object_width_mm=110.0,
                            max_translation=0.02, max_rotation_deg=15.0,
                            width=W, height=H)
    stats = {}
    train_dir, val_dir = pp.produce_dataset(
        mesh, K, str(tmp_path), cfg, train_samples=5, val_samples=2,
        xyz_range=((-0.05, 0.05), (-0.04, 0.04), (0.45, 0.6)), stats=stats)
    ds, ds_val = PairDataset(train_dir, RES), PairDataset(val_dir, RES)
    assert len(ds) == 5 and len(ds_val) == 2
    assert stats["pairs"] == 7 and stats["scenes"] >= 7
    assert stats["layers"] >= stats["scenes"]
    rec = ds[0]
    assert rec.rgbA.shape == (RES, RES, 3) and rec.depthB.dtype == np.float32
    assert rec.maskB.sum() > 0 and (rec.depthA > 100).sum() > 50
    t, r = se3.encode_delta(torch.from_numpy(rec.A_in_cam),
                            torch.from_numpy(rec.B_in_cam), 0.02,
                            15 * np.pi / 180)
    assert float(t.abs().max()) <= 1.0 + 1e-4
    assert float(r.abs().max()) <= 1.0 + 1e-3
    batch = next(ds.batches(4, shuffle=False))
    tcfg = tr.TrainConfig(resolution=RES, batch_size=4,
                          aug=augment.AugmentConfig(blur_prob=0.0))
    bufA, bufB, tl, rl = tr.preprocess_batch(
        torch.Generator().manual_seed(0), batch, torch.zeros(8),
        torch.full((8,), 100.0), tcfg, train=True)
    assert bufA.shape == (4, RES, RES, 4)
    assert torch.isfinite(bufA).all() and torch.isfinite(bufB).all()


def _write_blender_fixture(gen, mesh):
    """The JAX test's synthetic Blender stage-1 output (tests/test_datagen.py
    ::test_complete_blender_layout) at 160x120, rendered by the port: class
    id 7, three poses, the camera at (0.1, 0.2, 1.5) in the world."""
    gen.mkdir()
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    cam_in_world = np.eye(4)
    cam_in_world[:3, 3] = [0.1, 0.2, 1.5]
    for i in range(3):
        pose_cv = np.eye(4)
        pose_cv[:3, 3] = [0.01 * i, -0.01 * i, 0.5]
        rgb, depth = rz.render(mesh, torch.as_tensor(pose_cv,
                                                     dtype=torch.float32),
                               torch.from_numpy(K),
                               rz.full_frame_window(W, H), out_hw=(H, W))
        seg = (depth.numpy() > 0).astype(np.uint8) * 7
        Image.fromarray(rgb.numpy().astype(np.uint8)).save(
            gen / f"{i:07d}rgb.png")
        Image.fromarray(depth.numpy().astype(np.uint16)).save(
            gen / f"{i:07d}depth.png")
        Image.fromarray(seg).save(gen / f"{i:07d}seg.png")
        pose_world = cam_in_world @ np.linalg.inv(flip) @ pose_cv
        np.savez(gen / f"{i:07d}poses_in_world.npz",
                 class_ids=np.array([7]), poses_in_world=pose_world[None],
                 blendercam_in_world=cam_in_world)


def _info(**extra):
    return {"camera": {"focalX": 150.0, "focalY": 150.0, "centerX": 80.0,
                       "centerY": 60.0, "width": W, "height": H},
            "resolution": RES, "object_width": 110.0,
            "max_translation": 0.02, "max_rotation": 15, "val_samples": 1,
            **extra}


def test_complete_blender_layout(sphere, tmp_path):
    """Blender stage-1 layout -> pairs through complete_blender: the val
    split moved, the stored B pose the CV-frame pose."""
    tm, mesh, _ = sphere
    gen = tmp_path / "generated_data"
    _write_blender_fixture(gen, mesh)
    train_dir, val_dir = pp.complete_blender(
        str(gen), str(tmp_path / "pairs"), _info(), mesh=mesh, class_id=7)
    n_train = len(PairDataset(train_dir, resolution=RES))
    n_val = len(PairDataset(val_dir, resolution=RES))
    assert n_train + n_val >= 2 and n_val == 1
    metas = [f for f in os.listdir(train_dir) if f.endswith("meta.npz")]
    meta = np.load(os.path.join(train_dir, metas[0]))
    assert abs(meta["B_in_cam"][2, 3] - 0.5) < 1e-5


@pytest.fixture(scope="module")
def blender_generated(tmp_path_factory):
    """The port's datagen/blender_gen.py run under the fake bpy of
    tests/bpy_stub.py, as tests/test_blender_gen.py runs the JAX package's:
    4 images at 160x120 of class 0."""
    root = tmp_path_factory.mktemp("blender_dr")
    obj_path = str(root / "object.obj")
    M.save_obj(M.make_icosphere(subdiv=2, radius=0.05), obj_path)
    tex_dir = root / "textures"
    tex_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (8, 8, 3), np.uint8)).save(
            tex_dir / f"tex{i}.png")
    info = {
        "camera": {"focalX": 300.0, "focalY": 300.0, "centerX": 80.0,
                   "centerY": 60.0, "width": W, "height": H},
        "resolution": 64, "boundingbox": 10, "object_width": 110.0,
        "max_translation": 0.02, "max_rotation": 15,
        "train_samples": 3, "val_samples": 1,
        "models": {0: {"model_path": obj_path}},
        "blender": {"texture_folder": str(tex_dir), "max_lamp_num": 2,
                    "env_light_range": [0.3, 2.0],
                    "lamp_pos_range": [[-2, 2], [-2, 2], [-2, 0]],
                    "lamp_brightness": [0.2, 1.0],
                    "range_x": [-0.04, 0.04], "range_y": [-0.03, 0.03],
                    "range_z": [0.45, 0.75]},
    }
    info_path = root / "dataset_info.yml"
    with open(info_path, "w") as f:
        yaml.dump(info, f)
    out_dir = root / "generated_data"
    bpy, mathutils = make_fake_bpy()
    old_argv = sys.argv
    old_modules = {k: sys.modules.get(k) for k in ("bpy", "mathutils")}
    sys.modules["bpy"] = bpy
    sys.modules["mathutils"] = mathutils
    sys.argv = ["blender_gen.py", "--", "--dataset_info", str(info_path),
                "--out_dir", str(out_dir), "--count", "4", "--seed", "0"]
    try:
        from iros20_6d_pose_tracking_tpu_torch.datagen import blender_gen

        blender_gen.main()
    finally:
        sys.argv = old_argv
        for k, v in old_modules.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    return out_dir, info, info_path


def test_blender_gen_output_protocol(blender_generated):
    """%07d{rgb,depth,seg}.png + poses_in_world.npz (reference
    blender_dataset_generator.py:367-384): shapes and dtypes, seg the class
    id on a 255 background, depth at the object the npz pose's depth."""
    out_dir, _, _ = blender_generated
    for i in range(4):
        rgb = np.array(Image.open(out_dir / f"{i:07d}rgb.png"))
        depth = np.array(Image.open(out_dir / f"{i:07d}depth.png"))
        seg = np.array(Image.open(out_dir / f"{i:07d}seg.png"))
        assert rgb.shape == (H, W, 3)
        assert depth.shape == (H, W) and depth.dtype == np.uint16
        assert seg.shape == (H, W) and seg.dtype == np.uint8
        assert set(np.unique(seg).tolist()) == {0, 255}
        meta = np.load(out_dir / f"{i:07d}poses_in_world.npz")
        assert meta["class_ids"].tolist() == [0]
        assert meta["poses_in_world"].shape == (1, 4, 4)
        z_cv = -meta["poses_in_world"][0][2, 3] * 1000.0
        assert abs(np.median(depth[seg == 0]) - z_cv) < 60.0


def test_blender_gen_feeds_complete_blender(blender_generated, tmp_path):
    out_dir, info, _ = blender_generated
    train_dir, val_dir = pp.complete_blender(
        str(out_dir), str(tmp_path), info, class_id=0, seed=0, device="cpu")
    train = sorted(p for p in os.listdir(train_dir) if p.endswith("rgbA.png"))
    val = sorted(p for p in os.listdir(val_dir) if p.endswith("rgbA.png"))
    assert len(val) == 1 and len(train) >= 2
    meta = np.load(os.path.join(train_dir,
                                train[0].replace("rgbA.png", "meta.npz")))
    assert np.isfinite(meta["A_in_cam"]).all() and meta["B_in_cam"][2, 3] > 0.3


@pytest.mark.parametrize("mode", ["dr", "blender"])
def test_datagen_cli(sphere, tmp_path, blender_generated, mode, capsys):
    """apps/datagen.main --device cpu: dr mode writes the split it was
    asked for (and the object width it computed); blender mode converts the
    blender_gen output."""
    from iros20_6d_pose_tracking_tpu_torch.apps import datagen

    out_dir, info, info_path = blender_generated
    out = tmp_path / "out"
    if mode == "dr":
        obj = tmp_path / "object.obj"
        M.save_obj(sphere[0], str(obj))
        info = _info(train_samples=3, val_samples=1,
                     models=[{"model_path": str(obj)}],
                     blender={"range_x": [-0.04, 0.04],
                              "range_y": [-0.03, 0.03],
                              "range_z": [0.45, 0.6]})
        del info["object_width"]
        info_path = tmp_path / "dataset_info.yml"
        info_path.write_text(yaml.dump(info))
        datagen.main(["--mode", "dr", "--dataset_info", str(info_path),
                      "--out_root", str(out), "--device", "cpu"])
        said = capsys.readouterr().out
        assert "object_width =" in said and " layers, 4 pairs" in said
        assert (out / "dataset_info.yml").exists()
        n_train, n_val = 3, 1
    else:
        datagen.main(["--mode", "blender", "--dataset_info", str(info_path),
                      "--out_root", str(out), "--generated_dir",
                      str(out_dir), "--device", "cpu"])
        n_train, n_val = 3, 1
    assert len(PairDataset(str(out / "train_data_blender_DR"), RES)) >= \
        (n_train if mode == "dr" else 2)
    assert len(PairDataset(str(out / "validation_data_blender_DR"),
                           RES)) == n_val
