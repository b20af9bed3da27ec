"""The port's own copies of the JAX package's numpy-only helpers equal the
originals: the mesh module (procedural shapes, decimation, OBJ files and
the geometry utilities), the Flax <-> state_dict conversions, the config
helpers, the visualization helpers, the YCB sequence discovery, the native
PNG decoder's C++ source, the live stream's numpy helpers (the packed
window, the host ROI geometry), the view-sphere sampling and the Blender
scene script. The port imports none of these from the JAX package."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.models import torch_import as jti
from iros20_6d_pose_tracking_tpu.ops import pointcloud as jpc
from iros20_6d_pose_tracking_tpu.render import mesh as JM
from iros20_6d_pose_tracking_tpu.utils import config as jcfg
from iros20_6d_pose_tracking_tpu.utils import viz as jviz
from iros20_6d_pose_tracking_tpu_torch.models import convert, tracknet
from iros20_6d_pose_tracking_tpu_torch.ops import pointcloud as pc
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.utils import config as cfg
from iros20_6d_pose_tracking_tpu_torch.utils import viz


def _assert_trimesh_equal(a, b):
    assert type(a).__name__ == type(b).__name__ == "TriMesh"
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if y is None:
            assert x is None, f.name
        elif isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def _icosphere_decimated(mod):
    full = mod.make_icosphere(subdiv=4, radius=0.05)
    tm = mod.build_trimesh(*mod.decimate(full.verts,
                                         full.faces[:full.num_faces],
                                         full.colors, 2048))
    real = tm.faces[:tm.num_faces]
    return tm, (mod.is_closed(tm.verts, real),
                mod.is_outward_oriented(tm.verts, real, tm.normals),
                mod.compute_cloud_diameter(tm.verts),
                mod.voxel_down_sample(tm.verts, 0.005),
                mod.morton_face_order(tm.verts, real))


def _random_variables(seed):
    """Flax-layout variables of the full Se3TrackNet, every leaf seeded
    numpy, made from a reference-layout state_dict of random values."""
    rng = np.random.RandomState(seed)
    sd = {k: rng.randn(*v.shape).astype(np.float32)
          for k, v in tracknet.Se3TrackNet().state_dict().items()
          if not k.endswith("num_batches_tracked")}
    return jti.state_dict_to_variables(sd)


def _write_config_tree(root):
    data = root / "train_data"
    data.mkdir()
    (root / "dataset_info.yml").write_text(
        "resolution: 48\nmax_translation: 0.02\nmax_rotation: 15\n")
    rng = np.random.RandomState(5)
    np.save(root / "mean.npy", rng.randn(8).astype(np.float32))
    np.save(root / "std.npy", rng.rand(8).astype(np.float32))
    return str(data)


@pytest.mark.parametrize("case", [
    "icosphere4_decimated_2048", "cube", "textured_box", "obj_round_trip",
    "state_dict_from_jax", "state_dict_to_variables", "load_yaml",
    "find_dataset_info", "load_mean_std", "normalizers_from_info",
    "viz_make_canvas", "viz_projected_points", "viz_video_writer",
    "find_class_contained_videos_ycb", "dataload_cc", "stream_numpy_helpers",
    "core_views", "blender_gen"])
def test_port_copy_equals_jax(case, tmp_path):
    if case == "icosphere4_decimated_2048":
        (tm, extra), (tm_j, extra_j) = (_icosphere_decimated(M),
                                        _icosphere_decimated(JM))
        _assert_trimesh_equal(tm, tm_j)
        assert tm.num_faces > 1500 and tm.faces.shape[0] % 1024 == 0
        for x, y in zip(extra, extra_j):
            np.testing.assert_array_equal(x, y)
        assert tm.diameter == tm_j.diameter
    elif case == "cube":
        _assert_trimesh_equal(M.make_cube(0.08), JM.make_cube(0.08))
    elif case == "textured_box":
        tm, tm_j = M.make_textured_box(), JM.make_textured_box()
        assert tm.texture is not None and tm.face_uvs is not None
        _assert_trimesh_equal(tm, tm_j)
    elif case == "obj_round_trip":
        for name in ("textured_box", "icosphere"):
            shapes = {"textured_box": lambda m: m.make_textured_box(),
                      "icosphere": lambda m: m.make_icosphere(subdiv=2)}
            ours, theirs = tmp_path / "port", tmp_path / "jax"
            ours.mkdir(exist_ok=True)
            theirs.mkdir(exist_ok=True)
            M.save_obj(shapes[name](M), str(ours / f"{name}.obj"))
            JM.save_obj(shapes[name](JM), str(theirs / f"{name}.obj"))
            assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
            for f in os.listdir(ours):
                assert (ours / f).read_bytes() == (theirs / f).read_bytes(), f
            _assert_trimesh_equal(M.load_mesh(str(ours / f"{name}.obj")),
                                  JM.load_mesh(str(ours / f"{name}.obj")))
    elif case == "state_dict_from_jax":
        variables = _random_variables(0)
        ref = jti.variables_to_state_dict(variables)
        ours = convert.variables_to_state_dict(variables)
        assert ours.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        sd = convert.state_dict_from_jax(variables)
        for k in ref:
            np.testing.assert_array_equal(sd[k].numpy(), ref[k], err_msg=k)
        net = tracknet.Se3TrackNet()
        net.load_state_dict(sd, strict=True)
        assert all(int(v) == 0 for k, v in sd.items()
                   if k.endswith("num_batches_tracked"))
        assert all(v.dtype == torch.float32 for k, v in sd.items()
                   if not k.endswith("num_batches_tracked"))
    elif case == "state_dict_to_variables":
        rng = np.random.RandomState(1)
        sd = {k: torch.as_tensor(rng.randn(*v.shape), dtype=torch.float32)
              for k, v in tracknet.Se3TrackNet().state_dict().items()
              if not k.endswith("num_batches_tracked")}
        ours, ref = (convert.state_dict_to_variables(sd),
                     jti.state_dict_to_variables(sd))
        flat = convert.variables_to_state_dict  # a key per leaf
        assert flat(ours).keys() == flat(ref).keys()
        for k, v in flat(ref).items():
            np.testing.assert_array_equal(flat(ours)[k], v, err_msg=k)
        for k, v in sd.items():
            np.testing.assert_array_equal(flat(ours)[k], v.numpy(), err_msg=k)
    elif case.startswith("viz"):
        _check_viz(case, tmp_path)
    elif case == "dataload_cc":
        from iros20_6d_pose_tracking_tpu.native import dataload as jdl
        from iros20_6d_pose_tracking_tpu_torch.native import dataload as dl

        with open(dl.SOURCE, "rb") as f, \
                open(os.path.join(os.path.dirname(jdl.__file__),
                                  "dataload.cc"), "rb") as g:
            assert f.read() == g.read()
    elif case == "stream_numpy_helpers":
        _check_stream_helpers()
    elif case == "core_views":
        _check_views()
    elif case == "blender_gen":
        # run by path inside Blender (tests/test_torch_datagen.py drives it
        # under tests/bpy_stub.py): the port keeps the JAX package's script
        from iros20_6d_pose_tracking_tpu.datagen import blender_gen as jbg
        from iros20_6d_pose_tracking_tpu_torch.datagen import blender_gen as bg

        with open(bg.__file__, "rb") as f, open(jbg.__file__, "rb") as g:
            assert f.read() == g.read()
    elif case == "find_class_contained_videos_ycb":
        for seq, classes in ((47, [4]), (48, [4, 7]), (50, [7]), (59, [4]),
                             (60, [4])):
            for c in classes:
                (tmp_path / f"{seq:04d}" / "pose_gt" / str(c)).mkdir(
                    parents=True)
        (tmp_path / "0051").mkdir()
        (tmp_path / "notes").mkdir()
        for c, testset in ((4, True), (7, True), (4, False), (9, True)):
            assert pc.find_class_contained_videos_ycb(
                str(tmp_path), c, testset) == \
                jpc.find_class_contained_videos_ycb(str(tmp_path), c, testset)
    else:
        data = _write_config_tree(tmp_path)
        if case == "load_yaml":
            path = str(tmp_path / "dataset_info.yml")
            assert cfg.load_yaml(path) == jcfg.load_yaml(path)
        elif case == "find_dataset_info":
            assert cfg.find_dataset_info(data) == jcfg.find_dataset_info(data)
            beside = str(tmp_path)  # the file beside the folder itself
            assert cfg.find_dataset_info(beside) == \
                jcfg.find_dataset_info(beside)
            for mod in (cfg, jcfg):
                with pytest.raises(FileNotFoundError):
                    mod.find_dataset_info(str(tmp_path / "nowhere" / "x"))
        elif case == "load_mean_std":
            for x, y in zip(cfg.load_mean_std(str(tmp_path)),
                            jcfg.load_mean_std(str(tmp_path))):
                np.testing.assert_array_equal(x, y)
        else:
            info = jcfg.load_yaml(str(tmp_path / "dataset_info.yml"))
            assert cfg.normalizers_from_info(info) == \
                jcfg.normalizers_from_info(info)


def _check_viz(case, tmp_path):
    rng = np.random.RandomState(6)
    if case == "viz_make_canvas":
        imgs = [rng.rand(20, 30, 3) * 255, rng.randint(0, 255, (20, 30)),
                rng.rand(20, 30, 4) * 255]
        for kw in ({}, {"flip_br": False}, {"gap": 3}):
            np.testing.assert_array_equal(viz.make_canvas(imgs, **kw),
                                          jviz.make_canvas(imgs, **kw))
    elif case == "viz_projected_points":
        rgb = rng.randint(0, 255, (60, 80, 3)).astype(np.uint8)
        pose = np.eye(4)
        pose[:3, 3] = [0.01, -0.02, 0.5]
        K = np.array([[100.0, 0, 40], [0, 100.0, 30], [0, 0, 1]])
        pts = rng.randn(300, 3) * 0.1
        np.testing.assert_array_equal(
            viz.draw_projected_points(rgb, pose, K, pts),
            jviz.draw_projected_points(rgb, pose, K, pts))
    else:
        frames = [rng.randint(0, 255, (48, 64, 3)).astype(np.uint8)
                  for _ in range(3)]
        for mod, name in ((viz, "port.mp4"), (jviz, "jax.mp4")):
            w = mod.VideoWriter(str(tmp_path / name), fps=10.0)
            for f in frames:
                w.write(f)
            w.close()
            w.close()  # a second close is a no-op
        assert (tmp_path / "port.mp4").read_bytes() == \
            (tmp_path / "jax.mp4").read_bytes()


def _check_stream_helpers():
    """pack_window's bytes and a run of the host geometry (bbox, bucket
    with its hysteresis, predicted centre, containment) equal JAX's."""
    import types

    from iros20_6d_pose_tracking_tpu.tracking import stream as jst
    from iros20_6d_pose_tracking_tpu_torch.tracking import stream as st

    rng = np.random.RandomState(7)
    rgb = rng.randint(0, 256, (40, 40, 3)).astype(np.uint8)
    depth = rng.randint(0, 65536, (40, 40)).astype(np.uint16)
    assert st.pack_window(rgb, depth).tobytes() == \
        jst.pack_window(rgb, depth).tobytes()
    K = np.array([[600.0, 0, 320.0], [0, 610.0, 240.0], [0, 0, 1]],
                 np.float32)
    cfg = types.SimpleNamespace(object_width_mm=150.0)
    port = st.StreamTracker(types.SimpleNamespace(
        K=torch.as_tensor(K), cfg=cfg, device=torch.device("cpu")))
    ref = jst.StreamTracker(types.SimpleNamespace(K=K, cfg=cfg))
    for i in range(60):
        pose = np.eye(4)
        pose[:3, 3] = [0.002 * i, -0.001 * i, 0.6 + 0.003 * i]
        got, want = port._host_bbox(pose), ref._host_bbox(pose)
        assert got == want
        for s in (port, ref):
            s._hw = (480, 640)
            s._frame_idx = i
            if i % 8 == 0:
                s._center_hist.append((i, np.asarray(want[0])))
        assert port._bucket(want[1]) == ref._bucket(want[1])
        assert port._predicted_center() == ref._predicted_center()
        rect = (100 + i, 120, 256)
        assert port._roi_escaped(want[0], want[1], rect) == \
            ref._roi_escaped(want[0], want[1], rect)


def _check_views():
    """core/views.py: the same source, and the same hinter sampling, look-at
    rotations, sampled views and random view matrices."""
    from iros20_6d_pose_tracking_tpu.core import views as jv
    from iros20_6d_pose_tracking_tpu_torch.core import views as v

    with open(v.__file__, "rb") as f, open(jv.__file__, "rb") as g:
        assert f.read() == g.read()
    for n in (12, 42, 300):
        for x, y in zip(v.hinter_sampling(n, 0.7), jv.hinter_sampling(n, 0.7)):
            np.testing.assert_array_equal(x, y)
    eye = np.array([0.3, -0.2, 0.9])
    np.testing.assert_array_equal(v.look_at_rotation(eye),
                                  jv.look_at_rotation(eye))
    np.testing.assert_array_equal(v.look_at_rotation([0, 0, 2.0]),
                                  jv.look_at_rotation([0, 0, 2.0]))
    views, pts = v.sample_views(100, 0.5, (0.0, 1.2))
    jviews, jpts = jv.sample_views(100, 0.5, (0.0, 1.2))
    np.testing.assert_array_equal(pts, jpts)
    assert len(views) == len(jviews) > 10
    for a, b in zip(views, jviews):
        np.testing.assert_array_equal(a["R"], b["R"])
        np.testing.assert_array_equal(a["t"], b["t"])
    np.testing.assert_array_equal(
        v.random_view_matrix(np.random.RandomState(3), 0.4, 0.9),
        jv.random_view_matrix(np.random.RandomState(3), 0.4, 0.9))
