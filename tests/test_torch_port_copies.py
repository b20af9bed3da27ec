"""The port's own copies of the JAX package's numpy-only helpers equal the
originals: the mesh module (procedural shapes, decimation, OBJ files and
the geometry utilities), the Flax -> state_dict conversion and the config
helpers. The port imports none of these from the JAX package."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.models import torch_import as jti
from iros20_6d_pose_tracking_tpu.render import mesh as JM
from iros20_6d_pose_tracking_tpu.utils import config as jcfg
from iros20_6d_pose_tracking_tpu_torch.models import convert, tracknet
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.utils import config as cfg


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
    "state_dict_from_jax", "load_yaml", "find_dataset_info", "load_mean_std",
    "normalizers_from_info"])
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
