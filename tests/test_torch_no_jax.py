"""The PyTorch port and ``chip_smoke.py`` never import jax, nor any module
of the JAX package (``iros20_6d_pose_tracking_tpu``), not even a numpy-only
one.

The test process itself has jax loaded (tests/conftest.py imports it), so
the check runs in a fresh interpreter: import every module of the port, run
one tracking step, one multi-hypothesis step, two windowed stream pushes, an
adaptive three-frame video, a DR scene, a depth fill, a two-frame hard test
video with its scores, one synthetic train step, the sensor model over two
frames, one bf16 tracking step, a two-object batched ensemble step and a
one-rank face-sharded step, one ``render_at_bbox`` and one
``StepTimer.measure`` of a tracking step on the CPU, and look at
``sys.modules``. Every source
file of the port is also parsed, and its imports read. Importing the
port loads neither PyYAML nor Pillow (the CLIs and the file-backed dataset
import them when they read a file). ``chip_smoke.py`` imports only
the port, never the JAX package, and refuses to run without a CUDA card.
"""
import ast
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import numpy as np
import torch
torch.set_num_threads(2)
import iros20_6d_pose_tracking_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
    print("PORT_MODULE", m.name[len(port.__name__) + 1:])
print("LAZY_MODULES", sorted(m for m in ("yaml", "PIL") if m in sys.modules))
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
K = np.array([[300.0, 0, 128.0], [0, 300.0, 96.0], [0, 0, 1]], np.float32)
pose = np.eye(4, dtype=np.float32); pose[2, 3] = 0.5
torch.manual_seed(0)
t = trk.Tracker.from_parts(
    tracknet.create_model(64).eval(),
    trk.TrackerConfig(resolution=64, object_width_mm=110.0,
                      cull_backfaces=True),
    rz.upload(M.make_cube(0.08), "cpu"), K, np.zeros(8), np.full(8, 100.0))
rgb = np.full((192, 256, 3), 128, np.uint8)
depth = np.full((192, 256), 500, np.uint16)
out = t.on_track(pose, rgb, depth)
assert out.shape == (4, 4) and np.isfinite(out).all()
out = t.on_track(pose, rgb, depth, samples=3)
assert out.shape == (4, 4) and 0.0 <= t.last_score <= 1.0
from iros20_6d_pose_tracking_tpu_torch.tracking.stream import StreamTracker
s = StreamTracker(t, refetch_every=1).begin(pose)
for _ in range(2):
    s.push(rgb, depth)
assert s.poses().shape == (2, 4, 4) and s.stats()["bucket"] < 192
s.close()
from iros20_6d_pose_tracking_tpu_torch.tracking.dispatch import (
    AdaptiveVideoTracker)
d = AdaptiveVideoTracker(t, candidates=(2, 1), probe_frames=1)
poses, _ = d.track(pose, np.stack([rgb] * 3), np.stack([depth] * 3),
                   chunk_size=2)
assert np.array_equal(poses, t.track_video(pose, np.stack([rgb] * 3),
                                           np.stack([depth] * 3)))
from iros20_6d_pose_tracking_tpu_torch.datagen import pair_producer as pp
gen = torch.Generator().manual_seed(0)
out = pp.render_dr_scene(t.mesh, K, pose, pp.draw_dr_photometry(
    gen, 192, 256, "cpu"), 256, 192)
assert out[2].sum() > 0 and out[0].shape == (192, 256, 3)
from iros20_6d_pose_tracking_tpu_torch.ops import depthproc
filled = depthproc.fill_depth(torch.full((24, 32), 0.5))
assert torch.isfinite(filled).all()
from iros20_6d_pose_tracking_tpu_torch.apps import predict
predict.build_parser()
from iros20_6d_pose_tracking_tpu_torch.eval import synthetic_benchmark as SB
gt = SB.make_gt_trajectory(2)
mesh = rz.upload(M.make_cube(0.08), "cpu")
rgb_v, dep_v = SB._quantize(*SB.render_test_video(mesh, gt, K, hw=(192, 256),
                                                  hard=True))
add, adi = SB.ME.batch_errors(gt, gt, M.make_cube(0.08).verts, device="cpu")
assert 0.9 < (dep_v > 0).mean() < 1 and not add.any() and not adi.any()
from iros20_6d_pose_tracking_tpu_torch.data import dataset as D
from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr
synth = D.SyntheticPairs(rz.upload(M.make_cube(0.08), "cpu"), K,
                         resolution=32, object_width_mm=110.0,
                         dr=D.DRComposite())
cfg = tr.TrainConfig(resolution=32, batch_size=2)
net = tracknet.init_params(tracknet.create_model(32),
                           torch.Generator().manual_seed(0))
opt, lr_at = tr.make_optimizer(net, cfg, 10)
m = tr.train_step_synth(net, opt, lr_at(0), cfg, synth,
                        torch.Generator().manual_seed(1),
                        torch.Generator().manual_seed(2),
                        torch.zeros(8), torch.full((8,), 100.0))
assert torch.isfinite(m["loss"])
from iros20_6d_pose_tracking_tpu_torch.eval import domain_shift as DS
rgb_s, dep_s = DS.shift_video(torch.from_numpy(rgb_v[:2]).float(),
                              torch.from_numpy(dep_v[:2].astype(np.float32)),
                              gt, K, DS.SensorModel().scaled(4.0), seed=0)
assert rgb_s.shape == (2, 192, 256, 3) and (dep_s > 0).any()
t16 = trk.Tracker.from_parts(
    tracknet.create_model(64).eval(),
    trk.TrackerConfig(resolution=64, object_width_mm=110.0),
    rz.upload(M.make_cube(0.08), "cpu"), K, np.zeros(8), np.full(8, 100.0),
    dtype=torch.bfloat16)
p16, _ = trk.track_step(t16.model, t16.cfg, t16.mesh, t16.K, t16.mean,
                        t16.std, torch.from_numpy(pose), torch.from_numpy(rgb),
                        trk.upload_depth(depth, "cpu"))
assert p16.dtype == torch.float32 and torch.isfinite(p16).all()
from iros20_6d_pose_tracking_tpu_torch.parallel import latency, spmd
ens = spmd.stack_states([t.model, t.model])
run = spmd.multi_object_track_videos(ens.model, t.cfg, spmd.make_mesh(1),
                                     serial=False)
two = run(ens, spmd.stack_meshes([M.make_cube(0.08)] * 2, "cpu"), t.K,
          t.mean, t.std, torch.from_numpy(np.stack([pose] * 2)),
          trk.upload_rgb(np.stack([rgb[None]] * 2), "cpu"),
          trk.upload_depth(np.stack([depth[None]] * 2), "cpu"), [110.0, 90.0])
assert two.shape == (2, 1, 4, 4) and torch.isfinite(two).all()
sp = latency.sp_mesh(1)
p_sp = latency.sp_track_step(t.model, t.cfg, sp)(
    latency.shard_mesh_faces(t.mesh, sp), t.K, t.mean, t.std,
    torch.from_numpy(pose), torch.from_numpy(rgb),
    trk.upload_depth(depth, "cpu"))
assert torch.isfinite(p_sp).all()
from iros20_6d_pose_tracking_tpu_torch.utils.profiling import StepTimer
rgb_a, dep_a, bbox_a = rz.render_at_bbox(t.mesh, torch.from_numpy(pose), t.K,
                                         110.0, out_hw=(64, 64))
assert (dep_a > 0).any() and bbox_a.shape == (4, 2)
timed = StepTimer(warmup=1, reps=1).measure(
    trk.track_step, t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
    torch.from_numpy(pose), torch.from_numpy(rgb),
    trk.upload_depth(depth, "cpu"))
assert timed["per_iter_ms"] > 0
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "flax")))
print("JAX_MODULES", bad)
pkg = sorted(m for m in sys.modules if m == "iros20_6d_pose_tracking_tpu"
             or m.startswith("iros20_6d_pose_tracking_tpu."))
print("JAX_PACKAGE_MODULES", pkg)
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_MODULES []" in proc.stdout, proc.stdout
    assert "JAX_PACKAGE_MODULES []" in proc.stdout, proc.stdout
    assert "LAZY_MODULES []" in proc.stdout, proc.stdout
    walked = {line.split()[1] for line in proc.stdout.splitlines()
              if line.startswith("PORT_MODULE ")}
    assert walked >= {"render.raster_kernels", "eval.metrics", "eval.eval_ycb",
                      "eval.eval_ycbineoat", "eval.synthetic_benchmark",
                      "datagen.pair_producer", "tracking.tracker",
                      "core.camera", "ops.image", "data.augment",
                      "data.dataset", "train.trainer", "train.checkpoint",
                      "utils.config", "apps.train", "apps.predict",
                      "tracking.hypotheses", "ops.pointcloud",
                      "utils.viz", "tracking.stream", "apps.predict_ros",
                      "native.dataload", "tracking.dispatch",
                      "datagen.blender_gen", "core.views",
                      "apps.datagen", "eval.domain_shift",
                      "apps.accuracy_suite", "parallel.spmd",
                      "parallel.latency", "utils.profiling",
                      "apps.demo_train_and_track", "apps.make_ycb_fixture",
                      "apps.realdata_dryrun"}, walked


def _imported_modules(path):
    mods = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


_JAX_SIDE = ("jax", "jaxlib", "flax", "iros20_6d_pose_tracking_tpu")


def test_port_sources_import_nothing_of_jax():
    """Every ``.py`` under the port, parsed: no import of jax, jaxlib, flax
    or the JAX package, absolute or relative (a relative import cannot
    leave the port's package)."""
    root = os.path.join(REPO, "iros20_6d_pose_tracking_tpu_torch")
    files, bad = 0, {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            files += 1
            hits = sorted(m for m in _imported_modules(path)
                          if m.split(".")[0] in _JAX_SIDE)
            if hits:
                bad[os.path.relpath(path, REPO)] = hits
    assert files >= 30, files
    assert not bad, bad


def test_chip_smoke_imports_only_the_port():
    mods = _imported_modules(os.path.join(REPO, "chip_smoke.py"))
    assert "iros20_6d_pose_tracking_tpu_torch.render" in mods
    bad = sorted(m for m in mods if m.split(".")[0] in _JAX_SIDE + (
        "yaml", "PIL"))
    assert not bad, bad


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    """On a machine without CUDA (this one), and from a directory that holds
    chip_smoke.py and nothing else, the script exits nonzero and prints no
    result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout, proc.stdout
