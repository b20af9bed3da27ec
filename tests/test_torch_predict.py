"""The port's tracking CLI (``apps/predict.py``) with ``--device cpu`` on a
YCB-style fixture tree (tests/test_apps.py's: a subdiv-2 icosphere, 160x120
PNG frames, a 64^2 ROI), against itself across modes and against the JAX
package's CLI on the same tree; the realdata_dryrun chain through the port."""
import argparse
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from iros20_6d_pose_tracking_tpu.apps import predict as jpredict
from iros20_6d_pose_tracking_tpu.models import tracknet as jnet
from iros20_6d_pose_tracking_tpu.train import checkpoint as jck
from iros20_6d_pose_tracking_tpu_torch.apps import predict
from iros20_6d_pose_tracking_tpu_torch.core import se3
from iros20_6d_pose_tracking_tpu_torch.eval import metrics as ME
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

torch.set_num_threads(2)

RES = 64
K = np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1.0]], np.float32)
IMG_W, IMG_H = 160, 120
FRAMES = 5


def _rot_angle(Ra, Rb):
    R = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arcsin(min(np.linalg.norm(w) / 2.0, 1.0)))


def _write_seq(root, seq_id, class_id, tm, n=FRAMES, first=0):
    """color/, depth_filled/ and pose_gt/<class>/ of one sequence, rendered
    by the port on the CPU; the object drifts and turns a little."""
    seq = root / f"{seq_id:04d}"
    for d in ("color", "depth_filled", f"pose_gt/{class_id}"):
        (seq / d).mkdir(parents=True, exist_ok=True)
    mesh = rz.upload(tm, "cpu")
    gts = []
    for i in range(n):
        pose = se3.make_pose(
            se3.so3_exp(torch.tensor([0.0, 0.03 * i, 0.0])),
            torch.tensor([0.004 * i, -0.002 * i, 0.5 + 0.002 * i]))
        rgb, depth = rz.render(mesh, pose, torch.as_tensor(K),
                               rz.full_frame_window(IMG_W, IMG_H),
                               out_hw=(IMG_H, IMG_W))
        name = f"{i + first:06d}"
        Image.fromarray(rgb.numpy().astype(np.uint8)).save(
            seq / "color" / f"{name}.png")
        Image.fromarray(depth.numpy().astype(np.uint16)).save(
            seq / "depth_filled" / f"{name}.png")
        np.savetxt(seq / "pose_gt" / str(class_id) / f"{name}.txt",
                   pose.numpy())
        gts.append(pose.numpy().astype(np.float64))
    return gts


def _write_obj(tm, path):
    with open(path, "w") as f:
        for v in tm.verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for fc in tm.faces[: tm.num_faces]:
            f.write(f"f {fc[0] + 1} {fc[1] + 1} {fc[2] + 1}\n")


def _write_artifacts(root):
    (root / "train_data").mkdir(exist_ok=True)
    info = {"camera": {"focalX": 300.0, "focalY": 300.0, "centerX": 80.0,
                       "centerY": 60.0, "width": IMG_W, "height": IMG_H},
            "resolution": RES, "boundingbox": 10, "max_translation": 0.02,
            "max_rotation": 15, "train_samples": 8, "val_samples": 4}
    with open(root / "dataset_info.yml", "w") as f:
        yaml.dump(info, f)
    np.save(root / "mean.npy", np.zeros(8))
    np.save(root / "std.npy", np.full(8, 100.0))


def _write_checkpoint(path, head_scale):
    """A Flax checkpoint written by the JAX package: the network's seeded
    init with its regression heads scaled (0: the tracker holds its init)."""
    import jax

    model = jnet.Se3TrackNet(image_size=RES)
    variables = jnet.init_variables(model, jax.random.PRNGKey(0))
    params = variables["params"]
    for head in ("trans_out", "rot_out"):
        params[head]["kernel"] = params[head]["kernel"] * head_scale
        params[head]["bias"] = params[head]["bias"] * 0.0
    jck.save_checkpoint(str(path), {"params": params,
                                    "batch_stats": variables["batch_stats"]})


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ycbfix_port")
    tm = M.make_icosphere(subdiv=2, radius=0.05)
    _write_obj(tm, root / "object.obj")
    gts = _write_seq(root, 48, 4, tm)
    _write_artifacts(root)
    _write_checkpoint(root / "small_head.msgpack", 0.05)
    return root, gts


def _args(root, out, *extra):
    return ["--mode", "ycbv", "--seq_id", "48", "--class_id", "4",
            "--ycb_dir", str(root), "--train_data_path",
            str(root / "train_data"), "--mean_std_path", str(root),
            "--model_path", str(root / "object.obj"), "--outdir", str(out),
            "--ckpt_dir", str(root / "small_head.msgpack"), *extra]


def _poses(out):
    files = sorted(p for p in os.listdir(out)
                   if p.endswith(".txt") and "gt" not in p)
    return np.stack([np.loadtxt(out / p) for p in files])


def test_scan_and_ontrack_agree_and_follow_jax(tree, tmp_path):
    """scan (chunked, a ragged last chunk) and ontrack write the same poses;
    both lie within 5e-4 m and 1e-3 rad of the JAX CLI's scan on the same
    tree; the gt files and the AUC are the JAX CLI's."""
    root, gts = tree
    auc = predict.main(_args(root, tmp_path / "scan", "--track_mode", "scan",
                             "--chunk_size", "2", "--device", "cpu"))
    predict.main(_args(root, tmp_path / "ontrack", "--track_mode", "ontrack",
                       "--device", "cpu"))
    jauc = jpredict.predict_sequence_ycb(
        jpredict.build_parser().parse_args(_args(root, tmp_path / "jax")),
        yaml.safe_load(open(root / "dataset_info.yml")),
        np.load(root / "mean.npy"), np.load(root / "std.npy"))
    scan, ontrack = _poses(tmp_path / "scan"), _poses(tmp_path / "ontrack")
    ref = _poses(tmp_path / "jax")
    assert scan.shape == (FRAMES, 4, 4)
    np.testing.assert_array_equal(scan[0], gts[0])
    np.testing.assert_allclose(scan, ontrack, atol=1e-6)
    np.testing.assert_allclose(scan[:, :3, 3], ref[:, :3, 3], atol=5e-4)
    assert max(_rot_angle(a[:3, :3], b[:3, :3])
               for a, b in zip(scan, ref)) < 1e-3
    assert sorted(os.listdir(tmp_path / "scan")) == \
        sorted(os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "jax"):
        if name.endswith("gt.txt"):
            np.testing.assert_array_equal(
                np.loadtxt(tmp_path / "scan" / name),
                np.loadtxt(tmp_path / "jax" / name))
    assert abs(auc - jauc) < 0.5, (auc, jauc)


def test_ontrack_samples_and_reinit(tree, tmp_path):
    """ontrack with --samples 4 writes finite poses that stay on the object;
    --reinit_frames restarts scan and ontrack from the PoseCNN pose at the
    same frame, and the two still agree."""
    import scipy.io

    root, gts = tree
    predict.main(_args(root, tmp_path / "multi", "--track_mode", "ontrack",
                       "--samples", "4", "--device", "cpu"))
    multi = _poses(tmp_path / "multi")
    assert np.isfinite(multi).all()
    assert np.abs(multi[:, :3, 3] - np.stack(gts)[:, :3, 3]).max() < 0.03
    (root / "image_sets").mkdir(exist_ok=True)
    (root / "image_sets" / "keyframe.txt").write_text(
        "0048/000001\n0048/000002\n")
    predict._KEYFRAME_INDEX.clear()
    resdir = root / "YCB_Video_toolbox" / "results_PoseCNN_RSS2018"
    resdir.mkdir(parents=True, exist_ok=True)
    for idx in (0, 1):
        scipy.io.savemat(resdir / f"{idx:06d}.mat", {
            "rois": np.array([[0, 4.0, 0, 0, 0, 0, 0]]),
            "poses_icp": np.array([[1.0, 0, 0, 0, 0.0, 0.0, 0.52]])})
    runs = {}
    for mode in ("scan", "ontrack"):
        out = tmp_path / f"reinit_{mode}"
        predict.main(_args(root, out, "--track_mode", mode, "--chunk_size",
                           "2", "--reinit_frames", "48/3", "--device", "cpu"))
        runs[mode] = _poses(out)
    np.testing.assert_allclose(runs["scan"], runs["ontrack"], atol=1e-6)
    # frame 2 (entry 3, 1-based) restarts from the PoseCNN pose: its output
    # is one tanh-bounded update away from it
    dt = np.linalg.norm(runs["scan"][2][:3, 3] - [0.0, 0.0, 0.52])
    assert dt <= np.sqrt(3) * 0.03 + 1e-6


def test_stream_modes_equal_scan(tree, tmp_path, capsys):
    """--track_mode stream, windowed and with --no_window, writes scan's
    pose files bit for bit (the window holds every ROI of the fixture), and
    says which PNG decoder it used; --samples 2 with --reinit_frames runs
    too and restarts at the PoseCNN pose."""
    import scipy.io

    root, _ = tree
    predict._png_decoder.cache_clear()
    runs = {}
    for name, extra in (("scan", ["--track_mode", "scan", "--chunk_size",
                                  "2"]),
                        ("stream", ["--track_mode", "stream"]),
                        ("full", ["--track_mode", "stream", "--no_window"])):
        out = tmp_path / name
        predict.main(_args(root, out, "--device", "cpu", *extra))
        runs[name] = _poses(out)
        assert sorted(os.listdir(out)) == sorted(os.listdir(tmp_path / "scan"))
    said = capsys.readouterr().out
    assert said.count("predict: PNG frames decode with") == 1
    np.testing.assert_array_equal(runs["stream"], runs["scan"])
    np.testing.assert_array_equal(runs["full"], runs["scan"])
    (root / "image_sets").mkdir(exist_ok=True)
    (root / "image_sets" / "keyframe.txt").write_text(
        "0048/000001\n0048/000002\n")
    predict._KEYFRAME_INDEX.clear()
    resdir = root / "YCB_Video_toolbox" / "results_PoseCNN_RSS2018"
    resdir.mkdir(parents=True, exist_ok=True)
    for idx in (0, 1):
        scipy.io.savemat(resdir / f"{idx:06d}.mat", {
            "rois": np.array([[0, 4.0, 0, 0, 0, 0, 0]]),
            "poses_icp": np.array([[1.0, 0, 0, 0, 0.0, 0.0, 0.52]])})
    out = tmp_path / "multi"
    predict.main(_args(root, out, "--device", "cpu", "--track_mode",
                       "stream", "--samples", "2", "--reinit_frames", "48/3"))
    multi = _poses(out)
    assert multi.shape == (FRAMES, 4, 4) and np.isfinite(multi).all()
    assert np.linalg.norm(multi[2][:3, 3] - [0.0, 0.0, 0.52]) <= \
        np.sqrt(3) * 0.03 + 1e-6


def test_adaptive_writes_scan_files(tree, tmp_path, capsys):
    """--track_mode adaptive (candidates chunk, 8, 1 and the stream, one
    dispatcher across the re-init segments) writes scan's pose files bit
    for bit and prints its telemetry."""
    root, _ = tree
    runs = {}
    for name, extra in (("scan", ["--track_mode", "scan"]),
                        ("adaptive", ["--track_mode", "adaptive",
                                      "--chunk_size", "2"])):
        out = tmp_path / name
        predict.main(_args(root, out, "--device", "cpu", *extra))
        runs[name] = _poses(out)
        assert sorted(os.listdir(out)) == sorted(os.listdir(tmp_path / "scan"))
    said = capsys.readouterr().out
    assert "adaptive dispatch: {'mode': " in said
    assert "probe_ms_per_frame" in said
    np.testing.assert_array_equal(runs["adaptive"], runs["scan"])


def test_track_files_auto_reinit_wiring(tree, monkeypatch):
    """--auto_reinit wires a ReinitPolicy and a redetect-backed
    on_track_lost into the stream (raising samples to 2), as JAX's
    tests/test_apps.py checks: the callback resolves poses through redetect
    with 1-based file numbering, and a failing redetect gives None."""
    from iros20_6d_pose_tracking_tpu_torch.tracking import stream as st_mod

    root, _ = tree
    captured = {}

    class FakeStream:
        def __init__(self, tracker, **kw):
            captured.update(kw)

        def begin(self, pose, image_hw=None):
            return self

        def push(self, rgb, depth):
            pass

        def poses(self):
            return np.zeros((3, 4, 4), np.float32)

        def close(self):
            captured["closed"] = True

    monkeypatch.setattr(st_mod, "StreamTracker", FakeStream)
    seq = root / "0048"
    files = [str(seq / "color" / f"{i:06d}.png") for i in range(4)]
    dfiles = [str(seq / "depth_filled" / f"{i:06d}.png") for i in range(4)]
    seen = []

    def redetect(file_idx):
        seen.append(file_idx)
        if file_idx >= 3:
            raise RuntimeError("no keyframe near")
        p = np.eye(4, dtype=np.float32)
        p[2, 3] = 0.6
        return p

    args = argparse.Namespace(track_mode="stream", samples=1,
                              auto_reinit=True, no_window=False)
    out = predict._track_files(None, files, dfiles,
                               np.eye(4, dtype=np.float32), args,
                               redetect=redetect)
    assert out.shape == (4, 4, 4) and captured["closed"]
    assert captured["samples"] == 2 and captured["window"]
    assert captured["reinit_policy"] is not None
    cb = captured["on_track_lost"]
    pose = cb(1, 0.05)                       # stream index 1 -> file 2
    assert seen == [2] and pose[2, 3] == 0.6
    assert cb(2, 0.05) is None               # redetect raised -> None
    captured.clear()
    args = argparse.Namespace(track_mode="stream", samples=1,
                              auto_reinit=False, no_window=True)
    predict._track_files(None, files, dfiles, np.eye(4, dtype=np.float32),
                         args, redetect=redetect)
    assert captured["reinit_policy"] is None and captured["samples"] == 1
    assert not captured["window"]


def test_visual_outputs(tree, tmp_path):
    """--viz_dir, --save_video and --canvas_dir write one overlay and one
    render|crop canvas per tracked frame, and the video."""
    import cv2

    root, _ = tree
    out, viz, canvas = tmp_path / "run", tmp_path / "viz", tmp_path / "canvas"
    predict.main(_args(root, out, "--track_mode", "scan", "--device", "cpu",
                       "--viz_dir", str(viz), "--save_video", "--canvas_dir",
                       str(canvas)))
    assert len(list(viz.glob("*.png"))) == FRAMES - 1
    assert len(list(canvas.glob("*.png"))) == FRAMES - 1
    assert (out / "video.mp4").exists()
    img = cv2.imread(str(sorted(canvas.glob("*.png"))[0]))
    assert img.shape == (RES, RES * 2 + 10, 3)
    assert img[:, :RES].max() > 0 and img[:, RES + 10:].max() > 0


def test_ycbineoat_writes_every_frame(tree, tmp_path):
    """ycbineoat tracks from frame 0 and saves one pose per frame, the same
    in scan and ontrack modes; frame 0's is the update of the init on frame
    0 itself, as ``on_track`` gives it with the YCBInEOAT normalizers."""
    from iros20_6d_pose_tracking_tpu_torch.tracking.tracker import Tracker

    root, gts = tree
    vid = tmp_path / "mustard_fix"
    for d in ("rgb", "depth_filled", "annotated_poses"):
        (vid / d).mkdir(parents=True)
    seq = root / "0048"
    for i in range(FRAMES):
        os.link(seq / "color" / f"{i:06d}.png", vid / "rgb" / f"{i:06d}.png")
        os.link(seq / "depth_filled" / f"{i:06d}.png",
                vid / "depth_filled" / f"{i:06d}.png")
        os.link(seq / "pose_gt" / "4" / f"{i:06d}.txt",
                vid / "annotated_poses" / f"{i:06d}.txt")
    for mode in ("scan", "ontrack"):
        predict.main(["--mode", "ycbineoat", "--YCBInEOAT_dir", str(vid),
                      "--ckpt_dir", str(root / "small_head.msgpack"),
                      "--train_data_path", str(root / "train_data"),
                      "--mean_std_path", str(root), "--model_path",
                      str(root / "object.obj"), "--outdir",
                      str(tmp_path / mode), "--track_mode", mode,
                      "--device", "cpu"])
    out = tmp_path / "scan"
    files = sorted(os.listdir(out))
    assert files == [f"{i:07d}.txt" for i in range(FRAMES)]
    assert sorted(os.listdir(tmp_path / "ontrack")) == files
    np.testing.assert_allclose(_poses(out), _poses(tmp_path / "ontrack"),
                               atol=1e-6)
    info = yaml.safe_load(open(root / "dataset_info.yml"))
    t = Tracker(info, np.zeros(8), np.full(8, 100.0),
                model_path=str(root / "object.obj"),
                ckpt_dir=str(root / "small_head.msgpack"),
                rot_normalizer=30 * np.pi / 180, device="cpu")
    first = t.on_track(gts[0], np.array(Image.open(vid / "rgb/000000.png")),
                       np.array(Image.open(vid / "depth_filled/000000.png")))
    np.testing.assert_allclose(np.loadtxt(out / files[0]), first, atol=1e-6)


def test_realdata_dryrun_chain(tmp_path):
    """examples/realdata_dryrun.py's chain through the port: a zero-head
    Flax checkpoint written by the JAX package, ``--mode ycbv_all`` over the
    test sequences holding the class (scan and ontrack), every predicted
    pose within 1e-4 of frame 0's gt, and the AUC recomputed from the
    files."""
    import jax

    root = tmp_path / "dryrun"
    data = root / "data_organized"
    data.mkdir(parents=True)
    tm = M.make_icosphere(subdiv=2, radius=0.05)
    _write_obj(tm, root / "obj4.obj")
    gts = {48: _write_seq(data, 48, 4, tm, n=4, first=1),
           51: _write_seq(data, 51, 4, tm, n=3, first=1)}
    _write_seq(data, 49, 7, M.make_cube(0.08), n=2, first=1)  # not class 4
    _write_artifacts(root)
    ckpt = str(root / "zero_head.msgpack")
    _write_checkpoint(ckpt, 0.0)
    for mode in ("scan", "ontrack"):
        out = root / "results" / mode
        results = predict.main([
            "--mode", "ycbv_all", "--class_id", "4", "--ycb_dir", str(data),
            "--train_data_path", str(root / "train_data"),
            "--mean_std_path", str(root), "--ckpt_dir", ckpt,
            "--model_path", str(root / "obj4.obj"), "--outdir", str(out),
            "--track_mode", mode, "--chunk_size", "2", "--device", "cpu"])
        assert sorted(results) == [48, 51]
        for seq_id, gt in gts.items():
            preds = _poses(out / f"seq{seq_id:04d}")
            assert len(preds) == len(gt)
            for p in preds:
                np.testing.assert_allclose(p, gt[0], atol=1e-4)
            held = np.tile(gt[0][None], (len(gt), 1, 1))
            _, adi = ME.batch_errors(held, np.stack(gt), tm.verts,
                                     device="cpu")
            assert abs(results[seq_id] - ME.vocap(adi) * 100) < 0.05


def test_init_poses_match_jax(tree):
    """--init posecnn and poserbpf read the same poses as the JAX CLI."""
    import scipy.io

    root, _ = tree
    (root / "image_sets").mkdir(exist_ok=True)
    (root / "image_sets" / "keyframe.txt").write_text(
        "0048/000001\n0048/000003\n")
    resdir = root / "YCB_Video_toolbox" / "results_PoseCNN_RSS2018"
    resdir.mkdir(parents=True, exist_ok=True)
    q = np.array([0.9, 0.1, -0.3, 0.2])
    q /= np.linalg.norm(q)
    scipy.io.savemat(resdir / "000001.mat", {
        "rois": np.array([[0, 4.0, 0, 0, 0, 0, 0]]),
        "poses_icp": np.array([[*q, 0.01, -0.02, 0.6]])})
    rb = root / "YCB_Video_toolbox" / "PoseRBPF_Results" / "YCB_results_RGBD"
    for c in range(1, 5):
        (rb / f"{c:03d}_class").mkdir(parents=True, exist_ok=True)
    (rb / "004_class" / "seq_1").mkdir(exist_ok=True)
    (rb / "004_class" / "seq_1" / "Pose_0.txt").write_text(
        "0 0 0.05 -0.03 0.7 0.9 0.1 -0.3 0.2\n")
    args = argparse.Namespace(ycb_dir=str(root), class_id=4)
    predict._KEYFRAME_INDEX.clear()
    jpredict._KEYFRAME_INDEX.clear()
    for frame in (2, 3):
        np.testing.assert_array_equal(predict._posecnn_pose(args, 48, frame),
                                      jpredict._posecnn_pose(args, 48, frame))
    np.testing.assert_array_equal(predict._poserbpf_pose(args, 4, 48),
                                  jpredict._poserbpf_pose(args, 4, 48))


@pytest.mark.parametrize("flags", [
    pytest.param(["--track_mode", "adaptive", "--bf16"], id="flags2-P12"),
    pytest.param(["--bf16"], id="flags3-item 8")])
def test_unported_options_raise(tree, tmp_path, flags):
    """The options that raised until ROADMAP item 8 landed (the ids keep
    their names): ``--bf16`` now runs the CNN in bfloat16, in scan and in
    adaptive mode, and writes every pose within JAX's bf16 bars of the
    float32 scan's (tests/test_tracker.py: 1 mm, 5e-3 on the rotation)."""
    root, _ = tree
    predict.main(_args(root, tmp_path / "f32", "--device", "cpu"))
    predict.main(_args(root, tmp_path / "bf16", "--device", "cpu", *flags))
    p32, p16 = _poses(tmp_path / "f32"), _poses(tmp_path / "bf16")
    assert p16.shape == p32.shape and np.isfinite(p16).all()
    assert np.linalg.norm(p16[:, :3, 3] - p32[:, :3, 3], axis=-1).max() < 1e-3
    assert np.abs(p16[:, :3, :3] - p32[:, :3, :3]).max() < 5e-3


def test_rgbd_to_pointcloud_matches_jax():
    """ops/pointcloud.rgbd_to_pointcloud against the JAX function: points
    within float32 rounding, the same mask, the colors reshaped."""
    import jax.numpy as jnp

    from iros20_6d_pose_tracking_tpu.ops import pointcloud as jpc
    from iros20_6d_pose_tracking_tpu_torch.ops import pointcloud as pc

    rng = np.random.RandomState(8)
    depth = rng.uniform(0.0, 2.5, (IMG_H, IMG_W)).astype(np.float32)
    rgb = rng.randint(0, 255, (IMG_H, IMG_W, 3)).astype(np.uint8)
    pts, colors, mask = pc.rgbd_to_pointcloud(K, torch.as_tensor(depth),
                                              torch.as_tensor(rgb))
    jpts, jcolors, jmask = jpc.rgbd_to_pointcloud(
        jnp.asarray(K), jnp.asarray(depth), jnp.asarray(rgb))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(colors.numpy(), np.asarray(jcolors))
    assert 0.5 < mask.float().mean() < 0.9
    assert pc.rgbd_to_pointcloud(K, torch.as_tensor(depth))[1] is None
