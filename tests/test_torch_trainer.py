"""The port's training runtime end to end on the CPU: the epoch loop and its
checkpoints, resume, the training CLI (synthetic and file-backed) and
``train_object``, whose checkpoints a ``Tracker`` loads.

Mirrors tests/test_train.py and the train case of tests/test_apps.py at a
tiny size (48^2, batch 2, a few steps); the numbers are the port's own, the
parity with JAX is in tests/test_torch_train_parity.py.
"""
import json
import os

import numpy as np
import pytest
import torch
import yaml

from iros20_6d_pose_tracking_tpu.eval import synthetic_benchmark as JSB
from iros20_6d_pose_tracking_tpu_torch.apps import train as train_app
from iros20_6d_pose_tracking_tpu_torch.data import augment as A
from iros20_6d_pose_tracking_tpu_torch.data import dataset as D
from iros20_6d_pose_tracking_tpu_torch.eval import synthetic_benchmark as SB
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
from iros20_6d_pose_tracking_tpu_torch.train import checkpoint as ck
from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

torch.set_num_threads(2)

RES = 48
BATCH = 2
K = np.array([[250.0, 0, 24.0], [0, 250.0, 24.0], [0, 0, 1.0]], np.float32)
XYZ = ((-0.05, 0.05), (-0.05, 0.05), (0.45, 0.65))
CKPTS = ("model_best_train.pt", "model_best_val.pt", "checkpoint_last.pt")


def _mesh():
    return M.make_icosphere(subdiv=2, radius=0.05)


@pytest.fixture(scope="module")
def synth():
    return D.SyntheticPairs(rz.upload(_mesh(), "cpu"), K, resolution=RES,
                            object_width_mm=110.0, xyz_range=XYZ)


def _cfg(**kw):
    return tr.TrainConfig(resolution=RES, batch_size=BATCH,
                          learning_rate=3e-4, **kw)


def _trainer(outdir):
    return tr.Trainer(tracknet.Se3TrackNet(RES), _cfg(), str(outdir),
                      steps_per_epoch=2, mean=np.zeros(8),
                      std=np.full(8, 100.0), device="cpu")


def _sources(synth):
    def train_batches(epoch):
        return (synth.sample_batch(tr.step_generator("cpu", epoch, i), BATCH)
                for i in range(2))

    def val_batches(epoch):
        return [synth.sample_batch(tr.step_generator("cpu", 99, 0), BATCH)]

    return train_batches, val_batches


def test_loop_writes_checkpoints_and_resume_is_bit_equal(tmp_path, synth):
    """Two epochs of two steps write the three checkpoints with finite
    losses; one epoch, a fresh Trainer resumed from checkpoint_last.pt and
    a second epoch give the uninterrupted run's weights, BatchNorm
    statistics and Adam moments bit for bit."""
    train_batches, val_batches = _sources(synth)
    full = _trainer(tmp_path / "full")
    full.loop(2, train_batches, val_batches, log_fn=lambda *a: None)
    assert set(CKPTS) <= set(os.listdir(tmp_path / "full"))
    meta = ck.load_metadata(str(tmp_path / "full" / "checkpoint_last.pt"))
    assert meta["epoch"] == 1
    assert np.isfinite(meta["train_loss"]) and np.isfinite(meta["val_loss"])
    assert full.step == 4 and full.epoch == 2

    first = _trainer(tmp_path / "split")
    first.loop(1, train_batches, val_batches, log_fn=lambda *a: None)
    resumed = _trainer(tmp_path / "split")
    resumed.resume(ck.latest_checkpoint(str(tmp_path / "split")))
    assert resumed.step == 2 and resumed.epoch == 1
    resumed.loop(2, train_batches, val_batches, log_fn=lambda *a: None)
    a, b = full.state_dict(), resumed.state_dict()
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for pid, st in a["optimizer"]["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[name], b["optimizer"]["state"][pid][name])
    assert (a["best_train"], a["best_val"]) == (b["best_train"],
                                                b["best_val"])


def test_checkpoint_round_trip(tmp_path):
    """save_checkpoint / load_checkpoint (weights only) / load_metadata /
    latest_checkpoint."""
    state = {"model": {"w": torch.arange(6.0).reshape(2, 3)}, "step": 7,
             "mean": torch.ones(8)}
    path = str(tmp_path / "checkpoint_last.pt")
    assert ck.latest_checkpoint(str(tmp_path)) is None
    ck.save_checkpoint(path, state, {"note": "hi"})
    restored = ck.load_checkpoint(path)
    assert torch.equal(restored["model"]["w"], state["model"]["w"])
    assert restored["step"] == 7 and torch.equal(restored["mean"],
                                                 torch.ones(8))
    assert ck.load_metadata(path) == {"note": "hi"}
    assert ck.latest_checkpoint(str(tmp_path)) == path
    assert not os.path.exists(path + ".tmp")


def _write_obj(tm, path):
    with open(path, "w") as f:
        for v in tm.verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for fc in tm.faces[:tm.num_faces]:
            f.write(f"f {fc[0] + 1} {fc[1] + 1} {fc[2] + 1}\n")


def _write_config(root, data_path):
    info = {
        "camera": {"focalX": 250.0, "focalY": 250.0, "centerX": 24.0,
                   "centerY": 24.0, "width": 48, "height": 48},
        "resolution": RES, "boundingbox": 10,
        "max_translation": 0.02, "max_rotation": 15,
        "train_samples": 4, "val_samples": 2,
        "models": {0: {"model_path": str(root / "object.obj")}},
    }
    with open(root / "dataset_info.yml", "w") as f:
        yaml.dump(info, f)
    cfg = {
        "data_path": str(data_path), "validation_path": str(data_path),
        "learning_rate": 1e-3, "weight_decay": 1e-6, "epochs": 1,
        "batch_size": BATCH, "loss_weights": {"trans": 1, "rot": 1},
        "data_augmentation": {"hsv_noise": [15, 15, 15],
                              "bright_mag": [0.5, 1.5],
                              "gaussian_noise": {"rgb": 2, "depth": 5},
                              "gaussian_blur_kernel": 6},
    }
    with open(root / "config.yml", "w") as f:
        yaml.dump(cfg, f)
    return info


def _check_outputs(outdir, info):
    files = set(os.listdir(outdir))
    assert {"mean.npy", "std.npy", "dataset_info.yml",
            "config_backup.yml"} | set(CKPTS) <= files, files
    for name in CKPTS:
        with open(outdir / (name + ".json")) as f:
            meta = json.load(f)
        assert np.isfinite(meta["train_loss"]), meta
    assert np.isfinite(np.load(outdir / "std.npy")).all()
    # The trained checkpoint loads into a Tracker.
    t = trk.Tracker(info, np.load(outdir / "mean.npy"),
                    np.load(outdir / "std.npy"),
                    ckpt_dir=str(outdir / "model_best_train.pt"),
                    model_path=info["models"][0]["model_path"],
                    device="cpu")
    assert t.cfg.resolution == RES


@pytest.mark.parametrize("dr", [False, True], ids=["plain", "dr"])
def test_train_cli_synthetic(tmp_path, dr):
    """``apps.train --synthetic`` (with and without ``--dr``) on the CPU:
    the mean/std pass, one epoch of two steps, the three checkpoints with
    finite losses, and a Tracker that loads the best one."""
    _write_obj(_mesh(), tmp_path / "object.obj")
    (tmp_path / "train_data").mkdir()
    info = _write_config(tmp_path, tmp_path / "train_data")
    outdir = tmp_path / "train_out"
    train_app.main(["--config", str(tmp_path / "config.yml"),
                    "--output_path", str(outdir), "--synthetic",
                    "--model_path", str(tmp_path / "object.obj"),
                    "--epochs", "1", "--device", "cpu"]
                   + (["--dr"] if dr else []))
    _check_outputs(outdir, info)


def _write_pair_tree(root, synth, n=4, size=64):
    """``n`` pairs in the reference layout at ``size``^2 (so the reader's
    resize runs): %07d{rgbA,rgbB,depthA,depthB,segB}.png + meta.npz.
    Returns the arrays written."""
    from PIL import Image

    root.mkdir(parents=True)
    scale = np.float32([[size / RES], [size / RES], [1]])
    big = D.SyntheticPairs(synth.mesh, K * scale, resolution=size,
                           object_width_mm=110.0,
                           xyz_range=XYZ)
    raw = big.sample_batch(torch.Generator().manual_seed(11), n)
    out = {}
    for k in ("rgbA", "rgbB"):
        out[k] = np.clip(np.round(raw[k].numpy()), 0, 255).astype(np.uint8)
    for k in ("depthA", "depthB"):
        out[k] = np.clip(np.round(raw[k].numpy()), 0, 65535).astype(np.uint16)
    out["segB"] = raw["maskB"].numpy().astype(np.uint8)
    for i in range(n):
        for k, arr in out.items():
            Image.fromarray(arr[i]).save(root / f"{i:07d}{k}.png")
        np.savez(root / f"{i:07d}meta.npz",
                 A_in_cam=raw["A_in_cam"][i].numpy(),
                 B_in_cam=raw["B_in_cam"][i].numpy())
    out["A_in_cam"] = raw["A_in_cam"].numpy()
    return out


def test_pair_dataset_reads_the_reference_layout(tmp_path, synth):
    """PairDataset decodes what was written, resized with the index rule,
    and batches pad the tail with ``n_valid``."""
    written = _write_pair_tree(tmp_path / "pairs", synth, n=3)
    ds = D.PairDataset(str(tmp_path / "pairs"), resolution=RES)
    assert len(ds) == 3
    idx = (np.arange(RES) * 64) // RES
    rec = ds[1]
    np.testing.assert_array_equal(rec.rgbA, written["rgbA"][1][idx][:, idx])
    np.testing.assert_array_equal(rec.depthB,
                                  written["depthB"][1][idx][:, idx])
    np.testing.assert_array_equal(rec.maskB, written["segB"][1][idx][:, idx])
    np.testing.assert_array_equal(rec.A_in_cam, written["A_in_cam"][1])
    batches = list(ds.batches(2, shuffle=False, drop_last=False,
                              pad_to_batch=True))
    assert [b["n_valid"] for b in batches] == [2, 1]
    assert batches[1]["rgbA"].shape == (2, RES, RES, 3)


def test_train_cli_file_backed(tmp_path, synth):
    """``apps.train`` on a 4-pair PNG tree written here: the three
    checkpoints with finite losses."""
    _write_obj(_mesh(), tmp_path / "object.obj")
    _write_pair_tree(tmp_path / "train_data", synth)
    info = _write_config(tmp_path, tmp_path / "train_data")
    outdir = tmp_path / "train_out"
    train_app.main(["--config", str(tmp_path / "config.yml"),
                    "--output_path", str(outdir), "--device", "cpu"])
    _check_outputs(outdir, info)


def test_train_cli_refuses_bf16_and_dr_without_synthetic(tmp_path):
    """``--dr`` without ``--synthetic`` is refused. ``--bf16`` is no longer
    refused: it trains bfloat16 activations, and the checkpoints hold
    float32 parameters, statistics and Adam state."""
    with pytest.raises(SystemExit):
        train_app.main(["--config", str(tmp_path / "none.yml"), "--dr"])
    _write_obj(_mesh(), tmp_path / "object.obj")
    (tmp_path / "train_data").mkdir()
    info = _write_config(tmp_path, tmp_path / "train_data")
    outdir = tmp_path / "train_out"
    train_app.main(["--config", str(tmp_path / "config.yml"),
                    "--output_path", str(outdir), "--synthetic",
                    "--model_path", str(tmp_path / "object.obj"),
                    "--epochs", "1", "--device", "cpu", "--bf16"])
    _check_outputs(outdir, info)
    state = ck.load_checkpoint(str(outdir / "checkpoint_last.pt"))
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in state["model"].values())
    assert all(t.dtype == torch.float32
               for st in state["optimizer"]["state"].values()
               for k, t in st.items() if k != "step")


def test_hard_aug_matches_jax():
    assert SB.hard_aug() == A.AugmentConfig(
        **{f: getattr(JSB.hard_aug(), f)
           for f in A.AugmentConfig.__dataclass_fields__})


def test_train_object_checkpoint_resume_and_tracker(tmp_path):
    """train_object for 3 steps writes its checkpoint; a second call of the
    same recipe resumes at the end and takes no step; a Tracker built from
    the checkpoint tracks 3 frames with finite poses."""
    tm = M.make_cube(0.08)
    logs = []
    obj = SB.train_object(tm, K, name="cube", steps=3, batch=BATCH, res=RES,
                          ckpt_dir=str(tmp_path), ckpt_every=1,
                          log=logs.append, device="cpu")
    assert len(obj.losses) == 2 and np.isfinite(obj.losses).all()
    path = tmp_path / "cube_last.pt"
    assert ck.load_metadata(str(path))["step"] == 2
    again = SB.train_object(tm, K, name="cube", steps=3, batch=BATCH, res=RES,
                            ckpt_dir=str(tmp_path), log=logs.append,
                            device="cpu")
    assert any("resumed" in line for line in logs) and again.losses == []
    for k, v in obj.model.state_dict().items():
        assert torch.equal(v, again.model.state_dict()[k]), k

    info = {"resolution": RES, "object_width": obj.width_mm,
            "camera": {"focalX": 250.0, "focalY": 250.0, "centerX": 80.0,
                       "centerY": 60.0}}
    Kv = np.array([[250.0, 0, 80.0], [0, 250.0, 60.0], [0, 0, 1]], np.float32)
    gt = SB.make_gt_trajectory(4)
    rgb, depth = SB._quantize(*SB.render_test_video(
        rz.upload(tm, "cpu"), gt, Kv, hw=(120, 160)))
    t = trk.Tracker(info, obj.mean.numpy(), obj.std.numpy(),
                    ckpt_dir=str(path), mesh=tm, trans_normalizer=0.02,
                    rot_normalizer=15 * np.pi / 180, device="cpu")
    poses = t.track_video(gt[0], rgb[1:], depth[1:])
    assert poses.shape == (3, 4, 4) and np.isfinite(poses).all()
