"""The accuracy suite's object ensemble on the CPU, at a 48^2 ROI on 96x128
clean frames (``eval/synthetic_benchmark.py``: ``train_objects_ensemble``,
``ensemble_evaluate_tracking``, ``run_suite(ensemble=True)``, and
``apps/accuracy_suite.py --ensemble``), in the manner of
``tests/test_torch_suite.py``:

  - untextured objects train as one ensemble and evaluate in one call
    (``eval_path`` "ensemble", the domain-shifted table too); a textured
    object trains and evaluates alone ("sequential");
  - the ensemble evaluation gives each object's ``evaluate_tracking`` row
    bit for bit (the objects' meshes pad to one face count here);
  - out of device memory, the evaluation falls back to the sequential path
    and says so ("sequential_fallback"); any other failure raises (the JAX
    suite catches every exception, ROADMAP F8);
  - an interrupted ensemble training resumes from ``ensemble_last.msgpack``
    to the uninterrupted run's bits.
"""
import functools
import json

import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu_torch.apps import accuracy_suite
from iros20_6d_pose_tracking_tpu_torch.eval import synthetic_benchmark as SB
from iros20_6d_pose_tracking_tpu_torch.parallel import spmd

torch.set_num_threads(2)

HW = (96, 128)
K = np.array([[200.0, 0, 64.0], [0, 200.0, 48.0], [0, 0, 1.0]], np.float32)
RES = 48
SUITE = dict(steps=2, frames=6, batch=2, res=RES, hard=False, K=K, hw=HW,
             device="cpu")


def _quiet(*a):
    pass


def test_run_suite_ensemble_rows():
    lines = []
    results = SB.run_suite(("cube", "textured_box", "box"), ensemble=True,
                           domain_shift=True,
                           log=lambda *a: lines.append(" ".join(map(str, a))),
                           **SUITE)
    assert [r["name"] for r in results] == ["cube", "textured_box", "box"]
    paths = [(r["eval_path"], r["domain_shifted"]["eval_path"])
             for r in results]
    assert paths == [("ensemble", "ensemble"), ("sequential", "sequential"),
                     ("ensemble", "ensemble")]
    for r in results:
        assert np.isfinite(r["add_auc"]) and len(r["add"]) == 6
        assert np.isfinite(r["domain_shifted"]["add_auc"])
        assert "poses" not in r
    assert any(line.startswith("[ensemble x2] step 1: cube=")
               for line in lines)
    json.dumps(results)


def test_ensemble_evaluation_is_each_objects_evaluate_tracking():
    objs = SB.train_objects_ensemble(["cube", "box"], K, steps=1, batch=2,
                                     res=RES, log=_quiet, device="cpu")
    gt = SB.make_gt_trajectory(5)
    vids = [SB._quantize(*SB.render_test_video(o.mesh, gt, K, hw=HW))
            for o in objs]
    rows = SB.ensemble_evaluate_tracking(
        objs, gt, np.stack([v[0] for v in vids]),
        np.stack([v[1] for v in vids]), K=K)
    for obj, vid, row in zip(objs, vids, rows):
        ref = SB.evaluate_tracking(obj, gt, *vid, K=K)
        np.testing.assert_array_equal(row["poses"], ref["poses"])
        assert row["add_auc"] == ref["add_auc"]


def test_run_suite_ensemble_falls_back_only_on_oom(monkeypatch):
    def oom(*a, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(SB, "ensemble_evaluate_tracking", oom)
    lines = []
    results = SB.run_suite(("cube", "box"), ensemble=True, domain_shift=True,
                           log=lambda *a: lines.append(" ".join(map(str, a))),
                           **SUITE)
    for r in results:
        assert r["eval_path"] == "sequential_fallback"
        assert r["domain_shifted"]["eval_path"] == "sequential_fallback"
    assert any("out of device memory" in line for line in lines)

    def broken(*a, **kw):
        raise RuntimeError("not an allocation failure")

    monkeypatch.setattr(SB, "ensemble_evaluate_tracking", broken)
    with pytest.raises(RuntimeError, match="not an allocation"):
        SB.run_suite(("cube",), ensemble=True, log=_quiet, **SUITE)


def test_train_objects_ensemble_resumes_bit_equal(tmp_path, monkeypatch):
    kw = dict(steps=4, batch=2, res=32, log=_quiet, ckpt_every=2,
              device="cpu")
    full = SB.train_objects_ensemble(["cube", "box"], K, **kw)
    real = spmd.ensemble_train_step

    def interrupted(*a, **k):
        step, calls = real(*a, **k), []

        def run(*args, **kwargs):
            if len(calls) == 3:  # after step 2's checkpoint
                raise KeyboardInterrupt
            calls.append(1)
            return step(*args, **kwargs)

        return run

    monkeypatch.setattr(spmd, "ensemble_train_step", interrupted)
    with pytest.raises(KeyboardInterrupt):
        SB.train_objects_ensemble(["cube", "box"], K, ckpt_dir=str(tmp_path),
                                  **kw)
    assert (tmp_path / "ensemble_last.msgpack").exists()
    meta = json.loads((tmp_path / "ensemble_last.msgpack.json").read_text())
    assert meta["step"] == 2 and meta["names"] == ["cube", "box"]
    monkeypatch.setattr(spmd, "ensemble_train_step", real)
    resumed = SB.train_objects_ensemble(["cube", "box"], K,
                                        ckpt_dir=str(tmp_path), **kw)
    for a, b in zip(full, resumed):
        for (k, v), w in zip(a.model.state_dict().items(),
                             b.model.state_dict().values()):
            assert torch.equal(v, w), k
        assert torch.equal(a.mean, b.mean) and torch.equal(a.std, b.std)
    # another recipe's checkpoint is not resumed
    lines = []
    SB.train_objects_ensemble(["cube", "box"], K, ckpt_dir=str(tmp_path),
                              **dict(kw, steps=3, log=lines.append))
    assert any("ignoring" in line for line in lines)


def test_accuracy_suite_cli_ensemble(tmp_path, monkeypatch):
    monkeypatch.setattr(SB, "run_suite",
                        functools.partial(SB.run_suite, K=K, hw=HW))
    out = tmp_path / "suite.json"
    payload = accuracy_suite.main([
        "--objects", "cube,box", "--steps", "2", "--frames", "4",
        "--batch", "2", "--res", str(RES), "--clean", "--ensemble",
        "--ensemble_ckpt_dir", str(tmp_path / "ckpt"), "--out", str(out),
        "--device", "cpu"])
    on_disk = json.loads(out.read_text())
    assert on_disk == json.loads(json.dumps(payload))
    assert on_disk["ensemble_training"] is True
    assert [r["eval_path"] for r in on_disk["results"]] == ["ensemble"] * 2
    assert (tmp_path / "ckpt" / "ensemble_last.msgpack").exists()
