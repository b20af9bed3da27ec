"""The port's accuracy suite on the CPU: the severity sweep, the single-axis
ablation, ``run_suite`` end to end and its CLI (``apps/accuracy_suite.py``),
at a 48^2 ROI on 96x128 frames.

These mirror the JAX package's tests of the same functions
(``tests/test_synthetic_benchmark.py``, ``tests/test_domain_shift.py``);
the object ensemble's are in ``tests/test_torch_ensemble_suite.py``. The
port always renders full frames through K3 (here its plain version), so it
has no ``impl``.
"""
import functools
import json

import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu_torch.apps import accuracy_suite
from iros20_6d_pose_tracking_tpu_torch.eval import domain_shift as DS
from iros20_6d_pose_tracking_tpu_torch.eval import synthetic_benchmark as SB
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

torch.set_num_threads(2)

HW = (96, 128)
K = np.array([[200.0, 0, 64.0], [0, 200.0, 48.0], [0, 0, 1.0]], np.float32)
RES = 48


def _quiet(*a):
    pass


@pytest.fixture(scope="module")
def zero_head_cube():
    """A hold-pose tracker of the cube: Flax-initialised weights with the
    regression heads zeroed."""
    tm = M.make_cube(0.08)
    net = tracknet.init_params(tracknet.create_model(RES),
                               torch.Generator().manual_seed(0))
    with torch.no_grad():
        for head in (net.trans_out, net.rot_out):
            head[0].weight.zero_()
            head[0].bias.zero_()
    width = tm.diameter * 1000 * 1.1
    return SB.BenchObject(
        name="cube", tm=tm, mesh=rz.upload(tm, "cpu"), model=net.eval(),
        mean=torch.zeros(8), std=torch.full((8,), 100.0), width_mm=width,
        tcfg=trk.TrackerConfig(resolution=RES, object_width_mm=width))


def test_shift_severity_sweep_smoke(zero_head_cube):
    """Severity 0 is the matched domain: a hold-pose tracker on a static
    scene scores perfectly there (tests/test_synthetic_benchmark.py's
    sweep smoke test); the rows carry the sweep's keys."""
    pose0 = np.eye(4, dtype=np.float32)
    pose0[:3, 3] = [0.0, 0.0, 0.6]
    gt = np.tile(pose0[None], (3, 1, 1))
    rows = SB.shift_severity_sweep(zero_head_cube, gt, hard=False,
                                   severities=(0.0,), K=K, hw=HW, log=_quiet)
    assert len(rows) == 1 and rows[0]["severity"] == 0.0
    assert set(rows[0]) == {"severity", "add_auc", "adi_auc", "add_mean_mm",
                            "final_trans_err_mm"}
    assert rows[0]["add_auc"] > 99.0


def test_shift_axis_ablation_rows(zero_head_cube, monkeypatch):
    """Every axis row, anchored by 'none' and 'full', all finite
    (tests/test_domain_shift.py); only the lighting changes the render, so
    two videos are rendered for seven rows."""
    renders = []
    orig = SB.render_test_video
    monkeypatch.setattr(SB, "render_test_video", lambda *a, **kw: (
        renders.append(kw["lighting"]), orig(*a, **kw))[1])
    gt = SB.make_gt_trajectory(10)
    rows = SB.shift_axis_ablation(zero_head_cube, gt, severity=2.0,
                                  hard=False, K=K, hw=HW, log=_quiet)
    assert [r["axis"] for r in rows] == ["none", "lighting", "photometric",
                                         "blur", "depth", "init", "full"]
    for r in rows:
        assert np.isfinite(r["add_auc"]) and 0 <= r["add_auc"] <= 100
        assert r["severity"] == 2.0
    assert len(renders) == 2
    torch.testing.assert_close(renders[0], DS.SensorModel().scaled(0.0)
                               .lighting())
    torch.testing.assert_close(renders[1], DS.SensorModel().scaled(2.0)
                               .lighting())


def test_run_suite_with_textured_and_extras():
    """run_suite end to end at tiny scale on the CPU, sequential as always:
    a textured object, the domain-shifted table, the severity sweep (the
    textured object adds its texture-hostile row), the long horizon on every
    object, offline and live recovery on the cube, the ablation on the
    textured box (tests/test_synthetic_benchmark.py's suite test minus the
    ensemble). The bursts at frame 4 of 11 run to the end: no row recovers,
    each says so, and no log line carries nan."""
    lines = []
    results = SB.run_suite(
        ("cube", "textured_box"), steps=2, frames=8, batch=4, res=RES,
        hard=False, log=lambda *a: lines.append(" ".join(map(str, a))),
        domain_shift=True, long_horizon_frames=12, shift_sweep=(1.0,),
        sweep_objects=("textured_box",), recovery_objects=("cube",),
        live_recovery_objects=("cube",), ablation_objects=("textured_box",),
        K=K, hw=HW, device="cpu")
    assert [r["name"] for r in results] == ["cube", "textured_box"]
    for r in results:
        assert r["eval_path"] == "sequential"
        assert np.isfinite(r["add_auc"]) and len(r["add"]) == 8
        assert np.isfinite(r["domain_shifted"]["add_auc"])
        assert r["domain_shifted"]["eval_path"] == "sequential"
        assert r["long_horizon"]["frames"] == 11
        assert "poses" not in r
    sw = results[1]["shift_sweep"]
    assert [p["severity"] for p in sw] == [1.0, "tex_hostile"]
    assert "shift_sweep" not in results[0]
    rc = results[0]["recovery"]
    assert rc["fail_at"] == 4 and rc["reinit_count"] >= 0
    assert "detection_latency" in rc
    lv = results[0]["live_recovery"]
    assert lv["fail_at"] == 4 and "detection_latency" in lv
    assert "refetch_every" in lv
    for row in (rc, lv):
        assert row["recovered"] is False
        assert row["post_recovery_add_auc"] is None
    ab = results[1]["shift_ablation"]
    assert {row["axis"] for row in ab} == {"none", "full"} | set(SB.SHIFT_AXES)
    for row in ab:
        assert np.isfinite(row["add_auc"])
    assert any("not recovered" in line for line in lines)
    assert not any("nan" in line for line in lines)
    json.dumps(results)  # JSON-serializable


def test_run_suite_ensemble_raises_before_training(monkeypatch):
    """An unknown object raises before any training, in the ensemble mode
    too and from the CLI's ``--ensemble`` (the object ensemble itself runs:
    ``tests/test_torch_ensemble_suite.py``)."""
    def no_training(*a, **kw):
        raise AssertionError("trained before refusing the object")

    monkeypatch.setattr(SB, "train_object", no_training)
    monkeypatch.setattr(SB, "train_objects_ensemble", no_training)
    with pytest.raises(KeyError, match="nothing"):
        SB.run_suite(("cube", "nothing"), ensemble=True, device="cpu")
    with pytest.raises(KeyError, match="nothing"):
        SB.run_suite(("nothing",), ensemble=True, device="cpu")
    with pytest.raises(KeyError, match="nothing"):
        accuracy_suite.main(["--ensemble", "--objects", "cube,nothing",
                             "--device", "cpu"])


def test_accuracy_suite_cli_writes_json_and_partial(tmp_path, monkeypatch,
                                                    capsys):
    """The CLI on the CPU (run_suite at this file's frame size): the JSON
    payload with the JAX script's keys, the ``.partial`` file written after
    the object, and the summary with 'not recovered' where nothing
    recovered."""
    monkeypatch.setattr(SB, "run_suite",
                        functools.partial(SB.run_suite, K=K, hw=HW))
    out = tmp_path / "suite.json"
    payload = accuracy_suite.main([
        "--objects", "cube", "--steps", "1", "--frames", "4", "--batch", "2",
        "--res", str(RES), "--clean", "--domain_shift", "--long_horizon",
        "9", "--recovery", "cube", "--out", str(out), "--device", "cpu"])
    on_disk = json.loads(out.read_text())
    assert on_disk == json.loads(json.dumps(payload))
    assert {"protocol", "steps", "frames", "ensemble_training",
            "suite_wall_secs", "results", "mean_add_auc", "mean_adi_auc",
            "mean_add_auc_domain_shifted"} <= on_disk.keys()
    assert on_disk["protocol"].endswith("clean videos")
    partial = json.loads((tmp_path / "suite.json.partial").read_text())
    assert [r["name"] for r in partial] == ["cube"]
    text = capsys.readouterr().out
    assert "| cube |" in text and "not recovered" in text
    assert "nan" not in text
