"""The port's counterparts of the three scripts in ``examples/``, as apps of
the port: the demo (``apps/demo_train_and_track.py``), the YCB-style
fixture (``apps/make_ycb_fixture.py``, against the JAX script's tree) and
the real-data dry run (``apps/realdata_dryrun.py``), on the CPU."""
import functools
import os
import re
import runpy
import sys

import jax
import numpy as np
import yaml
from PIL import Image

from iros20_6d_pose_tracking_tpu.render import rasterizer as JRz
from iros20_6d_pose_tracking_tpu_torch.apps import (demo_train_and_track,
                                                     make_ycb_fixture,
                                                     realdata_dryrun)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_demo_writes_its_curve_and_exits_by_its_bar(tmp_path, capsys):
    """A few steps and frames: ``add_per_frame.txt`` holds one ADD a frame
    (0 at frame 0, tracked from gt[0]), the metric lines and the ``DEMO``
    line are printed, and the exit code is the bar's verdict on the printed
    means (tracked under 0.25 of hold-init: 0, else 1)."""
    out = tmp_path / "demo"
    rc = demo_train_and_track.main(["--steps", "2", "--frames", "4",
                                    "--batch", "4", "--device", "cpu",
                                    "--outdir", str(out)])
    text = capsys.readouterr().out
    add = np.loadtxt(out / "add_per_frame.txt")
    assert add.shape == (4,) and add[0] == 0 and np.isfinite(add).all()
    tracked = float(re.search(r"tracked   ADD: mean=([\d.]+)mm", text)[1])
    held = float(re.search(r"hold-init ADD: mean=([\d.]+)mm", text)[1])
    np.testing.assert_allclose(tracked, add.mean() * 1000, atol=0.006)
    assert "final-frame translation err:" in text
    ok = tracked < 0.25 * held
    assert text.splitlines()[-1] == f"DEMO clean {'PASS' if ok else 'FAIL'}"
    assert rc == (0 if ok else 1)


def test_fixture_matches_jax_script(tmp_path, monkeypatch):
    """The port's tree against ``examples/make_ycb_fixture.py``'s, the JAX
    script run as tests/test_apps.py runs it but with its renders on JAX's
    Pallas path (interpret mode, op by op under ``jax.disable_jit``), the
    path the port follows (its default, the XLA sweep, breaks ties and
    forms depth otherwise). Depth PNGs equal, RGB within 1 level, poses
    within 1e-6, the same files, ``dataset_info.yml`` equal but for the
    root. Two frames: frame 0 sits face-on, with ties on pixel centres."""
    roots = {"jax": tmp_path / "j", "port": tmp_path / "p"}
    monkeypatch.setattr(JRz, "render", functools.partial(
        JRz.render, impl="pallas_interpret"))
    monkeypatch.setattr(sys, "argv", [
        "make_ycb_fixture.py", "--root", str(roots["jax"]), "--frames", "2"])
    with jax.disable_jit():
        runpy.run_path(os.path.join(REPO, "examples", "make_ycb_fixture.py"),
                       run_name="__main__")
    make_ycb_fixture.main(["--root", str(roots["port"]), "--frames", "2",
                           "--device", "cpu"])

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(roots["port"]) == files(roots["jax"])
    seq = "0048"
    for i in range(2):
        def png(kind, side):
            return np.asarray(Image.open(
                roots[side] / seq / kind / f"{i:06d}.png")).astype(np.int64)

        d = png("depth_filled", "port")
        assert (d > 0).sum() > 2000
        np.testing.assert_array_equal(d, png("depth_filled", "jax"))
        assert np.abs(png("color", "port") - png("color", "jax")).max() <= 1
        np.testing.assert_allclose(
            np.loadtxt(roots["port"] / seq / "pose_gt/4" / f"{i:06d}.txt"),
            np.loadtxt(roots["jax"] / seq / "pose_gt/4" / f"{i:06d}.txt"),
            atol=1e-6, rtol=0)
    for name in ("object.obj", "mean.npy", "std.npy"):
        assert (roots["port"] / name).read_bytes() == \
            (roots["jax"] / name).read_bytes(), name
    info = {side: (root / "dataset_info.yml").read_text().replace(
        str(root), "ROOT") for side, root in roots.items()}
    assert info["port"] == info["jax"]
    assert yaml.safe_load(info["port"])["resolution"] == 64


def test_realdata_dryrun_exits_zero(tmp_path, capsys):
    """The whole chain on three frames: zero-head predict runs hold the
    init, both scorers agree with the recomputed AUC, the 14,025 guard
    fires; no exception, no SystemExit."""
    realdata_dryrun.main(["--frames", "3", "--device", "cpu", "--root",
                          str(tmp_path / "dryrun")])
    text = capsys.readouterr().out
    for line in ("class 4: 3 predicted poses == init gt",
                 "class 7: 3 predicted poses == init gt",
                 "eval_all pooled over 63 keyframes",
                 "14,025-keyframe count assertion fires",
                 "eval_ycbineoat 5-object protocol",
                 "REAL-DATA PIPELINE INTACT"):
        assert line in text, line
