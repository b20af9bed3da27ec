"""The PyTorch port's pose-error metrics and scoring CLIs against the JAX
package, on the same numpy inputs made from a seed."""
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.core import se3 as jse3
from iros20_6d_pose_tracking_tpu.eval import eval_ycb as jycb
from iros20_6d_pose_tracking_tpu.eval import eval_ycbineoat as jineoat
from iros20_6d_pose_tracking_tpu.eval import metrics as JME
from iros20_6d_pose_tracking_tpu_torch.eval import eval_ycb, eval_ycbineoat
from iros20_6d_pose_tracking_tpu_torch.eval import metrics as ME

torch.set_num_threads(2)


def _rand_pose(rng, t_scale=0.1):
    T = np.eye(4)
    T[:3, :3] = np.asarray(jse3.so3_exp(jnp.asarray(rng.randn(3),
                                                    jnp.float32)))
    T[:3, 3] = rng.randn(3) * t_scale
    return T


def _poses(rng, n, noise=0.01):
    gts = np.stack([_rand_pose(rng) for _ in range(n)])
    preds = gts.copy()
    for p in preds:
        p[:3, :3] = np.asarray(jse3.so3_exp(jnp.asarray(
            rng.randn(3) * 0.2, jnp.float32))) @ p[:3, :3]
        p[:3, 3] += rng.randn(3) * noise
    return preds.astype(np.float32), gts.astype(np.float32)


def test_add_adi_match_jax():
    """One pose pair and a batch of 7: ADD and ADD-S within 1e-6 m of the
    JAX functions."""
    rng = np.random.RandomState(0)
    pts = (rng.randn(700, 3) * 0.05).astype(np.float32)
    preds, gts = _poses(rng, 7)
    for sl in (0, slice(None)):
        for ours, ref in ((ME.add_err, JME.add_err), (ME.adi_err, JME.adi_err)):
            got = ours(torch.from_numpy(preds[sl]), torch.from_numpy(gts[sl]),
                       torch.from_numpy(pts)).numpy()
            want = np.asarray(ref(jnp.asarray(preds[sl]),
                                  jnp.asarray(gts[sl]), jnp.asarray(pts)))
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_adi_chunking_does_not_change_the_minimum(monkeypatch):
    """ADD-S in chunks of a few gt points (and in one chunk) gives the same
    values: the minimum over pred points does not depend on the chunking."""
    rng = np.random.RandomState(1)
    pts = torch.from_numpy((rng.randn(300, 3) * 0.05).astype(np.float32))
    preds, gts = map(torch.from_numpy, _poses(rng, 5))
    whole = ME.adi_err(preds, gts, pts)
    monkeypatch.setattr(ME, "_ADI_CHUNK", 5 * 300 * 7)  # 7 rows per chunk
    assert torch.equal(ME.adi_err(preds, gts, pts), whole)


@pytest.mark.parametrize("chunk", [256, 4])
def test_batch_errors_match_jax(chunk):
    """(T, 4, 4) numpy poses in, ADD and ADD-S float32 numpy out, within
    1e-6 m of JAX's, whole and in frame chunks."""
    rng = np.random.RandomState(2)
    pts = rng.randn(500, 3) * 0.04
    preds, gts = _poses(rng, 11, noise=0.005)
    add, adi = ME.batch_errors(preds, gts, pts, chunk=chunk, device="cpu")
    add_j, adi_j = JME.batch_errors(preds, gts, pts, chunk=chunk)
    assert add.dtype == np.float32 and add.shape == (11,)
    np.testing.assert_allclose(add, add_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(adi, adi_j, atol=1e-6, rtol=0)
    assert (adi <= add + 1e-7).all()


def test_vocap_equals_jax():
    rng = np.random.RandomState(3)
    cases = [rng.rand(200) * 0.15, rng.rand(50) * 0.05, np.zeros(10),
             np.full(10, 0.5), np.array([]), [0.02, 0.04],
             np.repeat(rng.rand(20) * 0.1, 3)]
    for errs in cases:
        assert ME.vocap(errs) == JME.vocap(errs)
        assert ME.vocap(errs, max_val=0.05) == JME.vocap(errs, max_val=0.05)


def test_load_points_xyz_equals_jax(tmp_path):
    pts = np.random.RandomState(4).randn(30, 3)
    path = str(tmp_path / "points.xyz")
    np.savetxt(path, pts)
    np.testing.assert_array_equal(ME.load_points_xyz(path),
                                  JME.load_points_xyz(path))


def _write_pose(path, pose):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savetxt(path, pose)


@pytest.fixture()
def ycb_tree(tmp_path):
    """A one-class YCB tree with keyframe filtering, built as
    tests/test_eval.py builds it."""
    rng = np.random.RandomState(2)
    ycb = tmp_path / "ycb"
    pts = rng.randn(300, 3) * 0.04
    (ycb / "CADmodels" / "002_master_chef_can").mkdir(parents=True)
    np.savetxt(ycb / "CADmodels" / "002_master_chef_can" / "points.xyz", pts)
    (ycb / "YCB_Video_toolbox").mkdir()
    keyframes = []
    res = tmp_path / "res" / "seq0048"
    for i in range(6):
        frame = i + 1
        gt = _rand_pose(rng)
        _write_pose(str(ycb / "data_organized" / "0048" / "pose_gt" / "1"
                        / f"{frame:06d}.txt"), gt)
        pred = gt.copy()
        pred[:3, 3] += rng.randn(3) * 0.002
        _write_pose(str(res / f"{i:06d}.txt"), pred)
        _write_pose(str(res / f"{i:06d}gt.txt"), gt)
        if i % 2 == 0:
            keyframes.append(f"0048/{frame:06d}")
    with open(ycb / "YCB_Video_toolbox" / "keyframe.txt", "w") as f:
        f.write("\n".join(keyframes) + "\n")
    return str(tmp_path / "res"), str(ycb)


def test_eval_ycb_matches_jax(ycb_tree, capsys):
    res, ycb = ycb_tree
    adi, add = eval_ycb.eval_one_class(res, ycb, 1, device="cpu")
    adi_j, add_j = jycb.eval_one_class(res, ycb, 1)
    assert len(adi) == 3  # keyframes only
    np.testing.assert_allclose(add, add_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(adi, adi_j, atol=1e-6, rtol=0)
    assert ME.vocap(add) * 100 > 90
    capsys.readouterr()
    eval_ycb.main(["--ycb_dir", ycb, "--class_id", "1", "--res_dir", res,
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "002_master_chef_can" in out and "add:" in out and "adi:" in out


def test_eval_ycbineoat_matches_jax(tmp_path, capsys):
    rng = np.random.RandomState(3)
    ycb = tmp_path / "ycb"
    pts = rng.randn(200, 3) * 0.05
    (ycb / "CADmodels" / "006_mustard_bottle").mkdir(parents=True)
    np.savetxt(ycb / "CADmodels" / "006_mustard_bottle" / "points.xyz", pts)
    data, res = tmp_path / "data", tmp_path / "res"
    video = "mustard0_2020"
    for i in range(5):
        gt = _rand_pose(rng)
        _write_pose(str(data / video / "annotated_poses" / f"{i:06d}.txt"), gt)
        pred = gt.copy()
        pred[:3, 3] += rng.randn(3) * 0.001
        _write_pose(str(res / video / f"{i:06d}.txt"), pred)
    out = eval_ycbineoat.eval_all(str(res), str(data), str(ycb), device="cpu")
    ref = jineoat.eval_all(str(res), str(data), str(ycb))
    assert out.keys() == ref.keys() and out["overall"]["n"] == 5
    for key in out:
        for metric in ("add", "adi"):
            assert abs(out[key][metric] - ref[key][metric]) < 1e-3, key
    assert out["mustard"]["add"] > 90
    capsys.readouterr()
    eval_ycbineoat.main(["--YCBInEOAT_dir", str(data), "--ycb_dir", str(ycb),
                         "--res_dir", str(res), "--device", "cpu"])
    assert "Overall, adi=" in capsys.readouterr().out


@pytest.mark.parametrize("fn", [ME.batch_errors, eval_ycb.eval_one_class,
                                eval_ycb.eval_all, eval_ycbineoat.eval_all])
def test_scorers_default_to_the_card(fn):
    """The scorers run on ``cuda`` unless the caller asks for the CPU (read
    from the signature, nothing run)."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("cli", ["eval_ycb_one", "eval_ycb_all",
                                 "eval_ycbineoat"])
def test_scorer_clis_default_to_the_card(cli, monkeypatch):
    """Both CLIs pass ``device="cuda"`` without ``--device``: the scoring
    function is replaced by a recorder, so nothing is read or run."""
    seen = {}

    def record(*args, device):
        seen["device"] = device

    if cli == "eval_ycbineoat":
        monkeypatch.setattr(eval_ycbineoat, "eval_all", record)
        eval_ycbineoat.main(["--YCBInEOAT_dir", "d", "--ycb_dir", "y",
                             "--res_dir", "r"])
    elif cli == "eval_ycb_one":
        monkeypatch.setattr(eval_ycb, "eval_one_class", record)
        eval_ycb.main(["--ycb_dir", "y", "--class_id", "1", "--res_dir", "r"])
    else:
        monkeypatch.setattr(eval_ycb, "eval_all", record)
        eval_ycb.main(["--ycb_dir", "y", "--root", "r"])
    assert seen == {"device": "cuda"}
