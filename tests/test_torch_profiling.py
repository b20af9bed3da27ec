"""``utils/profiling.py`` of the port against the JAX module's contracts:
``StepTimer`` returns JAX's keys, ``MetricsLogger`` writes JAX's JSONL lines
for the same keyword arguments and serves as a trainer's ``log_fn``, and
``trace`` writes a non-empty trace directory (on the CPU here)."""
import json
import os

import numpy as np
import torch

from iros20_6d_pose_tracking_tpu.utils import profiling as jprof
from iros20_6d_pose_tracking_tpu_torch.utils import profiling as prof

torch.set_num_threads(2)


def test_step_timer_returns_jax_keys():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x @ x, "n": [x.sum()]}

    x = torch.from_numpy(np.random.RandomState(0).rand(64, 64)
                         .astype(np.float32))
    out = prof.StepTimer(warmup=2, reps=3).measure(fn, x, iters_per_call=4)
    ref = jprof.StepTimer(warmup=1, reps=1).measure(lambda: np.zeros(2))
    assert sorted(out) == sorted(ref) == ["best_s", "hz", "mean_s",
                                          "per_iter_ms"]
    assert len(calls) == 5
    assert 0 < out["best_s"] <= out["mean_s"]
    np.testing.assert_allclose(out["per_iter_ms"], out["best_s"] / 4 * 1e3)
    np.testing.assert_allclose(out["hz"], 4 / out["best_s"])


def _lines(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        assert isinstance(r.pop("t"), float)
    return rows


def test_metrics_logger_writes_jax_lines(tmp_path, capsys):
    kw = [{"step": 3, "loss": 0.25, "hz": np.float32(61.5)},
          {"step": 4, "loss": float(torch.tensor(0.125)), "tag": "val"}]
    paths = {}
    for name, mod in (("port", prof), ("jax", jprof)):
        paths[name] = str(tmp_path / name / "metrics.jsonl")
        log = mod.MetricsLogger(paths[name])
        for k in kw:
            log.log(**k)
        log("epoch 1 done")  # the trainer's log_fn call
        log.close()
    out = capsys.readouterr().out.splitlines()
    assert out[:3] == out[3:] == ["step=3 loss=0.25 hz=61.5",
                                  "step=4 loss=0.125 tag=val",
                                  "msg=epoch 1 done"]
    assert _lines(paths["port"]) == _lines(paths["jax"])
    assert _lines(paths["port"])[2] == {"msg": "epoch 1 done"}
    # appends; echo off prints nothing; a given t is kept
    log = prof.MetricsLogger(paths["port"], echo=False)
    log.log(step=5, t=1.5)
    log.close()
    assert capsys.readouterr().out == ""
    with open(paths["port"]) as f:
        assert json.loads(f.readlines()[-1]) == {"step": 5, "t": 1.5}


def test_metrics_logger_as_trainer_log_fn(tmp_path):
    """A ``Trainer`` takes the logger as its ``log_fn``: the epoch line of a
    one-epoch loop on the synthetic sampler lands in the file as ``msg``."""
    from iros20_6d_pose_tracking_tpu_torch.data import dataset as D
    from iros20_6d_pose_tracking_tpu_torch.models import tracknet
    from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
    from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

    K = np.array([[300.0, 0, 64.0], [0, 300.0, 48.0], [0, 0, 1]], np.float32)
    synth = D.SyntheticPairs(rz.upload(M.make_cube(0.08), "cpu"), K,
                             resolution=32, object_width_mm=110.0)
    cfg = tr.TrainConfig(resolution=32, batch_size=2)

    def batches(seed):
        return lambda e: [synth.sample_batch(
            tr.step_generator("cpu", seed, e, i), 2) for i in range(2)]

    path = str(tmp_path / "train.jsonl")
    log = prof.MetricsLogger(path, echo=False)
    t = tr.Trainer(tracknet.create_model(32), cfg, str(tmp_path / "out"),
                   steps_per_epoch=2, mean=np.zeros(8),
                   std=np.full(8, 100.0), device="cpu")
    t.loop(1, batches(1), batches(2), log_fn=log)
    log.close()
    rows = _lines(path)
    assert len(rows) == 1 and rows[0]["msg"].startswith(">>> epoch 0: train=")


def test_trace_writes_a_trace_directory(tmp_path):
    logdir = str(tmp_path / "trace")
    x = torch.ones(32, 32)
    with prof.trace(logdir) as d:
        assert d == logdir
        for _ in range(3):
            x = x @ x / 32
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
