"""A run with the timed path broken underneath: the harness's look for a
card is skipped (the run is driven on the CPU at a small size) and the
judgement must come out false, once for each fault a cell can have: a step
that returns its state unchanged, an answer altered where it is produced
(on every frame, and on one frame in five), and (training) half of the
batch left out, the mean taken over the rest, an optimizer that stops
stepping once the first steps are done, and the sampler's poses moved."""
import pytest
import torch

from iros20_6d_pose_tracking_tpu_torch.core import se3
from iros20_6d_pose_tracking_tpu_torch.data import dataset as DS
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from portbench import run
from portbench.tests.tiny import tiny_configs

CPU = torch.device("cpu")


def _unchanged(A_in_cam, trans, rot, tn, rn):
    return A_in_cam.clone()


def _altered(decode):
    def wrapped(A_in_cam, trans, rot, tn, rn):
        out = decode(A_in_cam, trans, rot, tn, rn).clone()
        out[..., 0, 3] += 1e-3          # 1 mm
        return out
    return wrapped


def _altered_some(decode, every=5):
    calls = [0]

    def wrapped(A_in_cam, trans, rot, tn, rn):
        calls[0] += 1
        out = decode(A_in_cam, trans, rot, tn, rn)
        return _altered(decode)(A_in_cam, trans, rot, tn, rn) \
            if calls[0] % every == 0 else out
    return wrapped


@pytest.mark.parametrize("cell", ["f32-video", "bf16-video", "f32-ontrack"])
@pytest.mark.parametrize("fault", ["unchanged", "altered", "altered_some"])
def test_tracking_fault_is_caught(cell, fault, monkeypatch):
    decode = se3.decode_delta
    planted = {"unchanged": _unchanged, "altered": _altered(decode),
               "altered_some": _altered_some(decode)}[fault]
    monkeypatch.setattr(se3, "decode_delta", planted)
    with tiny_configs():
        res, numbers = run.execute(cell, 3, 0.2, False, CPU)
    assert not res["correct"], numbers


def _half_loss(loss_fn):
    def wrapped(pt, pr, tt, tr, *a, **k):
        n = pt.shape[0] // 2
        return loss_fn(pt[:n], pr[:n], tt[:n], tr[:n], *a, **k)
    return wrapped


def _stops_after(step, n):
    calls = [0]

    def wrapped(self, closure=None):
        calls[0] += 1
        return step(self, closure) if calls[0] <= n else None
    return wrapped


def _moved_poses(sample_poses):
    def wrapped(*a, **k):
        A, B = sample_poses(*a, **k)
        A = A.clone()
        A[:, 0, 3] += 1e-3              # 1 mm
        return A, B
    return wrapped


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "stops_after_warmup", "moved_poses"])
def test_training_fault_is_caught(fault, monkeypatch):
    if fault == "moved_poses":
        monkeypatch.setattr(DS, "sample_poses", _moved_poses(DS.sample_poses))
    elif fault == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif fault == "stops_after_warmup":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            _stops_after(torch.optim.Adam.step, 3))
    else:
        monkeypatch.setattr(tracknet, "loss_fn", _half_loss(tracknet.loss_fn))
    with tiny_configs():
        res, numbers = run.execute("f32-train", 3, 0.2, False, CPU)
    assert not res["correct"], numbers
