"""The refiner's cell (``fpr-bf16-video``) on the CPU at a small size
(``tiny_refiner.py``): the frozen counts, the weights' layout against the
port's module, the judgement passing untraced and traced, each planted
fault (a step that returns its state, an altered answer, one round where
there are two) and the fp8 control read against it, the reference loading
nothing of the program, and a program without the refiner failing at
once. On the card: the control fails where the program passes, at the
cell's own size."""
import importlib
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from iros20_6d_pose_tracking_tpu_torch.core import se3
from portbench import check, config, counts_refiner, refiner_weights, run
from portbench.reference import refiner
from portbench.tests.test_portbench_faults import _altered, _unchanged
from portbench.tests.tiny_refiner import tiny_configs

CPU = torch.device("cpu")
CELL = "fpr-bf16-video"


def test_forward_flops_frozen_at_160():
    p, b = refiner_weights.make_weights({"weights": {"head_scale": 0.05}}, 1,
                                        CPU)
    x = torch.zeros(1, 160, 160, 6)
    with FlopCounterMode(display=False) as fc:
        refiner.forward(p, b, x, x)
    assert counts_refiner.forward_flops(160) == \
        counts_refiner.FORWARD_FLOPS_160 == fc.get_total_flops()
    assert round(counts_refiner.FORWARD_FLOPS_160 / 1e9, 2) == 23.95


def test_weights_fit_the_port_module():
    from iros20_6d_pose_tracking_tpu_torch.models import refinenet

    p, b = refiner_weights.make_weights({"weights": {"head_scale": 0.05}}, 2,
                                        CPU)
    with torch.device("meta"):
        net = refinenet.RefineNet()
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()
            if not k.endswith(("num_batches_tracked", "pos_embed.pe"))}
    assert {k: tuple(v.shape) for k, v in {**p, **b}.items()} == want
    assert sum(v.numel() for v in p.values()) == 16_830_406
    assert float(p["rot_head.1.weight"].abs().max()) <= 0.05 / 512 ** 0.5
    assert float(p["rot_head.1.bias"].abs().max()) == 0.0
    assert float(p["trans_head.0.norm1.weight"].min()) == 1.0
    w = p["encodeA.0.net.0.weight"]
    assert 0.9 < float(w.abs().max()) * (6 * 49) ** 0.5 <= 1.0


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_is_correct_at_a_small_size(trace):
    bench = config.benchmark()
    with tiny_configs():
        res, numbers = run.execute(CELL, 2 ** 33 + 11 + trace, 0.3,
                                   bool(trace), CPU, bench)
    assert res["correct"], numbers
    assert res["attempted"] > 0
    if trace:
        # on the CPU no device operation is traced: of the device readers
        # only the idle share reads (100%), and the share of the peak from
        # the counted rounds
        want = {m["name"] for m in run.cell_metrics(bench, CELL,
                                                     "per_layer")}
        assert {"device_idle.fpr_video", "mfu.fpr_video"} <= set(
            res["metrics"]) <= want


def _one_round(monkeypatch):
    from iros20_6d_pose_tracking_tpu_torch.models import refinenet

    monkeypatch.setattr(refinenet.RefineNet, "refine_iterations", 1)


@pytest.mark.parametrize("fault", ["unchanged", "altered", "one_round"])
def test_refiner_fault_is_caught(fault, monkeypatch):
    if fault == "one_round":
        _one_round(monkeypatch)
    else:
        decode = se3.decode_delta
        monkeypatch.setattr(se3, "decode_delta", {
            "unchanged": _unchanged, "altered": _altered(decode)}[fault])
    with tiny_configs():
        res, numbers = run.execute(CELL, 3, 0.2, False, CPU)
    assert not res["correct"], numbers


@pytest.mark.parametrize("planted", ["fp8", "one_round"])
def test_refiner_control_reads_above_the_program(planted):
    wl = config.workload(CELL)
    traffic = importlib.import_module("portbench.traffic.refiner_video")
    with tiny_configs():
        s = traffic.setup("foundationpose-refiner160-ycbv-bf16", wl["params"],
                         5, CPU)
        traffic.measure(s, 0.2)
        traffic.close(s)
        prog = traffic.readings(s)
        ctrl = traffic.readings(s, **({"precision": "fp8"} if planted == "fp8"
                                     else {"one_round": True}))
    assert max(ctrl[k] / max(prog[k], 1e-12) for k in ctrl) >= 3.0, (prog,
                                                                       ctrl)


def test_reference_loads_nothing_of_the_program():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = ("import json, sys, portbench.reference.refiner; print(json.dumps("
            "sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=config.ROOT,
                         env=env, capture_output=True, text=True, timeout=600,
                         check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "iros20_6d_pose_tracking_tpu",
                         "iros20_6d_pose_tracking_tpu_torch"}


def test_a_program_without_the_refiner_fails_at_once(monkeypatch):
    """The parent commit's port has no ``models/refinenet``: the cell
    raises in set-up, before any frame."""
    from iros20_6d_pose_tracking_tpu_torch import models

    monkeypatch.delattr(models, "refinenet", raising=False)
    monkeypatch.setitem(sys.modules,
                        "iros20_6d_pose_tracking_tpu_torch.models.refinenet",
                        None)
    with tiny_configs(), pytest.raises(ImportError):
        run.execute(CELL, 3, 0.2, False, CPU)


@pytest.mark.card
def test_control_fails_where_the_program_passes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    wl = config.workload(CELL)
    traffic = importlib.import_module("portbench.traffic.refiner_video")
    limits = wl["params"]["limits"]
    for seed in (2 ** 31 + 3, 2 ** 31 + 5):
        s = traffic.setup("foundationpose-refiner160-ycbv-bf16", wl["params"],
                         seed, torch.device("cuda", 0))
        traffic.measure(s, 1.0)
        traffic.close(s)
        prog = traffic.readings(s)
        ctrl = traffic.readings(s, precision="fp8")
        assert check.verdict([(k, prog[k], limits[k]) for k in limits]), prog
        assert not check.verdict([(k, ctrl[k], limits[k]) for k in limits]
                                 ), ctrl
        del s
        torch.cuda.empty_cache()
