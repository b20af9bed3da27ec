"""The reference against the program at a small size on the CPU (the
program's kernels run their plain versions there): the render, the
network, and whole cells, whose judgement passes; and the lower-precision
controls read well above the program."""
import importlib

import pytest
import torch

from portbench import config, program, run, scene
from portbench.reference import cnn, render, track
from portbench.tests.tiny import shrink, tiny_configs

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def small():
    cfg0 = shrink(config._load("configs", "se3tracknet176-ycbv-f32"))
    mesh = scene.make_mesh(cfg0)
    with tiny_configs():
        cfg = config.configuration("se3tracknet176-ycbv-f32",
                                   mesh["diameter_m"])
    return cfg, mesh


def test_render_matches_the_program(small):
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    cfg, mesh = small
    K = torch.tensor(cfg["K"])
    poses = scene.trajectory(cfg, 3, 4, CPU)
    left, right, top, bottom = track.roi_bbox(poses, K, cfg["object_width_mm"])
    win = torch.stack([left, right, top, bottom], -1).float()
    res = (cfg["resolution"],) * 2
    rgb, depth, _ = render.render(scene.mesh_on(mesh, CPU), poses, K, win, res)
    m = program.mesh_arrays(mesh, CPU)
    for i in range(4):
        prgb, pdepth = rz.render(m, poses[i], K, win[i], res,
                                 cull_backfaces=True)
        # grazing faces' depth rounds differently in the two forms of the
        # interpolation (up to ~0.2 mm of ~650); a coverage flip is 100s
        off = ((prgb - rgb[i]).abs() > 0.5).any(-1) | (
            (pdepth - depth[i]).abs() > 0.5)
        assert float(off.float().mean()) < 1e-3
        assert float((pdepth > 0).float().mean()) > 0.3


@pytest.mark.parametrize("train", [False, True])
def test_network_matches_the_program(train):
    params, buffers = scene.make_weights({"weights": {"head_scale": 0.05}},
                                         7, CPU)
    cfg = {"resolution": 48, "dtype": "float32"}
    net = program.network(params, buffers, cfg, CPU)
    net.train(train)
    g = torch.Generator().manual_seed(0)
    A, B = (torch.randn(3, 48, 48, 4, generator=g) for _ in range(2))
    out = net(A, B)
    ref = cnn.forward(params, buffers, A, B, train=train)
    for k in ("trans", "rot"):
        assert torch.allclose(out[k], ref[k], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("cell", ["f32-video", "bf16-video", "f32-ontrack",
                                  "f32-train"])
def test_cell_is_correct_at_a_small_size(cell):
    with tiny_configs():
        res, numbers = run.execute(cell, 2 ** 33 + 11, 0.3, False, CPU)
    assert res["correct"], numbers
    assert res["attempted"] > 0


@pytest.mark.parametrize("cell,control", [("f32-video", "tf32"),
                                          ("bf16-video", "fp8"),
                                          ("f32-train", "tf32")])
def test_control_reads_above_the_program(cell, control):
    bench = config.benchmark()
    conf = next(w["config"] for w in bench["workloads"] if w["name"] == cell)
    wl = config.workload(cell)
    driver = importlib.import_module(f"portbench.traffic.{wl['traffic']}")
    with tiny_configs():
        s = driver.setup(conf, wl["params"], 5, CPU)
        driver.measure(s, 0.2)
        driver.close(s)
        prog = driver.readings(s)
        ctrl = driver.readings(s, precision=control)
    assert max(ctrl[k] / max(prog[k], 1e-12) for k in ctrl) >= 3.0, (prog,
                                                                       ctrl)


