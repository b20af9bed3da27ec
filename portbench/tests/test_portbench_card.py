"""On the card, at each cell's own size: three seeds of a short run, whose
judgement passes, and the cell's control (the reference in the program's
place at the next precision down: TF32 for float32, fp8 for bf16), whose
judgement fails. Skips where there is no NVIDIA GPU."""
import importlib

import pytest
import torch

from portbench import check, config

CONTROLS = {"f32-video": "tf32", "bf16-video": "fp8", "f32-train": "tf32",
            "f32-ontrack": "tf32"}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CONTROLS))
def test_control_fails_where_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    bench = config.benchmark()
    conf = next(w["config"] for w in bench["workloads"] if w["name"] == cell)
    wl = config.workload(cell)
    driver = importlib.import_module(f"portbench.traffic.{wl['traffic']}")
    limits = wl["params"]["limits"]
    for seed in (2 ** 31 + 3, 2 ** 31 + 5, 2 ** 31 + 7):
        s = driver.setup(conf, wl["params"], seed, torch.device("cuda", 0))
        driver.measure(s, 1.0)
        driver.close(s)
        prog = driver.readings(s)
        ctrl = driver.readings(s, precision=CONTROLS[cell])
        assert check.verdict([(k, prog[k], limits[k]) for k in limits]), prog
        assert not check.verdict([(k, ctrl[k], limits[k]) for k in limits]
                                 ), ctrl
        del s
        torch.cuda.empty_cache()
