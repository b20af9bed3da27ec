"""``accuracy_f17.py``, the cube's severity sweep over training seeds and
initialization draws, at a toy size on the CPU: its rows, and the verdict
of its rule."""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import accuracy_f17 as F  # noqa: E402

torch.set_num_threads(2)


def test_rows_of_a_toy_run(tmp_path):
    """One seed, 2 train steps at batch 4, 3 frames: six initializations
    at each of x2, x3 and x4, JAX's first (its saved key), each with finite
    scores; the JSON carries JAX's record and the verdict."""
    out = tmp_path / "f17.json"
    assert F.main(["--seeds", "0", "--steps", "2", "--batch", "4",
                   "--frames", "3", "--device", "cpu", "--out",
                   str(out)]) == 0
    res = json.loads(out.read_text())
    rows = res["rows"]
    assert len(rows) == 3 * 6
    assert [r["init"] for r in rows[:6]] == ["jax", "port"] + [
        f"port_j{j}" for j in range(1, 5)]
    assert [r["init_seed"] for r in rows if r["severity"] == 3.0] == [
        1000, 1000, 11000, 21000, 31000, 41000]
    assert all(np.isfinite([r[k] for k in F.KEYS]).all() for r in rows)
    assert res["jax_record"]["3.0"]["add_auc"] == pytest.approx(91.9854, 1e-4)
    assert res["summary"]["draw_dependence"] == (
        res["summary"]["seed0_jax_draw_within_rule"]
        or res["summary"]["jax_x3_inside_port_range"])
    assert res["train"][0]["seed"] == 0 and res["card"] == "cpu"


@pytest.mark.parametrize("k0,others,want", [
    (88.0, [40.0, 45.0], True),    # seed 0 from JAX's draw within 7 AUC
    (60.0, [40.0, 95.0], True),    # JAX's 91.99 inside the port's range
    (60.0, [40.0, 70.0], False),   # neither: F17 stays open
])
def test_verdict_rule(k0, others, want):
    record = {3.0: {"add_auc": 91.99}}
    rows = [{"seed": 0, "severity": 3.0, "init": "jax", "add_auc": k0}] + [
        {"seed": 1, "severity": 3.0, "init": "port", "add_auc": a}
        for a in others] + [
        {"seed": 0, "severity": 4.0, "init": "port", "add_auc": 99.0}]
    v = F.verdict(rows, record)
    assert v["draw_dependence"] is want
    assert v["port_x3_add_auc_max"] == max([k0] + others)
