"""BENCHMARK.json against the benchmark's contract, and every cell's
configuration, traffic driver and metric readers found by name."""
import importlib
import json
import os
import re

import pytest

from portbench import config, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
DRIVER_API = ("setup", "measure", "traced", "close", "readings", "check",
              "layer_context")


@pytest.fixture(scope="module")
def bench():
    return config.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    assert len(bench["command"]) <= 32
    for word in bench["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_and_units(bench):
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind, e["name"]))
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    for w in bench["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_bounds_and_sources(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in run.cell_metrics(bench, w["name"],
                                                   "end_to_end")]
        layer = run.cell_metrics(bench, w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_cells_found_by_name(bench):
    cfgs = {c["name"]: c for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        c = cfgs[w["config"]]
        used.add(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert config.configuration(c["name"])["name"] == c["name"]
        wl = config.workload(w["name"])
        assert wl["traffic"] == w["traffic"]
        driver = importlib.import_module(f"portbench.traffic.{w['traffic']}")
        for fn in DRIVER_API:
            assert callable(getattr(driver, fn)), (w["traffic"], fn)
    assert used == set(cfgs)
    for m in bench["per_layer"]:
        assert callable(run.metric_module(m["name"]).read)


def test_files_under_paths_are_named_from_names(bench):
    allowed = re.compile(r"^[A-Za-z0-9_.\-/]+$")
    for root, dirs, files in os.walk(config.HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), config.ROOT)
            assert allowed.match(rel) and len(rel) <= 200, rel
