"""Run one cell of the benchmark and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell (``workloads/<name>.json``) names its configuration
(``configs/<config>.json``), its traffic driver (``traffic/<driver>.py``)
and the driver's parameters. Set-up (imports, the card, the inputs, the
program and its warm-up) is timed from the start of the process. With
``--trace 0`` the driver's measured window gives the cell's end-to-end
metrics; with ``--trace 1`` a profiled window gives its per-layer metrics,
each read by ``metrics/<metric>.py``. Then the program's state is freed
and the reference judges what the window produced. The last lines of
standard error give each number compared beside its limit; the last line
of standard output is the result as JSON.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from portbench import config  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "iros20_6d_pose_tracking_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs() -> None:
    """Kernel caches inside the checkout, at fixed paths (the port builds
    its CUDA kernels into its own ``_build/``)."""
    base = os.path.join(config.ROOT, ".cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(base, "torch_extensions"))


def metric_module(name: str):
    path = os.path.join(config.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that the cell
    reports: those that list it, or list no cells."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def device_info(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(name: str, seed: int, seconds: float, traced: bool, device,
            bench: dict | None = None):
    """Set-up, the window, the per-cell metrics and the judgement of one
    run on ``device``. Returns (result without ``compared``, numbers)."""
    import torch

    bench = bench or config.benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    wl = config.workload(name)
    driver = importlib.import_module(f"portbench.traffic.{wl['traffic']}")

    state = driver.setup(cell["config"], wl["params"], seed, device)
    sync(device)
    setup_s = time.perf_counter() - T_START
    out = driver.traced(state) if traced else driver.measure(state, seconds)
    sync(device)
    dev = device_info(torch, cell["chips"]) if device.type == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}

    metrics = {}
    if traced:
        ctx = driver.layer_context(state, out)
        summary = ctx["summary"]
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        for m in cell_metrics(bench, name, "per_layer"):
            v = metric_module(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        out["setup_s"] = setup_s
        for m in cell_metrics(bench, name, "end_to_end"):
            metrics[m["name"]] = {"value": out[m["name"]], "unit": m["unit"]}

    driver.close(state)
    numbers = driver.check(state)
    from portbench import check

    result = {"correct": check.verdict(numbers),
              "attempted": int(out.get("frames") or out.get("calls")
                               or out.get("steps")),
              "failed": 0, "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    return result, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()

    bench = config.benchmark()
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2

    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found {n}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, numbers = execute(args.workload, args.seed, args.seconds,
                              bool(args.trace), device, bench)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    from portbench import check

    result["power"] = power_limit()
    result["compared"] = check.report(numbers)
    for name, v, lim in numbers:
        print(f"compared {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
