"""The readings that a cell's limits are set from, on the card at the
cell's own size: for each seed, one process-internal run of the cell
(set-up and a short window at the cell's load), then the judged numbers of
the program, of each control (the reference in the program's place at a
lower precision) and of each planted fault, and for a tracking cell every
judged step's gap of the program and of each control. Not part of a
benchmark run.

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3
        --seconds 2 [--controls tf32] [--faults half_batch] --out <file>

Writes one JSON line a seed to ``--out`` and to standard output."""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import sys
import time

from portbench import config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--controls", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch

    device = torch.device("cuda", 0)
    bench = config.benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    wl = config.workload(args.workload)
    driver = importlib.import_module(f"portbench.traffic.{wl['traffic']}")
    with open(args.out, "a") as f:
        for seed in [int(x) for x in args.seeds.split(",")]:
            t0 = time.perf_counter()
            s = driver.setup(cell["config"], wl["params"], seed, device)
            driver.measure(s, args.seconds)
            driver.close(s)
            steps = {"with_steps": True} if "with_steps" in \
                inspect.signature(driver.readings).parameters else {}
            row = {"workload": args.workload, "seed": seed,
                   "program": driver.readings(s, **steps)}
            for c in filter(None, args.controls.split(",")):
                row[c] = driver.readings(s, precision=c, **steps)
            for fault in filter(None, args.faults.split(",")):
                row[fault] = driver.readings(s, **{fault: True})
            row["seconds"] = time.perf_counter() - t0
            del s
            torch.cuda.empty_cache()
            line = json.dumps(row)
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
