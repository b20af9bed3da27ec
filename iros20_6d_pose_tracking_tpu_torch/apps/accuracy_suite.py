"""The multi-object synthetic accuracy table, on the port.

Counterpart of ``benchmarks/accuracy_suite.py`` (which stays the JAX
package's): for each object, DR training on the device, hard-video tracking
(a textured valid-depth background, a sweeping partial occluder, depth
dropout), ADD / ADD-S VOCap AUC; optionally the domain-shifted table, the
severity sweep, the single-axis ablation, the long-horizon protocol and its
forced-occlusion recovery, offline and live
(``eval/synthetic_benchmark.run_suite``). Writes a JSON table (and
``<out>.partial`` after every object) and prints a markdown summary:

    python -m iros20_6d_pose_tracking_tpu_torch.apps.accuracy_suite \\
        --objects cube --steps 5000 --frames 120 --domain_shift \\
        --long_horizon 499 --shift_sweep 0.5,1,2,3,4 --sweep_objects cube \\
        --recovery cube --live_recovery cube --ablation cube \\
        --out accuracy_suite_results_torch.json

Everything runs on ``--device`` (default ``cuda``). ``--ensemble`` trains
the untextured objects at once as an object ensemble and tracks their
videos in one call (checkpointed to ``--ensemble_ckpt_dir``); each row's
``eval_path`` says how it was evaluated. A recovery row that did not
recover prints ``not recovered``.
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time

from ..eval import synthetic_benchmark as SB


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--objects", default="cube,box,lshape,icosahedron")
    p.add_argument("--steps", type=int, default=5_000)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--batch", type=int, default=200)
    p.add_argument("--res", type=int, default=176)
    p.add_argument("--clean", action="store_true",
                   help="clean test videos (no background/occluder)")
    p.add_argument("--ensemble", action="store_true",
                   help="train the untextured objects at once as one "
                        "object ensemble and track their videos in one "
                        "call (textured objects train and evaluate alone)")
    p.add_argument("--ensemble_ckpt_dir", default=None,
                   help="checkpoint directory: with --ensemble the whole "
                        "ensemble's state (ensemble_last.msgpack, resumed "
                        "by names, steps and recipe), else each object's "
                        "(resumed by name, steps, batch, res and recipe)")
    p.add_argument("--domain_shift", action="store_true",
                   help="also evaluate on domain-shifted videos: other "
                        "lighting than the tracker's render, photometric "
                        "drift, sensor-model depth, motion blur, noisy init "
                        "(eval/domain_shift.py)")
    p.add_argument("--long_horizon", type=int, default=0,
                   help="also run the closed-loop long-horizon protocol "
                        "(ReinitPolicy + noisy external re-init) over this "
                        "many frames on every object")
    p.add_argument("--shift_sweep", default="",
                   help="comma-separated severities (e.g. 0.5,1,2,4) of the "
                        "AUC-vs-severity sweep on the --sweep_objects "
                        "(textured objects add a texture-hostile row)")
    p.add_argument("--sweep_objects", default="cube,lshape,textured_box",
                   help="objects the severity sweep runs on")
    p.add_argument("--recovery", default="",
                   help="comma-separated objects that also run the "
                        "long-horizon protocol with a forced 15-frame "
                        "full-occlusion burst (needs --long_horizon)")
    p.add_argument("--live_recovery", default="",
                   help="comma-separated objects that run the forced burst "
                        "through the live path (StreamTracker + background "
                        "ReinitPolicy + on_track_lost; needs --long_horizon)")
    p.add_argument("--ablation", default="",
                   help="comma-separated objects that run the x2 "
                        "single-axis domain-shift ablation")
    p.add_argument("--out", default="accuracy_suite_results_torch.json")
    p.add_argument("--stall_timeout_s", type=float, default=2700.0,
                   help="exit 3 if no progress line for this long; a rerun "
                        "with the same --ensemble_ckpt_dir resumes")
    p.add_argument("--device", default="cuda")
    return p


def _csv(s: str) -> tuple:
    return tuple(x for x in s.split(",") if x)


def print_summary(payload: dict, domain_shift: bool) -> None:
    """The markdown table and the per-object extras of a suite payload."""
    results = payload["results"]
    hdr = "| object | ADD AUC | ADD-S AUC | mean err | hold-init err |"
    cols = 5
    if domain_shift:
        hdr += " shifted ADD | shifted ADD-S |"
        cols += 2
    print("\n" + hdr)
    print("|" + "---|" * cols)
    for r in results:
        sym_tag = " (sym)" if r.get("symmetric") else ""
        line = (f"| {r['name']}{sym_tag} | {r['add_auc']:.2f} "
                f"| {r['adi_auc']:.2f} | {r['add_mean_mm']:.1f} mm "
                f"| {r['baseline_add_mean_mm']:.1f} mm |")
        if domain_shift:
            ds = r["domain_shifted"]
            line += f" {ds['add_auc']:.2f} | {ds['adi_auc']:.2f} |"
        print(line)
    print(f"| **mean (asym)** | **{payload['mean_add_auc']:.2f}** "
        f"| **{payload['mean_adi_auc']:.2f}** |" + " |" * (cols - 3))
    if any(r.get("long_horizon") for r in results):
        print("\nlong-horizon (per object):")
        for r in results:
            lh = r.get("long_horizon")
            if lh:
                print(f"  {r['name']}: {lh['frames']} frames, ADD AUC "
                    f"{lh['add_auc']:.2f} ADD-S {lh['adi_auc']:.2f}, "
                    f"{lh['reinit_count']} reinits at {lh['reinit_frames']}")
    for r in results:
        rc = r.get("recovery")
        if rc:
            print(f"\nrecovery [{r['name']}]: occlusion burst @{rc['fail_at']}"
                f"+{rc['fail_len']} -> detected in {rc['detection_latency']} "
                f"frames, recovered at {rc['recovered_at']}, "
                f"{SB.recovery_auc_text(rc)} (whole-run {rc['add_auc']:.2f}), "
                f"reinits {rc['reinit_frames']}")
    for r in results:
        lv = r.get("live_recovery")
        if lv:
            print(f"\nLIVE recovery [{r['name']}]: burst @{lv['fail_at']}"
                f"+{lv['fail_len']} -> detected in {lv['detection_latency']} "
                f"frames (policy sees 1 health sample per "
                f"{lv['refetch_every']}-frame refetch, patience "
                f"{lv['patience']}), reinit applied at "
                f"{lv['reinit_applied_at']}, {SB.recovery_auc_text(lv)}")
    for r in results:
        sw = r.get("shift_sweep")
        if sw:
            pts = ", ".join(f"x{p['severity']}={p['add_auc']:.1f}"
                            for p in sw)
            print(f"shift sweep [{r['name']}] ADD AUC: {pts}")
    for r in results:
        ab = r.get("shift_ablation")
        if ab:
            pts = ", ".join(f"{p['axis']}={p['add_auc']:.1f}" for p in ab)
            print(f"shift ablation x2 [{r['name']}] ADD AUC: {pts}")


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    def checkpoint_results(partial):
        # persist after every object: a failure late in a long run must not
        # discard finished rows
        with open(args.out + ".partial", "w") as f:
            json.dump(partial, f, indent=2)

    # Stall watchdog: every progress line refreshes a timestamp; if nothing
    # logs for --stall_timeout_s the process exits 3 (a rerun with the same
    # --ensemble_ckpt_dir resumes from the last checkpoint).
    last = [time.time()]
    done = threading.Event()

    def log(*a):
        last[0] = time.time()
        print(*a, flush=True)

    def watchdog():
        while not done.wait(min(30.0, args.stall_timeout_s)):
            idle = time.time() - last[0]
            if idle > args.stall_timeout_s:
                print(f"WATCHDOG: no progress for {idle:.0f}s (> "
                      f"--stall_timeout_s {args.stall_timeout_s}); exiting. "
                      "Rerun with the same --ensemble_ckpt_dir to resume.",
                      flush=True)
                os._exit(3)

    threading.Thread(target=watchdog, daemon=True).start()
    t0 = time.time()
    try:
        results = SB.run_suite(
            _csv(args.objects), steps=args.steps, frames=args.frames,
            batch=args.batch, res=args.res, hard=not args.clean,
            on_result=checkpoint_results, ensemble=args.ensemble,
            ensemble_ckpt_dir=args.ensemble_ckpt_dir,
            domain_shift=args.domain_shift,
            long_horizon_frames=args.long_horizon,
            shift_sweep=tuple(float(s) for s in _csv(args.shift_sweep)),
            sweep_objects=_csv(args.sweep_objects),
            recovery_objects=_csv(args.recovery),
            live_recovery_objects=_csv(args.live_recovery),
            ablation_objects=_csv(args.ablation),
            log=log, device=args.device)
    finally:
        done.set()
    # mean AUCs over asymmetric objects (ADD well-posed); symmetric rows are
    # scored by ADD-S and reported apart
    asym = [r for r in results if not r.get("symmetric")]
    sym = [r for r in results if r.get("symmetric")]
    payload = {
        "protocol": "VOCap AUC @0.1m (reference eval_ycb.py:45-64), "
                    "synthetic hard videos" if not args.clean else
                    "VOCap AUC @0.1m, synthetic clean videos",
        "steps": args.steps,
        "frames": args.frames,
        "ensemble_training": bool(args.ensemble),
        "device": args.device,
        "suite_wall_secs": round(time.time() - t0, 1),
        "results": results,
        "mean_add_auc": float(
            sum(r["add_auc"] for r in asym) / max(len(asym), 1)),
        "mean_adi_auc": float(
            sum(r["adi_auc"] for r in asym) / max(len(asym), 1)),
    }
    if sym:
        payload["mean_adi_auc_symmetric"] = float(
            sum(r["adi_auc"] for r in sym) / len(sym))
    if args.domain_shift:
        payload["mean_add_auc_domain_shifted"] = float(
            sum(r["domain_shifted"]["add_auc"] for r in asym)
            / max(len(asym), 1))
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print_summary(payload, args.domain_shift)
    print(f"\nwrote {args.out} ({payload['suite_wall_secs']:.0f}s)")
    return payload


if __name__ == "__main__":
    main()
