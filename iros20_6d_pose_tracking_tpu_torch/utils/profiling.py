"""Profiling and observability hooks, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/utils/profiling.py``:

  - :class:`StepTimer`: steady-state time of a device computation. CUDA
    calls return before the card has run them, so every timed call ends
    with ``torch.cuda.synchronize`` of the devices its result lives on.
  - :func:`trace`: a context manager around ``torch.profiler`` that writes
    a TensorBoard-readable trace directory.
  - :class:`MetricsLogger`: an append-only JSONL metrics file (step, loss,
    Hz, ...), usable as the trainer's ``log_fn``.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch
from torch.utils._pytree import tree_leaves


def _wait_for(out) -> None:
    """Return once the card has run what produced ``out``: synchronize the
    CUDA devices of its tensor leaves, or the current CUDA device where it
    holds none (a function that only enqueues work)."""
    devices = {t.device for t in tree_leaves(out)
               if torch.is_tensor(t) and t.is_cuda}
    if not devices and torch.cuda.is_initialized():
        devices = {torch.device("cuda", torch.cuda.current_device())}
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    """Measure the steady-state per-iteration time of a device computation."""

    def __init__(self, warmup: int = 1, reps: int = 3):
        self.warmup = warmup
        self.reps = reps

    def measure(self, fn, *args, iters_per_call: int = 1) -> dict:
        """``fn(*args)`` -> a tensor (or a tree of them); returns the best
        and mean seconds of a call, and the best call's ms and Hz per
        iteration (``iters_per_call`` iterations a call)."""
        def run():
            out = fn(*args)
            _wait_for(out)
            return out

        for _ in range(self.warmup):
            run()
        times = []
        for _ in range(self.reps):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        per_iter = min(times) / iters_per_call
        return {
            "best_s": min(times),
            "mean_s": float(np.mean(times)),
            "per_iter_ms": per_iter * 1e3,
            "hz": 1.0 / per_iter,
        }


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (host activity, and the card's when
    CUDA is available), written to ``logdir`` by
    ``tensorboard_trace_handler`` when the block ends."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir


class MetricsLogger:
    """Append-only JSONL metrics file + stdout echo."""

    def __init__(self, path: str, echo: bool = True):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.echo = echo
        self._f = open(path, "a")

    def log(self, **kv):
        kv.setdefault("t", time.time())
        self._f.write(json.dumps(kv, default=float) + "\n")
        self._f.flush()
        if self.echo:
            print(" ".join(f"{k}={v}" for k, v in kv.items() if k != "t"),
                  flush=True)

    def __call__(self, msg):
        """Trainer ``log_fn`` compatibility (takes plain strings)."""
        self.log(msg=str(msg))

    def close(self):
        self._f.close()
