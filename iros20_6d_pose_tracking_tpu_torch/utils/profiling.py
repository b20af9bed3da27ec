"""Profiling and observability hooks, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/utils/profiling.py``:

  - :class:`StepTimer`: steady-state time of a device computation. CUDA
    calls return before the card has run them, so every timed call ends
    with ``torch.cuda.synchronize`` of the devices its result lives on.
  - :func:`trace`: a context manager around ``torch.profiler`` that writes
    a TensorBoard-readable trace directory.
  - :class:`MetricsLogger`: an append-only JSONL metrics file (step, loss,
    Hz, ...), usable as the trainer's ``log_fn``.

Spans and counters inside the port (no JAX counterpart: XLA's profiler
sees inside one program, the port's host runs Python between launches):

  - :func:`span`: a named interval of the host, optionally with a pair of
    CUDA events on the current stream (``device=True``). Recording is on
    inside :func:`recording` and while a ``torch.profiler`` runs; else
    ``span`` returns one shared no-op object and records nothing. A span
    records its name, start and end in ns on the profiler's clock, its
    parent (a stack per thread), a request id (given, or the parent's),
    its thread and the counts added to it. Under a profiler it is also
    entered as a host event of its name (``_RecordFunctionFast``), so the
    trace names host time, and the card's idle gaps, by the innermost
    span. ``record_function`` is not used: its ranges are mirrored onto
    the card's timeline as annotations that cover the device work they
    enclose, which a reading of device time would count as work. Nothing
    is recorded while the current stream captures a CUDA graph (the spans
    inside a captured body, such as the refiner's, record in eager runs).
  - :func:`spans`: the recorded spans, oldest first, with each one's
    self time and device milliseconds; :func:`reset` drops them.
  - :func:`count` and :func:`counters`: one registry of integer counters,
    always on. :func:`count` also adds to the innermost recording span of
    its thread, under the counter's last dotted part. Counts kept
    elsewhere (the kernel wrappers' ``launches``, the compiled programs'
    calls) are read into :func:`counters` by the functions given to
    :func:`register`.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
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


_autograd_profiler = torch.autograd.profiler
_ProfilerEvent = torch._C._profiler._RecordFunctionFast
_lock = threading.Lock()
_local = threading.local()
_recording = 0         # depth of the open recording() blocks
_records: list = []    # every span recorded, in the order they started
_counts: dict = {}     # name -> int, the registry's own counters
_readers: dict = {}    # name -> function reading a count kept elsewhere


def _clock_offset() -> int:
    """ns to add to ``time.perf_counter_ns()`` to read the profiler's clock
    (Unix-epoch ns): ``time.time_ns()`` read between the closest of a few
    pairs of ``perf_counter_ns`` readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


_offset = _clock_offset()


def _now_ns() -> int:
    """Now, in ns on the profiler's clock."""
    return time.perf_counter_ns() + _offset


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _NoSpan:
    """What :func:`span` returns while nothing is recorded."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, key: str, n: int) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "request", "parent", "thread", "start_ns", "end_ns",
                 "counts", "_events", "_rf")

    def __init__(self, name: str, device: bool, request):
        self.name = name
        self.request = request
        self.counts = {}
        self.end_ns = None
        self._events = None
        if device and torch.cuda.is_available():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
        self._rf = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.request is None and self.parent is not None:
            self.request = self.parent.request
        self.thread = threading.get_ident()
        if _autograd_profiler._is_profiler_enabled:
            self._rf = _ProfilerEvent(self.name)
            self._rf.__enter__()
        if self._events is not None:
            self._events[0].record()
        stack.append(self)
        _records.append(self)
        self.start_ns = _now_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = _now_ns()
        if self._events is not None:
            self._events[1].record()
        _stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False

    def add(self, key: str, n: int) -> None:
        """Add ``n`` to this span's count ``key`` (bytes, items, ...)."""
        self.counts[key] = self.counts.get(key, 0) + int(n)


def span(name: str, device: bool = False, request=None):
    """A context manager around one stage of the program (see the module's
    docstring). ``request``: the id of the work it serves (a frame count,
    a pass, a step), by default its parent's. ``device=True`` also times
    the block on the current CUDA stream (host times only on the CPU)."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _NO_SPAN
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return _NO_SPAN  # a CUDA graph's capture: its body runs no Python
    return _Span(name, device, request)


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    global _recording, _offset
    with _lock:
        if not _recording:
            _offset = _clock_offset()
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans() -> list:
    """The recorded spans, in the order they started, as dicts: ``name``,
    ``start_ns`` and ``end_ns`` (None while open) on the profiler's clock,
    ``parent`` (an index into the list, or None), ``request``, ``thread``,
    ``counts``, ``self_ns`` (the duration less its children's) and
    ``device_ms`` (the CUDA events' interval of a device span, else
    None). Waits for the card to reach each device span's end."""
    recs = list(_records)
    index = {id(r): i for i, r in enumerate(recs)}
    out = []
    for r in recs:
        dur = None if r.end_ns is None else r.end_ns - r.start_ns
        device_ms = None
        if r._events is not None and r.end_ns is not None:
            r._events[1].synchronize()
            device_ms = r._events[0].elapsed_time(r._events[1])
        parent = None if r.parent is None else index.get(id(r.parent))
        out.append({"name": r.name, "start_ns": r.start_ns,
                    "end_ns": r.end_ns, "parent": parent,
                    "request": r.request, "thread": r.thread,
                    "counts": dict(r.counts), "self_ns": dur,
                    "device_ms": device_ms})
    for s in out:
        p = s["parent"]
        if p is not None and s["end_ns"] is not None and \
                out[p]["self_ns"] is not None:
            out[p]["self_ns"] -= s["end_ns"] - s["start_ns"]
    return out


def reset() -> None:
    """Drop the recorded spans (counters are never reset: compare two
    snapshots of :func:`counters`)."""
    _records.clear()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, and to the innermost recording
    span of this thread under ``name``'s last dotted part."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n
    if _recording or _autograd_profiler._is_profiler_enabled:
        stack = getattr(_local, "stack", None)
        if stack:
            stack[-1].add(name.rpartition(".")[2], n)


def register(name: str, read) -> None:
    """Have :func:`counters` report ``read()`` as the counter ``name``."""
    _readers[name] = read


def counters() -> dict:
    """A snapshot of every counter, by name."""
    with _lock:
        out = dict(_counts)
    for name, read in _readers.items():
        out[name] = int(read())
    return out
