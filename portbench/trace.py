"""Reading a ``torch.profiler`` trace of one traced window: device busy
time as the union of the intervals in which a kernel, a copy or a memset
ran on the card (overlapping work counted once), device time by kernel,
and the idle gaps labelled by what the host was doing."""
from __future__ import annotations

import bisect
import contextlib
import re

import torch

WINDOW_SPAN = "portbench.window"
# Kernels of the network's libraries (cuDNN convolutions, cuBLAS/CUTLASS
# GEMMs, BatchNorm, and the tensor-layout conversions cuDNN inserts).
CNN_KERNEL = re.compile(
    r"conv|cudnn|xmma|implicit_gemm|gemm|cutlass|nchw|nhwc|batch_norm|"
    r"batchnorm|bn_fw|bn_bw|wgrad|dgrad|winograd|fft", re.IGNORECASE)
K1_KERNEL = re.compile(r"raster_pass1_kernel")
PASS2_KERNEL = re.compile(r"pass2_shade_kernel")
# Idle gaps shorter than this are the card waiting between back-to-back
# launches, counted together rather than labelled one by one.
SHORT_GAP_NS = 10_000
SHORT_GAP = "gaps under 10 us between device operations"
# The profiler's own bookkeeping, which is no work of the program's.
PROFILER_OWN = ("Activity Buffer Request",)


def _ns(e, which):
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{which}_us")() * 1000)


def _end_ns(e):
    f = getattr(e, "end_ns", None)
    if f is not None:
        return int(f())
    return _ns(e, "start") + int(e.duration_us() * 1000)


@contextlib.contextmanager
def traced():
    """Profile CPU and CUDA activity; the traced work runs inside the
    ``portbench.window`` span (:func:`window_span`)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        yield prof
    if cuda:
        torch.cuda.synchronize()


def window_span():
    return torch.profiler.record_function(WINDOW_SPAN)


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(prof, top: int = 10) -> dict:
    """The window's device activity: busy and window seconds, seconds by
    device operation name (with counts), the top device operations and the
    idle gaps summed by the host operation under each."""
    events = prof.profiler.kineto_results.events()
    dev, cpu, window = [], [], None
    for e in events:
        s, t = _ns(e, "start"), _end_ns(e)
        if e.name() in PROFILER_OWN:
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the card's copy of a host annotation spans work, it is none
            if e.name() != WINDOW_SPAN and "annotation" not in str(
                    getattr(e, "activity_type", lambda: "")()):
                dev.append((e.name(), s, t))
        else:
            if e.name() == WINDOW_SPAN:
                window = (s, t)
            cpu.append((e.name(), s, t))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0, w1 = window
    dev = [(n, max(s, w0), min(t, w1)) for n, s, t in dev if t > w0 and s < w1]
    busy = merge([(s, t) for _, s, t in dev])
    by_name = {}
    for n, s, t in dev:
        tot, cnt = by_name.get(n, (0, 0))
        by_name[n] = (tot + (t - s), cnt + 1)
    gaps, at = [], w0
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if at < w1:
        gaps.append((at, w1))
    inner = sorted((s, t, n) for n, s, t in cpu if n != WINDOW_SPAN)
    starts = [c[0] for c in inner]
    idle = {}
    for s, t in gaps:
        if t - s < SHORT_GAP_NS:
            label = SHORT_GAP
        else:
            mid = (s + t) // 2
            label = "host"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4096, -1), -1):  # innermost first
                if inner[j][1] > mid:
                    label = inner[j][2]
                    break
        idle[label] = idle.get(label, 0) + (t - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(t - s for s, t in busy) / 1e9,
        "by_name": {n: (tot / 1e9, cnt) for n, (tot, cnt) in by_name.items()},
        "device_ops": [[n, tot / 1e9] for n, (tot, _) in ops[:top]],
        "idle_gaps": [[n, v / 1e9] for n, v in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
    }


def seconds_of(summary, pattern=None, exclude=()) -> tuple[float, int]:
    """Device seconds and launches of the operations whose name matches
    ``pattern`` (all when None) and none of ``exclude``."""
    tot, cnt = 0.0, 0
    for name, (s, c) in summary["by_name"].items():
        if pattern is not None and not pattern.search(name):
            continue
        if any(x.search(name) for x in exclude):
            continue
        tot, cnt = tot + s, cnt + c
    return tot, cnt


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")
