"""The port's own spans (``utils/profiling.py`` of the port), read after a
traced window: every span recorded in the process, since the port records
spans only while a profiler runs or inside ``profiling.recording()``, and
set-up and the untraced window run with neither. A port without spans, or
a window that recorded none of the names asked for, gives None."""
from __future__ import annotations


def recorded():
    """The recorded spans (dicts, ``profiling.spans()``), or None."""
    try:
        from iros20_6d_pose_tracking_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return read() if read is not None else None


def closed(names) -> list:
    """The recorded spans named in ``names`` that have ended."""
    return [s for s in recorded() or ()
            if s["name"] in names and s["end_ns"] is not None]


def host_ms(names, per):
    """Host milliseconds of the spans named in ``names``, over ``per``
    (calls, frames or steps)."""
    sel = closed(names)
    if not sel or not per:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in sel) / 1e6 / per


def device_ms(names, per):
    """Milliseconds on the card's stream (the CUDA events of a device span)
    of the spans named in ``names``, over ``per``."""
    vals = [s["device_ms"] for s in closed(names)
            if s["device_ms"] is not None]
    if not vals or not per:
        return None
    return sum(vals) / per
