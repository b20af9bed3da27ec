"""Host milliseconds a call of ``Tracker.on_track`` outside the wait for
the pose: the span ``tracker.on_track`` less its ``tracker.fetch`` child
(where the host waits for the card), over the traced calls."""
from portbench import spans


def read(ctx):
    rec = spans.recorded() or []
    roots = {i for i, s in enumerate(rec)
             if s["name"] == "tracker.on_track" and s["end_ns"] is not None}
    if not roots or not ctx["calls"]:
        return None
    ns = sum(rec[i]["end_ns"] - rec[i]["start_ns"] for i in roots)
    ns -= sum(s["end_ns"] - s["start_ns"] for s in rec
              if s["name"] == "tracker.fetch" and s["parent"] in roots
              and s["end_ns"] is not None)
    return ns / 1e6 / ctx["calls"]
