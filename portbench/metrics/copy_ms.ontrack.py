"""Device milliseconds a call of the copies and memsets: the frame's
upload, the copy into the program's static slots and the pose's fetch."""
from portbench import trace


def read(ctx):
    s = ctx["summary"]
    sec = sum(v for name, (v, _) in s["by_name"].items()
              if trace.is_copy(name))
    return 1e3 * sec / ctx["calls"] if sec else None
