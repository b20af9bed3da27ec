"""What a run loads: no top-level ``jax``, ``jaxlib``, ``flax`` or the JAX
package (``iros20_6d_pose_tracking_tpu``, compared as a whole name, since
the port's name begins with it); and the reference loads nothing of the
program."""
import json
import os
import subprocess
import sys

from portbench import config

FORBIDDEN = {"jax", "jaxlib", "flax", "iros20_6d_pose_tracking_tpu"}

RUN_TINY = """
import json, sys, torch
from portbench.tests.tiny import tiny_configs
from portbench import run
with tiny_configs():
    res, nums = run.execute("f32-video", 5, 0.2, False, torch.device("cpu"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
import portbench.reference.cnn, portbench.reference.render
import portbench.reference.track, portbench.reference.train
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=config.ROOT,
                         env=env, capture_output=True, text=True, timeout=600,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _top_level(RUN_TINY)
    assert "iros20_6d_pose_tracking_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE)
    assert not loaded & (FORBIDDEN | {"iros20_6d_pose_tracking_tpu_torch"})
