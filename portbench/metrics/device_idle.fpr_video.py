"""The reading of ``device_idle.video``: the share of the traced window in
which no kernel, copy or memset ran on the card."""
import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   "device_idle.video.py"))["read"]
