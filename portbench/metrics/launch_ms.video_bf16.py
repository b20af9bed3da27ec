"""The reading of ``launch_ms.video``, in the bf16 video cell (whose
end-to-end rate is ``video_fps_bf16``)."""
import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   "launch_ms.video.py"))["read"]
