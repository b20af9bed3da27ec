"""PyTorch / CUDA port of the se(3)-TrackNet tracker, for NVIDIA Hopper.

A second package beside ``iros20_6d_pose_tracking_tpu`` (the JAX package,
which stays the reference). Module names and the subpackage layout mirror
the JAX package, so the counterpart of ``<jax pkg>/render/rasterizer.py``
is ``<this pkg>/render/rasterizer.py``; each module's docstring names its
counterpart.

Rules of the port:
  - It imports ``torch`` and never ``jax``, and nothing of the JAX
    package: where it needs a numpy-only piece of it (the mesh module, the
    config helpers, the stream's host geometry, the native PNG decoder's
    C++ source) it keeps its own copy, which the tests hold equal.
  - Plain tensor code is PyTorch. Every Pallas kernel that the JAX package
    runs on the tracking step has a CUDA C++ kernel for ``sm_90a`` under
    ``csrc/``, built by nvcc at first use (``kernels/build.py``), with a
    plain PyTorch version beside its wrapper. The wrapper takes the plain
    version only for tensors on the CPU; a CUDA tensor launches the kernel
    or raises.
  - Every function takes its tensors on an explicit device; nothing moves
    data between devices behind the caller's back.

Subpackages:
  core      se(3)/so(3) maps, the pose codec, the camera
  ops       ROI bbox and crop-resize, depth offset and hole filling, image
            filters, point clouds
  render    rasterizer (projection, cull, pass 1, pass 2 shading) and the
            kernel wrappers with their plain versions (raster_kernels)
  models    Se3TrackNet as an nn.Module, weights carried from Flax
  tracking  the per-frame tracking step, video loops, the Tracker API,
            multi-hypothesis tracking and the live stream
  data      training pairs (files and the synthetic sampler), augmentation
  train     the trainer and checkpoints
  eval      metrics, the YCB scoring CLIs, the synthetic benchmark
  apps      the tracking, training and ROS entry points
  native    the libpng batch decoder (C++, built with g++ at first use)
  datagen   the procedural texture of the hard test video
  utils     config loaders and visualization helpers
  kernels   nvcc build and ctypes binding of the CUDA sources in csrc/
"""

__version__ = "0.1.0"
