"""Benchmark of the PyTorch/CUDA port of se(3)-TrackNet
(``iros20_6d_pose_tracking_tpu_torch``). Run one cell with
``python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` from the repository root on a machine with an NVIDIA GPU."""
