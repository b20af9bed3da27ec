#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the tracking step, the
closed-loop synthetic evaluation, synthetic training, the serving path, the
live path, the adaptive dispatcher, the synthetic pair factory, the accuracy
suite, the bf16 CNN, the scale-out layer, the last modules (the TF32
pin, profiling, ``render_at_bbox``, the demo, the fixture, the dry run),
the tracking step where a track is lost, with F14's float64 witness, the
compiled step (one CUDA graph a key, replayed), the render set-up kernel,
and FoundationPose's refiner through the compiled step.

    python3 chip_smoke.py [--refiner]

``--refiner`` runs steps 1, 2 and 17 alone.

Run from the root of the repository, on a machine with one CUDA card,
nvcc (``PATH`` or ``/usr/local/cuda``) and PyTorch built for CUDA. It:

  1. prints the card (``nvidia-smi`` name and power limit), the torch and
     CUDA versions, and sets TF32 off for matmuls and cuDNN;
  2. builds the CUDA kernels from ``iros20_6d_pose_tracking_tpu_torch/csrc``
     (``kernels/build.py``), one nvcc per source, all at once, and prints
     the build times;
  3. holds each kernel against its plain PyTorch version on the card: the
     production mesh (a subdiv-4 icosphere decimated to 2048 faces) in a
     176^2 ROI with the back-face cull on and off, and random cases whose
     window is no multiple of K1's 16 x 16 pixel block or of the pixel tile
     and whose face count is no multiple of the face block, sliver
     triangles and triangles with every corner on a pixel centre. K1
     (``pass1_winners``): winners equal and iz bit-equal. K2
     (``gather_rows``, the standalone row gather, off the render path):
     rows bit-equal. Pass 2 fused (``pass2_shade``) against
     ``pass2_shade_ref``: depth (and so hit) bit-equal, rgb within 1e-3
     (of 255) everywhere, textured or not, and more than 1 level apart on
     under 0.1% of pixels; on the production ROI with the cull on and off, with a
     lighting override, the textured box, a 480x640 full frame, 8 sampler
     views and (phase 7) the 400 views of a train batch. K3
     (``pass1_worklist``), in full 480x640 frames: the production mesh
     unculled, a 20,480-face icosphere at face block 256, random ragged
     cases, slivers, 8 face blocks holding the same faces at the same lanes
     (every key ties across blocks; block 0's face must win) and an empty
     frame: winners equal and iz bit-equal to its plain version, and to K1
     on the same full-frame inputs. K1 with a batch
     axis: the 8 views of a 4-pair training-sampler batch of the
     production mesh at 176^2 and a ragged random batch, one launch each:
     winners equal and iz bit-equal to the plain version, and every view
     bit-equal to the call on that view alone; K2 on those 8 views and on a
     ragged random batch of views (one launch) bit-equal to its plain
     version; the sliver and pixel-centre cases at B = 1 and the 400 views
     of phase 7 complete K1's adversarial set;
  4. drives the slice: ``Tracker.from_parts`` with the full-width
     Se3TrackNet at 176^2 (seeded random weights, randomised BatchNorm
     statistics, regression heads scaled by 0.05 with zero bias), the
     production mesh with the cull, 480x640 uint8 RGB and uint16 depth
     frames.
     ``on_track`` runs 50 frames and ``track_video`` 100; the poses must be
     finite, every step's ROI must hold the centre of the observed object,
     and K1's and ``pass2_shade``'s launch counts must rise by exactly the
     number of frames (K2 and K3 by none). Then 20 frames on the card
     against the same 20 frames on the port's plain CPU path: within
     5e-4 m and 5e-3 rad per frame;
  5. drives the evaluation path (``eval/synthetic_benchmark.py``) with the
     same tracker: ``make_gt_trajectory(60)``, ``render_test_video`` of the
     production mesh at 480x640 with ``hard=True`` (its full-frame renders
     through K3), ``_quantize`` and ``evaluate_tracking`` (ADD, ADD-S,
     VOCap). Poses and scores must be finite, and the launch counts must
     rise by exactly 120 for K3 (object and occluder on 60 frames), 179 for
     ``pass2_shade``, 59 for K1 and 0 for K2. Then the card against the
     port's plain CPU path: the first 3 quantized frames (RGB more than 1
     level apart, and depth coverage different, on under 0.1% of pixels
     each), the card's trajectory scored on the CPU (within 1e-6 m), and 10
     tracked frames (within 5e-4 m and 5e-3 rad);
  6. times K1, ``pass2_shade``, K2 and ``torch.index_select`` (K2's
     library yardstick, never called by the port) on the production inputs:
     CUDA events around 50 launches queued behind a device-side sleep (so
     the events time the device, not the host's enqueue), each kernel's
     device time under ``torch.profiler``, its plain version (CUDA events
     around each call, median of 50) and its bound (the larger of the bytes
     the function needs over 3.35 TB/s and the float32 operations its
     inputs need over 67 TFLOP/s); the pass 2 the port ran before (K2's rows written to device
     memory, then ``shade_rows``); the parts of one step and the whole step
     (CUDA events, median of 50), and the steady ``on_track`` and
     ``track_video`` rates (host clock around work that ends with the pose
     on the host), the eager step loop in turns with the earlier pass 2 (a
     captured program replays the pass 2 it was captured with), and the
     device's busy share over a ``torch.profiler`` window of 20 frames;
     then K3, K1 and plain K3 at 480x640 on both full-frame meshes, with
     each wrapper's host time and device operations per call (from the
     profiler; K3 fails the run above 4), one
     full-frame ``render`` through K3 and through K1 in 5 pairs of turns,
     the ``render_test_video`` and ``evaluate_tracking`` rates over 60
     frames, and ``batch_errors`` over 60 frames;
  7. drives synthetic training at full width, the configuration of the
     JAX ``bench.py`` train_synth row: a 0.08 m cube, ``DRComposite()``,
     the 480x640 intrinsics, batch 200 at 176^2, float32, TF32 off.
     First K1 and K2 at the main path's own shapes, the 400 views of one
     batch-200 sampler batch of the cube (one launch each): bit-equal to
     their plain versions, and K1 to the 400 one-view calls; and
     ``pass2_shade`` on those views against its plain version. Then
     ``compute_mean_std`` over 4 sampled batches and 10
     ``train_step_synth`` steps: losses finite, and K1 and ``pass2_shade``
     launched exactly once per sampled batch (the 400 views of a batch in
     one launch), K2 never. Then train steps on the card against the
     port's plain CPU path from the same weights on the same batch and
     draws, with ``train/compare.py`` (TRAIN_CHECKS): at 48^2 on a random
     batch without augmentation, the JAX parity test's kind, under its
     bars; at 176^2 on a sampled batch of 4 (RGB more than 1 level apart,
     and depth coverage different, on under 0.1% of pixels) with the
     augmentation, under float32's noise at that size. Each: 3 steps at lr 1e-5 and 2 at lr
     1e-3; losses, the first step's gradients per tensor and the state
     after 3 steps (after 1 at lr 1e-3). The CPU path with its convolutions
     out of oneDNN is held to the same bars beside the card, as the witness
     that they are float32's own noise. The trained state is saved, loaded
     by ``Tracker(ckpt_dir=...)`` on the card and tracks 10 frames with
     finite poses. Timings: sampler ms per batch-200 step split into
     render, DR and augmentation; forward + backward, optimizer and
     whole-step ms (CUDA events, median of 10); train samples/s; the
     sampler render and the train step in turns with the earlier pass 2;
     batched K1 and ``pass2_shade`` against their plain versions and
     bounds at 8 and at 400 views;
  8. drives the serving path (``apps/predict.py``, multi-hypothesis and
     chunked tracking) at full width with the tracker of phase 4: the
     multi-hypothesis runs on a 480x640 frame of the production mesh
     rendered by the port at the object's pose (so the health score means
     something), the chunked video on phase 4's frame. First K1 and
     ``pass2_shade`` over the culled inputs of 4 and 8 hypotheses at 176^2
     and at the 88^2 scoring resolution (one launch each): K1 against its
     plain version and the one-view calls, pass 2 against its plain
     version (depth bit-equal, rgb within 1e-3), and each view of the
     batched culled ``render`` against the single-pose culled render, bit
     for bit. Then ``on_track`` at samples 1, 4 and 8 over 20, 20 and 10
     frames: exactly 2 K1 and 2 ``pass2_shade`` launches a frame at
     samples > 1 (1 and 1 at samples 1), no K2, no K3, every winner's ROI
     holding the object's centre; the batched step against N single steps
     on the card (renders and crops bit for bit, poses within
     BATCH_STEP_BAR) and ``track_step_multi`` against the port's plain CPU
     path with the same perturbations (poses within 5e-4 m and 5e-3 rad,
     scores within CPU_SCORE_BAR, the same winner unless a near tie).
     ``track_video_chunked`` over 100 frames at chunk 64 from callables:
     bit-equal to ``track_video``, 100 K1 and 100 ``pass2_shade``
     launches. The predict CLI (``--mode ycbv``) on a YCB-style tree in a
     temporary directory (30 frames of the production mesh rendered by the
     port at 480x640, written as PNGs by ``write_png``, the
     ``dataset_info.yml`` as JSON, mean/std and a zero-head Flax
     checkpoint written with msgpack and numpy): scan at chunk 16 with
     canvases, then ontrack; the pose files of both modes equal, every
     pose within 1e-4 of the init gt, one canvas a frame, exact launch
     counts. Timings: ``on_track`` Hz at samples 1, 4 and 8;
     ``track_video_chunked`` and ``track_video`` in turns; predict scan
     frames/s with the PNG decode; the multi-hypothesis step's split at 8
     hypotheses and a profiler window of 5 frames at samples 8; K1 and
     ``pass2_shade`` at the N-view shapes against their plain versions and
     bounds;
  9. drives the live path (``tracking/stream.py``, ``apps/predict_ros.py``,
     ``apps/predict.py --track_mode stream``) with the tracker of phase 4:
     the windowed ``StreamTracker`` and the full-frame one over 100 pushes
     of phase 4's frame, each bit-equal to ``track_video`` (no containment
     violation, the window below the frame, exactly 1 K1 + 1
     ``pass2_shade`` a push); 100 windowed pushes under
     ``torch.cuda.set_sync_debug_mode`` "warn" (every synchronizing call
     recorded with its stack; none allowed) and 100 under "error"; 10
     pushes queued behind a 100 ms device sleep (those that fit in the
     card's measured launch queue must return within half the sleep); a
     samples-4 stream over 20 pushes of phase 8's rendered frame bit-equal
     to ``on_track(samples=4)`` (2 + 2 launches a push); a teleported pose
     caught by the containment check; a ReinitPolicy firing on black frames
     and its callback's pose applied; ``fill_depth`` of a 480x640 depth with
     holes on the card within 1e-6 m of the CPU path; the ROS core, stream
     against blocking, over 10 frames with filling on; predict in stream
     mode, windowed and ``--no_window``, on phase 8's tree (pose files
     equal to scan's); the native PNG loader against Pillow where it builds
     (else it says so). Timings: host_loop and host_loop_moving (the JAX
     ``bench.py`` rows) in turns with ``track_video`` and ``on_track``, the
     window, host ms a push and the device's busy share over 20 pushes; the
     samples-4 stream, the ROS core with filling on and off, ``fill_depth``,
     predict stream frames/s and both PNG decoders' frames/s;
 10. drives the adaptive dispatcher (``tracking/dispatch.py``) with the
     tracker of phase 4: ``AdaptiveVideoTracker`` with candidates (50, 10,
     1, 0) over phase 4's 100 frames and then the same frames in reverse,
     in chunks of 100 from callables, bit-equal to ``track_video`` with
     exactly 1 K1 + 1 ``pass2_shade`` a frame (and 1 + 1 a candidate in
     ``warmup``, counted apart), its telemetry printed; samples 4 with
     candidates (10, 1, 0) on 40 copies of phase 8's rendered frame, every
     mode run, poses and scores bit-equal to ``track_video_multi``; predict
     ``--track_mode adaptive`` on phase 8's tree (kept until now), pose
     files equal to scan's. Then the pair factory
     (``datagen/pair_producer.py``) on the card with
     ``configs/dataset_info.yml``'s camera, normalisers and pose ranges:
     ``produce_dataset`` of 40 train + 10 val pairs of the production mesh
     at 480x640 and 176^2 (DR scenes with up to 2 distractors and an
     occluder at 0.5), exactly 1 K3 + 1 ``pass2_shade`` a scene layer and 1
     K1 + 1 ``pass2_shade`` a pair, the pairs read back by ``PairDataset``
     and one batch-4 ``train_step`` on them with finite losses;
     ``complete_blender`` on 3 renders written in the Blender layout; two
     DR scenes card against the CPU path with the same layouts and draws
     (coverage, seg, depth within 0.01 mm and rgb within 1 level on all
     but 0.1% of the pixels, phase 5's share). Timings: ``track_video``,
     the dispatcher and each candidate forced alone in turns over 100
     frames; pairs/s end to end, scene render and pair render + crop ms
     (CUDA events), PNG write ms (host clock); K3 and ``pass2_shade`` on a
     cube primitive layer (256 faces) and the target layer (3072) at full
     frame against their plain versions and bounds;
 11. drives the accuracy suite (``eval/domain_shift.py``,
     ``eval/synthetic_benchmark.run_suite``) and the bf16 CNN. First
     ``pass2_shade`` against its plain version on full 480x640 frames at the
     suite's lighting: the production mesh at the sensor model's x1 and x4
     (ambient -0.15, the light beyond the object) and the textured box at
     ``texture_hostile``'s, as phase 3's bars, each timed beside its plain
     version and bound. ``shift_video`` on the card against the CPU path on
     the same draws over the first 10 frames of phase 5's video at x1 and
     x4 (rgb within 1e-3; depth different on at most 0.1% of pixels, each
     by a quantization step or dropout), and its ms per frame over the 60
     frames (CUDA events). ``run_suite`` cut to size: the production mesh
     as the one object, 5 train steps at batch 32, 30 hard frames, the
     domain-shifted table, the sweep (0.5, 2, 4), the x2 ablation, a
     45-frame long horizon with its forced-burst recovery and the live
     recovery at 30 Hz; every AUC finite, the live row with ``recovered``
     and no nan, and K1, K2, K3 and ``pass2_shade`` launched exactly as
     ``suite_launches_predicted`` derives from the code. bf16: one step
     against the float32 step under JAX's bars (1 mm, 5e-3), the drift of
     50 bf16 ``track_video`` frames from float32 (printed), the card's
     bf16 path against the CPU's over 20 frames, and ``track_video`` Hz and
     batch-200 ``train_step_synth`` samples/s, bf16 and float32 in turns;
 12. drives the scale-out layer (``parallel/spmd.py``,
     ``parallel/latency.py``): the JAX ``bench.py`` ``bench_ensemble``
     shape, 4 icospheres of subdivision 3 (radii 0.04-0.07 m), each with its
     own network and width, over 50 production frames through
     ``multi_object_track_videos``: serial gives per-object ``track_video``
     bits with 200 K1 and 200 ``pass2_shade`` launches, batched stays within
     5e-4 m and 5e-3 rad of it with 50 and 50; ``bench_multi``'s 8 videos of
     50 frames through ``batched_track_videos`` against per-video
     ``track_video`` (50 and 50 launches); K1 and ``pass2_shade`` at the 4-
     and 8-view shapes against their plain versions; aggregate frames/s in
     turns with sequential ``track_video``; ``ensemble_train_step`` at 4
     objects of batch 200, 176^2, serial and batched, against per-object
     ``train_step`` under the card's training bars, and samples/s in turns;
     ``run_suite(ensemble=True)`` on the production mesh and the cube with
     its launches predicted; and two processes sharing the card over gloo
     with CUDA tensors (NCCL refuses two ranks on one device): the
     face-sharded render of the 5120-face icosphere against the single
     render at the bars of JAX's test, K1 and K2 (the owned rows of a
     shard) against their plain versions bit for bit in each rank,
     ``sp_track_step`` against ``track_step`` and ``dp_train_step`` against
     ``train_step``, with the sharded render's and K2's times.
 13. drives the last modules of the port: F16, a fresh process that leaves
     TF32 at torch's default calls the module-level ``track_video`` (no
     ``Tracker``) over 50 production frames, every convolution run in
     Python (the program's eager warm-up and its capture, which its
     replays run) must see ``cudnn.allow_tf32`` False and the poses must be
     the pinned main process's bits; the TF32 drift of the heads at batch
     1 and 200 (F1, printed, gates nothing); ``utils/profiling``:
     ``StepTimer`` not returning before a device sleep ends, and beside the
     CUDA-event step time, ``trace`` around 5 ``track_video`` frames naming
     K1 and
     ``pass2_shade``; ``render_at_bbox`` bit-equal to ``render`` at its
     window, one K1 and one ``pass2_shade``, and against the CPU path at
     tests/test_torch_raster.py's bars; the demo
     (``apps/demo_train_and_track.main``, 100 steps at batch 32, 30 frames)
     with its launches predicted from the code; the fixture and the
     real-data dry run on the card.
 14. drives the tracking step where a track is lost: ``round_to_int32``,
     ``project_points`` and ``compute_bbox`` on the card give XLA's ints
     (NaN -> 0, saturating at the int32 limits) for infinite, NaN and
     out-of-range pixel coordinates, as on the CPU (torch's own conversion
     on the card printed beside them); one ``track_step`` on the card and
     on the CPU path from each regime of tests/test_torch_lost_track.py at
     the production scale (a window clipped by the frame border, one wholly
     outside the frame, a pose inside the near plane, one behind the
     camera, z = 0, a NaN translation, a window corner past 2^31 pixels):
     each regime reached, bbox ints and B's crop equal, poses within 5e-4 m
     and 5e-3 rad with NaN at the same entries, exactly one K1 and one
     ``pass2_shade`` launch a step; and F14's witness, the "sampled" train
     check's first step in float64 on the card, with the distance from it
     of the first-step float32 gradients on the card (cuDNN default,
     deterministic, off) and on the CPU (with and without oneDNN).
 15. drives the compiled step (``tracking/compiled.py``) on the production
     configuration, float32 and bf16, its programs captured anew: the
     module-level ``track_video`` over 100 frames twice (3 eager warm-up
     frames, the capture and 97 replays, then 100 replays), bit-equal to
     the eager step loop, with 100 K1 and 100 ``pass2_shade`` launches a
     run (a replay adds what its capture counted, among it the launches:
     one ``render_setup``, one K1 and one ``pass2_shade``);
     ``on_track`` over 24 frames (20 replayed) and a windowed stream over
     100 pushes, both bit-equal to the eager step, one K1 and one
     ``pass2_shade`` a frame; 100 replayed pushes and a replayed
     ``track_video`` under ``torch.cuda.set_sync_debug_mode("error")``;
     then eager and replayed in turns (``track_video`` float32 and bf16,
     ``on_track`` with its host ms a call, stream pushes with their host ms
     a push), each program's capture time, and the device's busy share in
     20-frame profiler windows of the eager and the replayed
     ``track_video`` and the replayed stream.
 16. holds the render set-up kernel (``render_setup``) to its plain
     version (``render_setup_ref``) on the card: the tracking step's culled
     ROI view (and unculled), 8 culled hypotheses, the sampler's 400
     unculled views of one train batch, the textured box, 4 stacked
     icospheres, a full frame whose window is four numbers and a pose
     across the near plane; per table (coef, block bboxes, attribute forms)
     the entries whose bits differ and the largest gap in ulps, and no row
     of another face (the compaction order). Then K1's winners through the
     kernel and through its plain version over 256 culled ROI poses, one
     ``render_setup`` launch a render on every render path (compiled
     ``track_video``, ``on_track`` at samples 1 and 4, an eager
     ``track_step``, ``render_pairs``, ``render_at_bbox``, a K3 full
     frame), the device operations of one eager tracking step with the
     kernel and with its plain version, and its times beside its plain
     version and bound.
 17. drives FoundationPose's refiner (``models/refinenet.py``) at its
     published widths through the compiled step, float32 and bf16, on 48
     frames of the production mesh rendered on the card along a slow path:
     the replayed ``track_video`` (one capture, a graph that holds both
     rounds; each replay adds 2 to ``refine.rounds`` and 1600 to
     ``refine.attn_tokens``) bit-equal to the eager two-round step, 6
     frames held to the CPU path from the card's own priors (float32 within
     1e-4, bf16 within 3e-3, in the refiner's units: translation over d/2,
     rotation over 20 degrees), the network on one frame's inputs against
     ``models/refinenet_reference.py`` (1e-4; bf16 3e-2), and the replayed
     rate.

Every timing line carries the card's name and power limit. The line before
the last is ``{"kernels": [...]}``: per kernel its route, source, the TPU
kernel it replaces, its launches on the main path (the tracking slice; K3's
from the evaluation path), its largest error against its plain version, and
``ms``, ``plain_ms``, ``bound_ms`` / ``bound_by`` and ``library_ms`` on the
production inputs (K3: the full frame), and ``launches_by_path`` (each
path's counts, zeroed just before it and read just after; "live" is the
windowed stream's); K1 and
``pass2_shade`` also carry ``serving_views``, their times at the culled
N-view shapes of phase 8, K3 and ``pass2_shade`` ``datagen_shapes``,
their times at phase 10's layers, and ``pass2_shade`` ``suite_lighting``,
its times at phase 11's lighting, K1 and ``pass2_shade``
``scale_out_views``, their times at phase 12's 4 objects' and 8 videos'
views, and K2 ``sharded_render``, its time at a shard's owned rows;
phase 13 adds ``render_at_bbox``, ``demo``, ``fixture`` and ``dryrun`` to
``launches_by_path``, phase 14 ``lost track``, phase 15 its ``compiled``
paths; phase 16 appends ``render_setup``'s entry (its ulp gaps, K1's
differing pixels, a step's device operations with and without it, its
launches by render path and its times at each shape). The last is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Any failure raises, so the exit code is nonzero.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
RES = 176
FAR = 2.0  # rasterizer.FAR_M, the render's far plane (m)
FRAME_HW = (480, 640)
# Intrinsics and ROI scale of the production configuration (bench.py).
K_PROD = np.array([[1066.778, 0, 312.9869], [0, 1067.487, 241.3109],
                   [0, 0, 1]], np.float32)
TIMING_RUNS = 50
# Regression heads scaled down (bias zeroed) so the random-weight tracker
# moves a little every frame and stays on the object.
HEAD_SCALE = 0.05
PORT = "iros20_6d_pose_tracking_tpu_torch"
# The TPU kernels the CUDA kernels replace, by file and line. pass2_shade
# replaces the row gather on the render path, fused with the shading of its
# rows; gather_rows stays as the gather's standalone counterpart.
REPLACES = {
    "raster_pass1": "iros20_6d_pose_tracking_tpu/render/pallas_raster.py:141",
    "gather_rows": "iros20_6d_pose_tracking_tpu/render/pallas_raster.py:299",
    "raster_pass1_worklist":
        "iros20_6d_pose_tracking_tpu/render/pallas_raster.py:429",
    "pass2_shade": "iros20_6d_pose_tracking_tpu/render/pallas_raster.py:299",
}
# Each kernel's wrapper in render/raster_kernels.py, and its __global__
# function's name as the profiler shows it.
WRAPPERS = {"raster_pass1": "pass1_winners", "gather_rows": "gather_rows",
            "raster_pass1_worklist": "pass1_worklist",
            "pass2_shade": "pass2_shade"}
DEVICE_FN = {"raster_pass1": "raster_pass1_kernel",
             "render_setup": "render_setup_kernel",
             "gather_rows": "gather_rows_kernel",
             "raster_pass1_worklist": "raster_pass1_worklist_kernel",
             "pass2_shade": "pass2_shade_kernel"}
# The bound of a kernel: the larger of its bytes (each input the function
# needs read once, each output written once) over the H100's memory rate
# and the float32 operations its inputs need over the H100's float32 peak
# outside the tensor cores (NVIDIA's data sheet, SXM, at 700 W). Pass 1
# needs the coefficients of the faces whose screen bbox holds a pixel, and
# 16 operations (four forms of 2 mul + 2 add) per (pixel, face) pair of
# those bboxes; a gather (pass 2, K2) needs the distinct rows its pixels'
# winners name, and pass 2 about 120 operations per hit pixel.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_PAIR = 16
OPS_PER_HIT_PIXEL = 120
# Frames of the evaluation path's ground-truth video, and how many of them
# the card-against-CPU phase renders and tracks.
EVAL_FRAMES = 60
CPU_RENDER_FRAMES = 3
CPU_TRACK_FRAMES = 10
# Calls of a pass-1 wrapper in one profiler window (phase 6); the device
# operations a K3 call may make, enforced from the profiler (it makes one:
# a cooperative kernel that builds the list, searches it and decodes); the
# plain K3's timed calls; and the full-frame renders through K3 and K1
# timed in turns.
PROFILE_CALLS = 20
K3_MAX_OPS = 4
K3_PLAIN_RUNS = 10
RENDER_PAIRS = 5
# Phase 7: the JAX bench.py train_synth configuration, and the sizes of the
# card-against-CPU check.
TRAIN_BATCH = 200
TRAIN_STEPS = 10
MEAN_STD_BATCHES = 4
TRAIN_XYZ = ((-0.12, 0.12), (-0.09, 0.09), (0.45, 0.85))
CPU_TRAIN_BATCH = 4
BATCHED_VIEWS = 8
# The card-against-CPU train checks: the batch, its runs (lr, steps, the
# step whose state is compared, the loss bar, the bar on each parameter
# tensor's share of noisy elements or None for a reading) and the bars of
# train/compare.py. "random": the JAX parity test's kind of batch and size,
# under its bars. "sampled": the main path's batch at the main path's size,
# under float32's noise there, measured on the CPU against the JAX package
# and float64: a few ReLU and max-pool units whose inputs lie within
# rounding of a switch take the other branch, so the first-step gradients
# of two float32 implementations lie up to 1.0e-2 apart (L2, per tensor),
# conv-bias gradients up to 8.9e-5 of their kernel's, and the step-2 loss
# at lr 1e-3 4.1e-5 apart. Its "witness", the CPU path without oneDNN, is
# held to the same bars beside the card. Against float64 (phase 14, F14) the
# card's first-step gradients lie 1.5e-3 apart on an H100 and the CPU's
# 7.0e-3: the CPU is the farther of the two.
TRAIN_CHECKS = {
    "random": {"res": 48, "sampled": False, "witness": False,
               "runs": ((1e-5, 3, 3, 1e-5, None),
                        (1e-3, 2, 1, 1e-5, 0.1)),
               "grads": {}, "states": {}},
    "sampled": {"res": RES, "sampled": True, "witness": True,
                "runs": ((1e-5, 3, 3, 1e-4, None),
                         (1e-3, 2, 1, 5e-4, None)),
                "grads": {"grad_rtol": 3e-2, "bias_floor": 1e-4},
                "states": {"var_rtol": 2e-4, "mean_lr": 1.0}},
}
# Phase 8, the serving path: the hypothesis counts of the culled N-view
# checks, the scoring resolution (tracking/hypotheses.scoring_resolution at
# 176^2), the on_track frames per samples value, the chunked video, the
# predict CLI's tree. BATCH_STEP_BAR: the batched step against N single
# steps on the card (pose entries; the CNN at batch N runs other cuDNN
# algorithms than at batch 1). CPU_SCORE_BAR: a score on the card against
# the CPU path: a score sums a depth over thousands of pixels, and the
# rendered depth's rounding moves with the pose (1.2e-8 of pose moved a
# score by 1.9e-4 on the CPU, tests/test_torch_hypotheses.py).
SERVE_VIEWS = (4, 8)
SCORE_RES = 88
MULTI_FRAMES = {1: 20, 4: 20, 8: 10}
CHUNK_FRAMES, CHUNK_SIZE = 100, 64
PREDICT_FRAMES, PREDICT_CHUNK = 30, 16
BATCH_STEP_BAR = 1e-5
CPU_SCORE_BAR = 1e-3
# Phase 9, the live path: the stream's frames (bit-equal runs, the
# multi-hypothesis run), the pushes under the sync check, the pushes queued
# behind a device sleep of SLEEP_MS and the bar on when they must all have
# returned (a share of the sleep), the host loops of the JAX bench.py
# (bench_host_loop, bench_host_loop_moving: frames, repeats, drift), the ROS
# core's frames, and the bars of fill_depth on the card against the CPU
# (metres; the exp of the bilateral weights rounds differently, 4.8e-7 on
# the CPU against JAX) and of the ROS stream core against the blocking core
# (whose depth is not cut to whole millimetres).
LIVE_FRAMES = 100
LIVE_MULTI_FRAMES = 20
SYNC_PUSHES = 100
SLEEP_MS, SLEEP_PUSHES, SLEEP_BAR = 100.0, 10, 0.5
HOST_LOOP_FRAMES, HOST_LOOP_REPEATS = 75, 3
MOVING_DRIFT_MM = 0.45
LIVE_PROFILE_PUSHES = 20
ROS_FRAMES = 10
FILL_BAR_M = 1e-6
ROS_BAR_M, ROS_BAR_RAD = 5e-4, 5e-3
# Phase 10: the adaptive dispatcher (phase 4's frames and then the same
# frames in reverse, in chunks of ADAPTIVE_CHUNK; each candidate forced
# alone, in turns with track_video over ADAPTIVE_TURN_FRAMES; samples 4 on
# ADAPTIVE_MULTI_FRAMES frames of the rendered frame in chunks of
# ADAPTIVE_MULTI_CHUNK) and the pair factory (produce_dataset's train and val
# pairs with configs/dataset_info.yml's camera, normalisers and ranges; the
# scenes checked card against CPU; the Blender-layout renders; the scenes and
# pairs of the timing split). A DR scene on the card against the CPU path:
# the per-face forms come from eager float32 ops whose rounding differs
# between the two devices, so coverage, seg, depth (beyond DR_DEPTH_BAR_MM,
# the frame bar of tests/test_torch_synthetic_eval.py) and rgb (more than 1
# level apart) may differ on fewer than DR_PIXEL_SHARE of the pixels, the
# share phase 5 allows its card-vs-CPU frames.
ADAPTIVE_CHUNK, ADAPTIVE_PROBE = 100, 20
ADAPTIVE_CANDIDATES = (50, 10, 1, 0)
ADAPTIVE_TURN_FRAMES = 100
ADAPTIVE_MULTI_FRAMES, ADAPTIVE_MULTI_CHUNK = 40, 20
ADAPTIVE_MULTI_CANDIDATES = (10, 1, 0)
DATAGEN_TRAIN, DATAGEN_VAL = 40, 10
DATAGEN_CPU_SCENES = 2
DATAGEN_BLENDER_IMAGES = 3
DATAGEN_TIMED = 10
DR_DEPTH_BAR_MM, DR_PIXEL_SHARE = 0.01, 1e-3
# Phase 11, the accuracy suite and the bf16 CNN. The sensor model's severities
# whose lighting pass2_shade is held at (x4: ambient -0.15, the light beyond
# the object); the frames of phase 5's video shifted on the card and on the
# CPU path, and the runs of the card's shift_video timing; the reduced
# run_suite (the production mesh, train steps at a batch, test frames, the
# sweep, the long horizon); bf16: the frames of its drift from float32, the
# frames the card's bf16 path is held to the CPU's bf16 path over, with its
# bars (metres, radians: about 10x the 1.8e-5 m and 9.0e-5 rad measured on
# an H100; bf16 rounds the CNN's activations to 8 bits, so the two devices'
# poses drift apart as the frames go), and the batch-200 train steps a turn.
SUITE_SEVERITIES = (1.0, 4.0)
SHIFT_CPU_FRAMES, SHIFT_TIMED_RUNS = 10, 5
SUITE_STEPS, SUITE_BATCH, SUITE_FRAMES = 5, 32, 30
SUITE_SWEEP, SUITE_LONG = (0.5, 2.0, 4.0), 45
BF16_VIDEO_FRAMES, BF16_CPU_FRAMES = 50, 20
BF16_CPU_BAR_M, BF16_CPU_BAR_RAD = 2e-4, 1e-3
BF16_TRAIN_STEPS = 3
# (HOST_LOOP_FRAMES, SUITE_FRAMES, SUITE_LONG and BF16_VIDEO_FRAMES were
# halved to make room for phase 12 in the run's time.)
# Phase 12, the scale-out layer: the JAX bench.py bench_ensemble (O objects,
# T frames) and bench_multi (V videos, T frames) shapes; the ensemble train
# steps compared and timed a turn; the turns of the aggregate rates; the
# reduced ensemble suite (two objects, its train steps and frames); the
# two-rank phase's data-parallel batch (split over the ranks) and its time
# limit.
ENSEMBLE_O, ENSEMBLE_T = 4, 50
VIDEOS_V, VIDEOS_T = 8, 50
ENSEMBLE_TRAIN_STEPS = 2
SCALE_TURNS = 2
SUITE_ENSEMBLE_STEPS, SUITE_ENSEMBLE_FRAMES = 2, 30
DP_BATCH = 32
RANKS_TIMEOUT_S = 240
# Phase 13, the last modules of the port: the unpinned process's frames
# (F16) and its time limit; the batches of the TF32 drift measurement (F1);
# the nominal device sleep StepTimer must not return before; the frames
# under trace; the reduced demo (apps/demo_train_and_track.py at its clean
# batch) and the fixture's and the dry run's frames.
F16_FRAMES, F16_TIMEOUT_S = 50, 180
TF32_BATCHES = (1, 200)
TIMER_SLEEP_MS = 5.0
TRACE_FRAMES = 5
DEMO_STEPS, DEMO_FRAMES, DEMO_BATCH = 100, 30, 32
FIXTURE_FRAMES, DRYRUN_FRAMES = 8, 6
# Phase 14, where a track is lost, and F14: pixel coordinates whose int32
# conversion must be XLA's (NaN -> 0, saturating at the limits) and XLA's
# ints for them; the distance of the centre of the clipped window from the
# frame's left border (px) and of the off-frame window's from its right
# border; the bars of F14's witness on the "sampled" batch: the card's
# first-step gradients within F14_BAR of float64 (TRAIN_CHECKS's bar
# against the CPU path) and no farther from it than F14_RATIO times the
# CPU's (measured on an H100: 1.5e-3 and 0.22x), and float64 on the card
# within F64_BAR of float64 on the CPU (measured 3.5e-6).
INT32_INPUTS = (np.inf, -np.inf, np.nan, 3e9, -3e9, 1e12, 2147483647.0,
                2147483648.0)
INT32_XLA = (2147483647, -2147483648, 0, 2147483647, -2147483648,
             2147483647, 2147483647, 2147483647)
CLIPPED_PX, OUTSIDE_PX = 10, 300
F14_BAR = TRAIN_CHECKS["sampled"]["grads"]["grad_rtol"]
F14_RATIO = 2.0
F64_BAR = 1e-4
# Phase 15, the compiled step: phase 4's frames through track_video and the
# stream, on_track's replayed frames, the replayed pushes under sync debug
# mode "error", and the frames of each profiler window.
COMPILED_FRAMES = 100
COMPILED_ON_TRACK = 20
COMPILED_SYNC_PUSHES = 100
COMPILED_PROFILE_FRAMES = 20
# Phase 16, the render set-up kernel: the hypotheses and stacked meshes of
# its cases, the pose draws whose K1 winners are compared through the kernel
# and through its plain version, and the frames of the launch-count paths.
# ROW_FAR: a table row farther from the plain version's than this share of
# the row's largest entry holds another face (the compaction order differs);
# rounding keeps rows within a few ulps.
SETUP_HYPOTHESES, SETUP_STACKED = 8, 4
SETUP_AGREEMENT_POSES = 256
SETUP_FRAMES = 20
ROW_FAR = 1e-3
# The set-up's float32 operations a face (projection, coefficient rows,
# attribute forms; the bound is its bytes by far).
SETUP_OPS_PER_FACE = 300
# Phase 17, FoundationPose's refiner: its frames (the production mesh
# rendered on the card along a slow path), the frames held to the CPU
# path, and the bars, in the refiner's own units (translation over d / 2,
# rotation over its 20 degrees): the card's float32 step against the CPU's
# (render rounding and cuDNN's summation order), its bf16 step against the
# CPU's float32, and the card's network against its plain reference on one
# frame's inputs (float32; bf16).
REFINER_RES = 160
REFINER_HEAD_SCALE = 0.005
REFINER_FRAMES = 48
REFINER_CPU_FRAMES = 6
REFINER_STEP_BAR = {"float32": 1e-4, "bfloat16": 3e-3}
REFINER_NET_BAR = {"float32": 1e-4, "bfloat16": 3e-2}


def production_mesh():
    """Subdiv-4 icosphere (5120 faces) decimated to 2048 faces, as
    ``Tracker(max_faces=2048)`` does to a scanned CAD model."""
    from iros20_6d_pose_tracking_tpu_torch.render import mesh as M

    full = M.make_icosphere(subdiv=4, radius=0.05)
    tm = M.build_trimesh(*M.decimate(full.verts, full.faces[: full.num_faces],
                                     full.colors, 2048))
    real = tm.faces[: tm.num_faces]
    cull = M.is_closed(tm.verts, real) and M.is_outward_oriented(
        tm.verts, real, tm.normals)
    return tm, bool(cull)


def production_frames():
    """One 480x640 observed frame (uint8 RGB, uint16 mm depth) of the object
    at 0.6 m: a grey disk of valid depth on a gradient background."""
    from iros20_6d_pose_tracking_tpu_torch.render import mesh as M

    tm, _ = production_mesh()
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 0.6
    vv, uu = np.mgrid[:FRAME_HW[0], :FRAME_HW[1]].astype(np.float32)
    cu = K_PROD[0, 2] + K_PROD[0, 0] * pose[0, 3] / pose[2, 3]
    cv = K_PROD[1, 2] + K_PROD[1, 1] * pose[1, 3] / pose[2, 3]
    rad_px = float(M.compute_cloud_diameter(tm.verts)) / 2 * K_PROD[0, 0] \
        / pose[2, 3]
    disk = ((uu - cu) ** 2 + (vv - cv) ** 2) < rad_px ** 2
    rgb = np.zeros(FRAME_HW + (3,), np.uint8)
    rgb[..., 0] = (uu / FRAME_HW[1] * 80).astype(np.uint8)
    rgb[disk] = 128
    depth = np.where(disk, np.uint16(600), np.uint16(0))
    return pose, rgb, depth


def build_model(seed):
    """Full-width Se3TrackNet with seeded random weights, BatchNorm
    statistics randomised and the regression heads scaled by HEAD_SCALE,
    on the CPU in eval mode."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.models import tracknet

    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = tracknet.Se3TrackNet(image_size=RES)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
        for head in (net.trans_out, net.rot_out):
            head[0].weight.mul_(HEAD_SCALE)
            head[0].bias.zero_()
    return net.eval()


def make_tracker(net, device, dtype=None):
    """The production tracker around a copy of ``net`` on ``device``, its
    CNN in ``dtype`` (default float32)."""
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    tm, cull = production_mesh()
    cfg = trk.TrackerConfig(
        resolution=RES, object_width_mm=float(tm.diameter) * 1000 * 1.1,
        cull_backfaces=cull)
    return trk.Tracker.from_parts(
        copy.deepcopy(net).to(device), cfg, rz.upload(tm, device), K_PROD,
        np.zeros(8, np.float32), np.full(8, 100.0, np.float32), dtype=dtype)


def render_case(mesh, pose, K, window, hw, cull, fb=None):
    """The pass-1 and pass-2 inputs of one render of ``mesh`` (on its
    device) at ``pose`` into ``window`` at ``hw``, with or without the
    back-face cull, as ``rasterizer.render`` builds them: a dict of coef,
    bbox, fb (``pick_face_block`` unless given), attr, R, t, and face_bbox,
    the screen bboxes of the faces pass 1 searches (for the bound)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    dev = mesh.fverts.device
    fx, fy, fiz, fvalid, R, t = rk.project_faces(
        mesh, torch.as_tensor(pose).to(dev), torch.as_tensor(K).to(dev),
        window, hw, rz.NEAR_M)
    attr = rk.face_attr_forms(fx, fy, fiz, fvalid, mesh)
    if cull:
        coef, bbox, fb, attr = rk.culled_pass1_inputs(mesh, fx, fy, fiz,
                                                      fvalid, R, t, attr)
        searched = fvalid & ~rk.backface_mask(mesh, R, t)
    else:
        coef, _ = rk.build_face_coefficients(fx, fy, fiz, fvalid)
        fb = fb or rk.pick_face_block(fx.shape[-2])
        bbox = rk.build_block_bboxes(fx, fy, fvalid, fb)
        searched = fvalid
    return {"coef": coef, "bbox": bbox, "fb": fb, "attr": attr, "R": R,
            "t": t, "face_bbox": rk.build_face_bboxes(fx, fy, searched)}


def pass1_case(tracker, pose, cull):
    """The inputs (``render_case``) of one production render in the ROI of
    ``pose``, with or without the cull."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.ops import roi
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    pose = torch.as_tensor(pose).to(tracker.device)
    bbox = roi.compute_bbox(pose, tracker.K, tracker.cfg.object_width_mm,
                            (1000.0, 1000.0, 1000.0))
    return render_case(tracker.mesh, pose, tracker.K,
                       rz.window_from_bbox(bbox), (RES, RES), cull)


def fuzz_case(rng, F, hw, fb, device, kind="random"):
    """F triangles over (and past) an (H, W) window: "random" ones up to 25
    pixels across; "slivers", two corners up to 240 pixels apart and the
    third within 1e-3 to 1 pixel of the line between them; or
    "corners_on_centres", random ones with every corner rounded to a pixel
    centre. Returns (coef, block_bbox)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk

    H, W = hw
    cx = rng.uniform(-10, W + 10, (F, 1))
    cy = rng.uniform(-10, H + 10, (F, 1))
    if kind == "slivers":
        ang = rng.uniform(0, np.pi, (F, 1))
        half = rng.uniform(3, 120, (F, 1))
        d = np.concatenate([np.cos(ang), np.sin(ang)], 1)
        off = rng.uniform(-1, 1, (F, 1)) * 10.0 ** rng.uniform(-3, 0, (F, 1))
        s = rng.uniform(-1, 1, (F, 1))
        c = np.concatenate([cx, cy], 1)
        pts = np.stack([c - half * d, c + half * d,
                        c + s * half * d + off * d[:, ::-1] * [-1, 1]], 1)
        x, y = pts[..., 0], pts[..., 1]
    else:
        size = rng.uniform(1.0, 25.0, (F, 1))
        x = cx + rng.uniform(-1, 1, (F, 3)) * size
        y = cy + rng.uniform(-1, 1, (F, 3)) * size
        if kind == "corners_on_centres":
            x, y = np.round(x), np.round(y)
    fx = torch.as_tensor(x, dtype=torch.float32).to(device)
    fy = torch.as_tensor(y, dtype=torch.float32).to(device)
    fiz = torch.as_tensor(rng.uniform(0.5, 3.0, (F, 3)),
                          dtype=torch.float32).to(device)
    fvalid = torch.as_tensor(rng.rand(F) > 0.05).to(device)
    coef, _ = rk.build_face_coefficients(fx, fy, fiz, fvalid)
    return coef, rk.build_block_bboxes(fx, fy, fvalid, fb)


def check_pass1(name, coef, bbox, hw, fb):
    """K1 against its plain version: winners equal, iz bit-equal. Returns
    (max |iz difference|, iz, winner) of the kernel."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk

    iz, win = rk.pass1_winners(coef, bbox, hw, fb)
    iz_ref, win_ref = rk.pass1_winners_ref(coef, bbox, hw, fb)
    n_win = int((win != win_ref).sum())
    n_bits = int((iz.view(torch.int32) != iz_ref.view(torch.int32)).sum())
    err = float((iz - iz_ref).abs().max())
    covered = int((iz > 0).sum())
    print(f"K1 {name}: F={coef.shape[1]} fb={fb} hw={hw} covered={covered} "
          f"winner mismatches={n_win} iz bit mismatches={n_bits} "
          f"max|d iz|={err}", flush=True)
    if n_win or n_bits:
        raise AssertionError(f"K1 disagrees with its plain version ({name})")
    if covered == 0:
        raise AssertionError(f"K1 case {name} covers no pixel")
    return err, iz, win


def check_gather(name, attr, winner, covered):
    """K2 against its plain version: rows bit-equal. Returns the max
    |row difference|."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk

    rows = rk.gather_rows(attr, winner, covered)
    ref = rk.gather_rows_ref(attr, winner, covered)
    n_bits = int((rows.view(torch.int32) != ref.view(torch.int32)).sum())
    err = float((rows - ref).abs().max())
    print(f"K2 {name}: attr {tuple(attr.shape)} winner "
          f"{tuple(winner.shape)} covered={int(covered.sum())} "
          f"bit mismatches={n_bits} max|d row|={err}", flush=True)
    if n_bits:
        raise AssertionError(f"K2 disagrees with its plain version ({name})")
    return err


def check_pass2(name, case, hw, texture=None, lighting=None):
    """``pass2_shade`` against ``pass2_shade_ref`` on one case's attr, R, t
    and pass-1 outputs (iz, win): depth bit-equal (so hit too), rgb finite
    and within 1e-3 (of 255) everywhere, textured or not (the kernel sums
    the rotation and the norms in its own order), and, as a second count,
    more than 1 level apart on under 0.1% of pixels. Returns the max |rgb
    difference|."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk

    args = (case["attr"], case["iz"], case["win"], case["R"], case["t"], hw,
            FAR)
    rgb, depth = rk.pass2_shade(*args, texture=texture, lighting=lighting)
    rgb_r, depth_r = rk.pass2_shade_ref(*args, texture=texture,
                                        lighting=lighting)
    n_bits = int((depth.view(torch.int32) != depth_r.view(torch.int32))
                 .sum())
    d_rgb = (rgb - rgb_r).abs()
    err = float(d_rgb.max())
    off = float((d_rgb.amax(-1) > 1.0).float().mean())
    hits = int((depth_r > 0).sum())
    print(f"pass2_shade {name}: attr {tuple(case['attr'].shape)} hw={hw} "
          f"views={depth.numel() // (hw[0] * hw[1])} hit pixels={hits} "
          f"textured={texture is not None} lighting="
          f"{None if lighting is None else lighting.tolist()}: depth bit "
          f"mismatches={n_bits}, rgb max|d|={err:.3e}, rgb >1 level apart on "
          f"{off:.2e} of pixels", flush=True)
    if n_bits or off >= 1e-3 or not bool(torch.isfinite(rgb).all()) or \
            not err <= 1e-3:
        raise AssertionError(f"pass2_shade disagrees with its plain version "
                             f"({name})")
    if hits == 0:
        raise AssertionError(f"pass2_shade case {name} hits no pixel")
    return err


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bbox_pixels(face_bbox, hw):
    """Per face of the screen bboxes (..., F, 4), the pixel centres of the
    (H, W) window its bbox holds: the pixels pass 1 must test it at."""
    import torch

    H, W = hw
    b = face_bbox.to(torch.float64)
    nx = (torch.clamp(torch.floor(b[..., 1]), max=W - 1)
          - torch.clamp(torch.ceil(b[..., 0]), min=0) + 1).clamp(min=0)
    ny = (torch.clamp(torch.floor(b[..., 3]), max=H - 1)
          - torch.clamp(torch.ceil(b[..., 2]), min=0) + 1).clamp(min=0)
    return nx * ny


def winner_rows_bytes(attr, win, mask):
    """Bytes of the distinct rows of attr ([B,] F, C) that the clamped
    winners ``win`` ([B,] ...) name where ``mask`` holds: the only rows a
    gather of those pixels must read."""
    import torch

    F = attr.shape[-2]
    ids = torch.clamp(win, 0, F - 1).to(torch.int64)
    if attr.dim() == 3:  # each view's rows apart
        ids = ids + F * torch.arange(attr.shape[0], device=ids.device).reshape(
            (-1,) + (1,) * (ids.dim() - 1))
    return (torch.unique(ids[mask]).numel() * attr.shape[-1]
            * attr.element_size())


def bound(n_bytes, ops):
    """(bound ms, "bytes" or "operations") of n_bytes moved and ops
    float32 operations on the H100."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def pass1_bound(case, hw):
    """K1's (and K3's) bound on one case with its outputs iz, win: the
    coefficients of the faces whose screen bbox holds a pixel of the window
    (no other face can cover one), the block bboxes and the outputs;
    OPS_PER_PAIR for each (pixel, face) pair of those bboxes."""
    pix = bbox_pixels(case["face_bbox"], hw)
    coef = case["coef"]
    coef_bytes = int((pix > 0).sum()) * coef.shape[-2] * coef.element_size()
    return bound(coef_bytes + nbytes(case["bbox"], case["iz"], case["win"]),
                 OPS_PER_PAIR * int(pix.sum()))


def pass2_bound(case, texture=None):
    """pass2_shade's bound on a case: iz, win, R and t read, and the
    distinct attribute rows the hit pixels' winners name (and the texture,
    read once, where there is one); rgb and depth written;
    OPS_PER_HIT_PIXEL for each hit pixel."""
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk

    hit = rk.zmin_from_iz(case["iz"]) < FAR
    return bound(nbytes(case["iz"], case["win"], case["R"], case["t"])
                 + winner_rows_bytes(case["attr"], case["win"], hit)
                 + case["iz"].numel() * 16
                 + (0 if texture is None else nbytes(texture)),
                 OPS_PER_HIT_PIXEL * int(hit.sum()))


@functools.cache
def sleep_cycles_per_ms():
    """Cycles per millisecond of ``torch.cuda._sleep`` on the card."""
    import torch

    cycles = 20_000_000
    torch.cuda._sleep(cycles // 10)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def run_ms(fn, runs=TIMING_RUNS):
    """Milliseconds per launch of ``fn`` over ``runs`` back-to-back calls
    between two CUDA events, with the stream held by a device-side sleep
    twice as long as the host takes to enqueue them, so the events time the
    device's run of the launches and not the host's enqueue. The card
    queues about a thousand launches before the host waits, so ``runs``
    times the device operations of one call stays under that."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda._sleep(int(2 * host_ms * sleep_cycles_per_ms()))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def host_ms(fn, runs=TIMING_RUNS):
    """Host milliseconds per call of ``fn`` over ``runs`` calls enqueued
    back to back (the card idle at the start; the calls' device operations
    stay under the launch queue's depth, so the host never waits)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / runs
    torch.cuda.synchronize()
    return ms


def device_ms(fn, kernel):
    """Device time per launch of ``fn``'s kernel (the __global__ function
    whose name holds ``DEVICE_FN[kernel]``; one a call) over PROFILE_CALLS
    calls under torch.profiler, averaged over the launches the profiler
    recorded (it has recorded fewer), or None when it recorded none."""
    prof = profile_share(lambda: [fn() for _ in range(PROFILE_CALLS)],
                         top=100)
    if prof is None:
        return None
    rows = [(us, n) for key, us, n in prof[3] if DEVICE_FN[kernel] in key]
    n = sum(r[1] for r in rows)
    if not n:
        return None
    if n != PROFILE_CALLS:
        print(f"profile: {kernel}: {n} of {PROFILE_CALLS} launches recorded",
              flush=True)
    return sum(r[0] for r in rows) / 1e3 / n


def report_kernel(name, label, fn, plain_fn, bnd, card, plain_runs=None,
                  library_fn=None, runs=TIMING_RUNS):
    """Time one kernel (``run_ms`` over ``runs`` calls), its device time
    (profiler), its plain version (``cuda_ms``) and, where given, the
    library call; print them beside the bound. Returns the kernels-line
    numbers."""
    ms = run_ms(fn, runs)
    dev_ms = device_ms(fn, name)
    plain = cuda_ms(plain_fn, runs=plain_runs or TIMING_RUNS,
                    warmup=1 if plain_runs else 3)
    lib = run_ms(library_fn) if library_fn is not None else None
    bound_ms, bound_by = bnd
    print(f"timing kernel {name} {label}: {ms:.5f} ms per launch (CUDA "
          f"events around {runs} queued launches), device "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.5f} ms'} "
          f"(profiler), plain version {plain:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by})" + ("" if lib is None else
                             f", library call {lib:.5f} ms") + f" {card}",
          flush=True)
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib, "device_ms": dev_ms}


def launches_of(wrapper):
    """The launches of the kernel wrapper ``wrapper`` so far: the counter
    ``launches.<wrapper>`` of ``utils/profiling``."""
    from iros20_6d_pose_tracking_tpu_torch.utils import profiling

    return profiling.counters()[f"launches.{wrapper}"]


_LAUNCHES_ZERO = {}  # kernel name -> its launches at zero_launches


def zero_launches():
    """Count every kernel's launches from here on (``read_launches``)."""
    _LAUNCHES_ZERO.update({k: launches_of(fn) for k, fn in WRAPPERS.items()})


def read_launches():
    """Every kernel's launches since ``zero_launches``, by kernel name."""
    return {k: launches_of(fn) - _LAUNCHES_ZERO.get(k, 0)
            for k, fn in WRAPPERS.items()}


@contextlib.contextmanager
def unfused_pass2():
    """For timing only: renders run the port's earlier pass 2 (the K2 row
    gather written to device memory, then ``shade_rows``' eager ops) in
    place of ``pass2_shade``, for turn-by-turn comparison in one run."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk

    def unfused(attr, iz, winner, R, t, out_hw, far, texture=None,
                lighting=None):
        zmin = rk.zmin_from_iz(iz)
        winner = torch.clamp(winner, 0, attr.shape[-2] - 1)
        hit = torch.isfinite(zmin) & (zmin < far)
        flat = zmin.shape[:-2] + (-1,)
        covered = torch.isfinite(zmin.reshape(flat))
        row = rk.gather_rows(attr, winner.reshape(flat), covered)
        return rk.shade_rows(R, t, row, hit.reshape(flat), out_hw,
                             texture=texture, lighting=lighting)

    fused = rk.pass2_shade
    rk.pass2_shade = unfused
    try:
        yield
    finally:
        rk.pass2_shade = fused


def cuda_ms(fn, runs=TIMING_RUNS, warmup=3):
    """Median milliseconds of ``fn`` over ``runs`` calls, each between two
    CUDA events on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rot_angle(Ra, Rb):
    """Angle (rad) of Ra^T Rb from its skew part, which keeps small angles
    exact where the trace form's arccos has a float32 floor of ~1e-3."""
    R = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arcsin(min(np.linalg.norm(w) / 2.0, 1.0)))


def profile_share(fn, top=8):
    """Device busy share of one call of ``fn`` under torch.profiler: summed
    kernel and copy time on the card over the wall time of the window, the
    number of device operations, and those that took most of the time.
    Returns None when the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        return None
    busy_us = sum(r[1] for r in rows)
    n_ops = sum(r[2] for r in rows)
    return busy_us, wall_us, n_ops, sorted(rows, key=lambda r: -r[1])[:top]


def textured_case(dev):
    """The pass-1 and pass-2 inputs, culled, of one ROI render of the
    textured box (36 attribute columns, a 3x2 texture atlas) at 0.55 m,
    with its K1 outputs; and the texture."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.core import se3
    from iros20_6d_pose_tracking_tpu_torch.ops import roi
    from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    tm = M.make_textured_box()
    mesh = rz.upload(tm, dev)
    pose = se3.make_pose(se3.so3_exp(torch.tensor([0.5, 0.3, -0.2])),
                         torch.tensor([0.01, -0.01, 0.55])).to(dev)
    K = torch.as_tensor(K_PROD).to(dev)
    window = rz.window_from_bbox(roi.compute_bbox(
        pose, K, tm.diameter * 1000 * 1.1, (1000.0, 1000.0, 1000.0)))
    case = render_case(mesh, pose, K, window, (RES, RES), cull=True)
    case["iz"], case["win"] = rk.pass1_winners(case["coef"], case["bbox"],
                                               (RES, RES), case["fb"])
    return case, mesh.texture


def check_kernels(tracker, pose0):
    """Phase 3: each kernel against its plain version on the production
    inputs (cull off and on), on random ragged cases, sliver triangles and
    triangles with every corner on a pixel centre, and pass 2 fused on the
    production inputs (with the default lighting and an override) and the
    textured box. Returns the max error per kernel and the production
    cases of both cull settings (``render_case`` dicts with K1's outputs
    iz and win, K2's clamped winner and covered)."""
    import torch

    dev = tracker.device
    errs = {"raster_pass1": 0.0, "gather_rows": 0.0, "pass2_shade": 0.0}
    prod = {}
    for cull in (False, True):
        case = pass1_case(tracker, pose0, cull)
        err, iz, win = check_pass1(f"production cull={cull}", case["coef"],
                                   case["bbox"], (RES, RES), case["fb"])
        errs["raster_pass1"] = max(errs["raster_pass1"], err)
        winner = torch.clamp(win, 0, case["coef"].shape[1] - 1).reshape(-1)
        covered = (iz > 1e-9).reshape(-1)
        errs["gather_rows"] = max(errs["gather_rows"], check_gather(
            f"production cull={cull}", case["attr"], winner, covered))
        case.update(iz=iz, win=win, winner=winner, covered=covered)
        errs["pass2_shade"] = max(errs["pass2_shade"], check_pass2(
            f"production cull={cull}", case, (RES, RES)))
        prod[cull] = case
    light = torch.tensor([0.5, 0.7, 0.3, -0.4, -1.2], device=dev)
    errs["pass2_shade"] = max(errs["pass2_shade"], check_pass2(
        "production cull=True, lighting override", prod[True], (RES, RES),
        lighting=light))
    tex_case, texture = textured_case(dev)
    errs["pass2_shade"] = max(errs["pass2_shade"], check_pass2(
        "textured box cull=True", tex_case, (RES, RES), texture=texture))
    errs["pass2_shade"] = max(errs["pass2_shade"], check_pass2(
        "textured box cull=True, lighting override", tex_case, (RES, RES),
        texture=texture, lighting=light))
    rng = np.random.RandomState(SEED)
    for kind, F, hw, fb in (("random", 700, (37, 53), 256),
                            ("random", 1500, (131, 97), 512),
                            ("random", 3000, (57, 203), 1024),
                            ("random", 2048, (RES, RES), 1024),
                            ("slivers", 600, (57, 203), 512),
                            ("slivers", 2048, (RES, RES), 1024),
                            ("corners_on_centres", 500, (41, 67), 256),
                            ("corners_on_centres", 2048, (RES, RES), 1024)):
        coef, bbox = fuzz_case(rng, F, hw, fb, dev, kind)
        err, _, _ = check_pass1(kind, coef, bbox, hw, fb)
        errs["raster_pass1"] = max(errs["raster_pass1"], err)
    for F, C, P in ((1280, 36, 7013), (2048, 30, RES * RES + 5)):
        attr = torch.as_tensor(rng.randn(F, C) * 100,
                               dtype=torch.float32).to(dev)
        winner = torch.as_tensor(rng.randint(0, F, P),
                                 dtype=torch.int32).to(dev)
        covered = torch.as_tensor(rng.rand(P) > 0.3).to(dev)
        errs["gather_rows"] = max(errs["gather_rows"], check_gather(
            "fuzz", attr, winner, covered))
    return errs, prod


def run_slice(tracker, pose0, rgb, depth, n_on, n_video):
    """Phase 4, the main path: ``on_track`` over ``n_on`` frames, then
    ``track_video`` over ``n_video`` frames from the same start, each timed
    on the host clock with the poses on the host at the end. The kernels'
    launch counts are zeroed just before and read just after. Returns
    (launches, on_track poses, track_video poses, on_s, video_s)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    dev = tracker.device
    frames_rgb = trk.upload_rgb(np.stack([rgb] * n_video), dev)
    frames_depth = trk.upload_depth(np.stack([depth] * n_video), dev)
    for _ in range(3):  # warm-up: cuDNN algorithm choice, allocator
        tracker.on_track(pose0, rgb, depth)
    sync(dev)
    zero_launches()
    pose, on_poses = pose0, []
    t0 = time.perf_counter()
    for _ in range(n_on):
        pose = tracker.on_track(pose, rgb, depth)
        on_poses.append(pose)
    on_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    video = trk.track_video(
        tracker.model, tracker.cfg, tracker.mesh, tracker.K, tracker.mean,
        tracker.std, torch.as_tensor(pose0).to(dev), frames_rgb,
        frames_depth).cpu().numpy()
    video_s = time.perf_counter() - t0
    return read_launches(), np.stack(on_poses), video, on_s, video_s


def check_on_object(runs, pose0, width_mm):
    """Every run's poses are finite and every step stays on the object:
    the ROI it crops and renders (the bbox of the pose it starts from) holds
    the centre of the observed object, which sits at ``pose0``. Prints each
    run's drift from the start and the smallest margin of that centre to
    the ROI's edge, as a share of the ROI's half-width, before it raises."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.ops import roi

    c = K_PROD @ pose0[:3, 3]
    u0, v0 = c[0] / c[2], c[1] / c[2]
    K = torch.as_tensor(K_PROD)
    bad = []
    for name, poses in runs.items():
        drift = np.linalg.norm(poses[:, :3, 3] - pose0[:3, 3], axis=1)
        margin = 1.0
        for prev in np.concatenate([pose0[None], poses[:-1]]):
            b = roi.compute_bbox(torch.as_tensor(prev), K, width_mm,
                                 (1000.0, 1000.0, 1000.0)).numpy()
            (top, left), (bottom, right) = b.min(0), b.max(0)
            half_u, half_v = (right - left) / 2, (bottom - top) / 2
            margin = min(margin, (half_u - abs(u0 - (left + right) / 2))
                         / half_u, (half_v - abs(v0 - (top + bottom) / 2))
                         / half_v)
        print(f"{name}: {len(poses)} poses, finite="
              f"{np.isfinite(poses).all()}, max drift from the start "
              f"{drift.max() * 1000:.3f} mm, object centre inside every ROI "
              f"with a margin of at least {margin:.3f} of its half-width, "
              f"last t={poses[-1, :3, 3].tolist()}", flush=True)
        if not np.isfinite(poses).all() or margin < 0:
            bad.append(name)
    if bad:
        raise AssertionError(f"{bad}: poses not finite, or a step's ROI "
                             "lost the object")


def compare_with_cpu(net, tracker, pose0, rgb, depth, n):
    """The same ``n`` frames through ``track_video`` on the card and on the
    port's plain CPU path: within 5e-4 m and 5e-3 rad per frame."""
    t0 = time.perf_counter()
    gpu = tracker.track_video(pose0, np.stack([rgb] * n),
                              np.stack([depth] * n))
    cpu = make_tracker(net, "cpu").track_video(
        pose0, np.stack([rgb] * n), np.stack([depth] * n))
    dt = float(np.abs(gpu[:, :3, 3] - cpu[:, :3, 3]).max())
    dr = max(rot_angle(g[:3, :3], c[:3, :3]) for g, c in zip(gpu, cpu))
    print(f"card vs plain CPU path, {n} frames: max |dt| {dt:.3e} m, max "
          f"rotation {dr:.3e} rad ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    if dt > 5e-4 or dr > 5e-3:
        raise AssertionError("card and CPU trajectories disagree")


def step_parts(tracker, pose0, rgb, depth, prod_case):
    """Callables for the parts of one production step, on its inputs:
    crop + normalize, pass 1 (K1), pass 2 (``pass2_shade``), the earlier
    unfused pass 2 (K2 gather + ``shade_rows``), the whole render, the CNN
    and the whole step."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.models import tracknet
    from iros20_6d_pose_tracking_tpu_torch.ops import roi
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    t, cfg, dev = tracker, tracker.cfg, tracker.device
    c = prod_case
    pose = torch.as_tensor(pose0).to(dev)
    rgb_t, depth_t = trk.upload_rgb(rgb, dev), trk.upload_depth(depth, dev)
    _, aux = trk.track_step(t.model, cfg, t.mesh, t.K, t.mean, t.std, pose,
                            rgb_t, depth_t)
    bufA, bufB = tracknet.normalize_pair(aux["rgbA"], aux["depthA"],
                                         aux["rgbB"], aux["depthB"], pose,
                                         t.mean, t.std)
    window = rz.window_from_bbox(roi.compute_bbox(
        pose, t.K, cfg.object_width_mm, (1000.0, 1000.0, 1000.0)))

    def crop_normalize():
        bbox = roi.compute_bbox(pose, t.K, cfg.object_width_mm,
                                (1000.0, 1000.0, 1000.0))
        rgbB, depthB = roi.crop_bbox(rgb_t, depth_t, bbox, (RES, RES))
        return tracknet.normalize_pair(aux["rgbA"], aux["depthA"],
                                       rgbB.float(), depthB.float(), pose,
                                       t.mean, t.std)

    def pass2():
        return rk.pass2_shade(c["attr"], c["iz"], c["win"], c["R"], c["t"],
                              (RES, RES), FAR)

    def pass2_unfused():
        with unfused_pass2():
            return pass2()

    @torch.no_grad()
    def cnn():
        return t.model(bufA[None], bufB[None])

    return {
        "crop_normalize": crop_normalize,
        "pass1": lambda: rk.pass1_winners(c["coef"], c["bbox"], (RES, RES),
                                          c["fb"]),
        "pass2 (pass2_shade)": pass2,
        "pass2 unfused (K2 + shade_rows, before)": pass2_unfused,
        "render": lambda: rz.render(
            t.mesh, pose, t.K, window, out_hw=(RES, RES),
            cull_backfaces=cfg.cull_backfaces),
        "cnn": cnn,
        "step": lambda: trk.track_step(t.model, cfg, t.mesh, t.K, t.mean,
                                       t.std, pose, rgb_t, depth_t),
    }


def full_frame_case(mesh, pose, fb=None):
    """The inputs (``render_case``) of one unculled full-frame render
    (FRAME_HW, K_PROD) of ``mesh`` at ``pose``, at face block ``fb`` or
    ``pick_face_block``."""
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    return render_case(mesh, pose, K_PROD,
                       rz.full_frame_window(FRAME_HW[1], FRAME_HW[0]),
                       FRAME_HW, cull=False, fb=fb)


def check_worklist(name, coef, bbox, hw, fb):
    """K3 against its plain version and against K1 on the same inputs:
    winners equal, iz bit-equal; prints the (patch, chunk) items K3's list
    holds. Returns (max |iz difference| to the plain version, iz, winner)
    of the kernel."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk

    iz, win = rk.pass1_worklist(coef, bbox, hw, fb)
    refs = {"plain K3": rk.pass1_worklist_ref(coef, bbox, hw, fb),
            "K1": rk.pass1_winners(coef, bbox, hw, fb)}
    bad = {}
    for ref_name, (iz_ref, win_ref) in refs.items():
        bad[ref_name] = (
            int((win != win_ref).sum()),
            int((iz.view(torch.int32) != iz_ref.view(torch.int32)).sum()))
    err = float((iz - refs["plain K3"][0]).abs().max())
    items = rk.worklist_items(bbox, hw, coef.shape[1], fb).shape[0]
    print(f"K3 {name}: F={coef.shape[1]} fb={fb} hw={hw} items={items} "
          f"covered={int((iz > 0).sum())} (winner, iz bit) mismatches {bad} "
          f"max|d iz|={err}", flush=True)
    if any(n for pair in bad.values() for n in pair):
        raise AssertionError(f"K3 disagrees ({name}): {bad}")
    return err, iz, win


def tied_case(rng, copies, fb, hw, device):
    """``fuzz_case``'s random triangles of one face block, repeated in blocks
    0 .. copies - 1 at the same lanes: every covered pixel's key ties across
    all blocks, so every item of a busy patch collides on equal keys.
    Returns (coef, block_bbox)."""
    coef, bbox = fuzz_case(rng, fb, hw, fb, device)
    return coef.repeat(1, copies), bbox.repeat(copies, 1)


def check_worklist_cases(tracker, pose0):
    """Phase 3, K3: full 480x640 frames of the production mesh (unculled,
    face block 1024) and of a 20,480-face icosphere at face block 256, random
    ragged cases, sliver triangles, a full frame whose 8 face blocks tie
    (block 0's face must win) and an empty frame; and pass 2 fused on the
    production mesh's full frame. Returns K3's and pass 2's max errors and
    the two full-frame meshes' cases (with K3's outputs iz, win)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    dev = tracker.device
    big = rz.upload(M.make_icosphere(subdiv=5, radius=0.05), dev)
    cases = {"production": full_frame_case(tracker.mesh, pose0),
             "icosphere20480": full_frame_case(big, pose0, 256)}
    err = 0.0
    for name, c in cases.items():
        e, c["iz"], c["win"] = check_worklist(
            f"{name} full frame", c["coef"], c["bbox"], FRAME_HW, c["fb"])
        err = max(err, e)
        if not (c["iz"] > 0).any():
            raise AssertionError(f"K3 case {name} covers no pixel")
    err2 = check_pass2("production full frame", cases["production"],
                       FRAME_HW)
    rng = np.random.RandomState(SEED + 1)
    for kind, F, hw, fb in (("random", 768, (37, 53), 256),
                            ("random", 1500, (131, 97), 512),
                            ("random", 3072, (479, 641), 1024),
                            ("slivers", 1000, (131, 97), 512)):
        coef, bbox = fuzz_case(rng, F, hw, fb, dev, kind)
        err = max(err, check_worklist(kind, coef, bbox, hw, fb)[0])
    copies, fb = 8, 256
    coef, bbox = tied_case(rng, copies, fb, FRAME_HW, dev)
    e, iz, win = check_worklist(f"{copies} tied blocks", coef, bbox,
                                FRAME_HW, fb)
    err = max(err, e)
    if not bool((iz > 0).any()) or not bool((win[iz > 0] < fb).all()):
        raise AssertionError("K3 tied blocks: no pixel covered, or a winner "
                             "outside block 0")
    away = pose0.copy()
    away[0, 3] = 3.0  # far off the right edge of the frame
    c = full_frame_case(tracker.mesh, away)
    e, iz, win = check_worklist("empty frame", c["coef"], c["bbox"],
                                FRAME_HW, c["fb"])
    if not (bool((iz == -1.0).all()) and not bool(win.any())):
        raise AssertionError("K3 empty frame: not the init values")
    if tracker.device.type == "cuda":
        torch.cuda.synchronize(dev)
    return max(err, e), err2, cases


def make_bench_object(tracker, tm):
    """The evaluation path's object: the chip_smoke tracker's network,
    statistics, mesh and config around the production TriMesh."""
    from iros20_6d_pose_tracking_tpu_torch.eval import synthetic_benchmark as SB

    return SB.BenchObject(
        name="production", tm=tm, mesh=tracker.mesh, model=tracker.model,
        mean=tracker.mean, std=tracker.std,
        width_mm=tracker.cfg.object_width_mm, tcfg=tracker.cfg)


def run_eval(obj, gt):
    """Phase 5, the evaluation path through the entry points a user calls:
    the hard test video of ``gt`` at FRAME_HW, quantized, then
    ``evaluate_tracking``. The kernels' launch counts are zeroed just before
    and read just after. Returns (launches, quantized frames, result,
    render s, evaluate s), each time on the host clock around work that
    ends on the host."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.eval import synthetic_benchmark as SB

    if obj.mesh.fverts.device.type == "cuda":
        torch.cuda.synchronize(obj.mesh.fverts.device)
    zero_launches()
    t0 = time.perf_counter()
    frames = SB._quantize(*SB.render_test_video(obj.mesh, gt, K_PROD,
                                                hw=FRAME_HW, hard=True))
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = SB.evaluate_tracking(obj, gt, *frames, K=K_PROD)
    eval_s = time.perf_counter() - t0
    return read_launches(), frames, result, render_s, eval_s


def check_eval(launches, result, T):
    """Finite poses and scores, and the launch counts of a T-frame hard
    video (object and occluder per frame) tracked over T - 1 frames."""
    want = {"raster_pass1": T - 1, "gather_rows": 0,
            "raster_pass1_worklist": 2 * T, "pass2_shade": 2 * T + T - 1}
    scores = {k: result[k] for k in ("add_auc", "adi_auc", "add_mean_mm",
                                     "add_max_mm", "final_trans_err_mm",
                                     "baseline_add_mean_mm",
                                     "baseline_add_auc")}
    print(f"evaluation path: {T} frames, launches {launches} (want {want}); "
          + ", ".join(f"{k} {v:.4f}" for k, v in scores.items()), flush=True)
    if launches != want:
        raise AssertionError(f"evaluation launch counts {launches} != {want}")
    finite = (np.isfinite(result["poses"]).all()
              and np.isfinite(result["add"]).all()
              and np.isfinite(result["adi"]).all()
              and np.isfinite(list(scores.values())).all())
    if not finite or result["poses"].shape != (T, 4, 4):
        raise AssertionError("evaluation poses or scores not finite")


def compare_eval_with_cpu(cpu_obj, gt, frames, result):
    """The card's evaluation path against the port's plain CPU path: the
    first CPU_RENDER_FRAMES quantized frames, the card's trajectory scored
    on the CPU, and CPU_TRACK_FRAMES frames tracked on both sides."""
    from iros20_6d_pose_tracking_tpu_torch.eval import synthetic_benchmark as SB

    t0 = time.perf_counter()
    n = CPU_RENDER_FRAMES
    rgb_c, dep_c = SB._quantize(*SB.render_test_video(
        cpu_obj.mesh, gt[:n], K_PROD, hw=FRAME_HW, hard=True))
    rgb_g, dep_g = frames[0][:n], frames[1][:n]
    rgb_off = float((np.abs(rgb_c.astype(np.int32) - rgb_g.astype(np.int32))
                     .max(-1) > 1).mean())
    cov_off = float(((dep_c > 0) != (dep_g > 0)).mean())
    scored = SB._score_poses(cpu_obj, gt, result["poses"])
    d_score = max(float(np.abs(scored[k] - result[k]).max())
                  for k in ("add", "adi"))
    m = CPU_TRACK_FRAMES
    tracked = SB.evaluate_tracking(cpu_obj, gt[:m + 1], frames[0][:m + 1],
                                   frames[1][:m + 1], K=K_PROD)["poses"]
    card = result["poses"][:m + 1]
    dt = float(np.abs(tracked[:, :3, 3] - card[:, :3, 3]).max())
    dr = max(rot_angle(a[:3, :3], b[:3, :3]) for a, b in zip(tracked, card))
    print(f"evaluation card vs plain CPU path: first {n} frames rgb >1 level "
          f"apart on {rgb_off:.2e} of pixels, depth coverage differs on "
          f"{cov_off:.2e}; card trajectory scored on the CPU: max |d ADD|, "
          f"|d ADD-S| {d_score:.3e} m; {m} tracked frames: max |dt| "
          f"{dt:.3e} m, max rotation {dr:.3e} rad "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if rgb_off >= 1e-3 or cov_off >= 1e-3 or d_score > 1e-6 or dt > 5e-4 \
            or dr > 5e-3:
        raise AssertionError("card and CPU evaluation paths disagree")


def time_eval(obj, gt, poses, ff_cases, card):
    """Phase 6, the evaluation path's timings: K3 (``report_kernel``)
    beside K1 on the full-frame inputs, each wrapper's host time and device
    operations per call (the latter from ``torch.profiler``; K3 held to
    K3_MAX_OPS), pass 2 fused on the
    production full frame, a full-frame render through K3 and through K1 in
    turns (CUDA events, median of TIMING_RUNS each, RENDER_PAIRS pairs), the
    warm ``render_test_video`` and ``evaluate_tracking`` rates (host clock),
    and ``batch_errors``. Returns K3's kernels-line numbers on the
    production mesh."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.eval import metrics as ME
    from iros20_6d_pose_tracking_tpu_torch.eval import synthetic_benchmark as SB
    from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    dev = obj.mesh.fverts.device
    out = {}
    for name, c in ff_cases.items():
        coef, bbox, fb = c["coef"], c["bbox"], c["fb"]
        label = (f"full frame {FRAME_HW[0]}x{FRAME_HW[1]} {name} "
                 f"(F={coef.shape[1]}, fb={fb})")
        out[name] = report_kernel(
            "raster_pass1_worklist", label,
            lambda: rk.pass1_worklist(coef, bbox, FRAME_HW, fb),
            lambda: rk.pass1_worklist_ref(coef, bbox, FRAME_HW, fb),
            pass1_bound(c, FRAME_HW), card, plain_runs=K3_PLAIN_RUNS)
        k3_fn = functools.partial(rk.pass1_worklist, coef, bbox, FRAME_HW, fb)
        k1_fn = functools.partial(rk.pass1_winners, coef, bbox, FRAME_HW, fb)
        k1, k1_dev = run_ms(k1_fn), device_ms(k1_fn, "raster_pass1")
        k3_dev = out[name]["device_ms"]
        print(f"timing kernel raster_pass1 {label}: {k1:.5f} ms per launch "
              f"(CUDA events around {TIMING_RUNS} queued launches), device "
              f"{'not measured' if k1_dev is None else f'{k1_dev:.5f} ms'} "
              f"(profiler); K3's kernel on the same inputs "
              f"{'not measured' if k3_dev is None else f'{k3_dev:.5f} ms'} "
              f"{card}", flush=True)
        print(f"timing host per call {label}: K3 {host_ms(k3_fn):.4f} ms, "
              f"K1 {host_ms(k1_fn):.4f} ms (host clock over {TIMING_RUNS} "
              f"calls enqueued back to back) {card}", flush=True)
        for label, fn in (("K3", rk.pass1_worklist), ("K1", rk.pass1_winners)):
            # The profiler now and then records nothing; K3's count is
            # enforced, so it gets three tries.
            for _ in range(3 if label == "K3" else 1):
                prof = profile_share(lambda: [fn(coef, bbox, FRAME_HW, fb)
                                              for _ in range(PROFILE_CALLS)],
                                     top=4)
                if prof is not None:
                    break
            if prof is None:
                print(f"profile: {label} {name}: no device time recorded")
                if label == "K3":
                    raise AssertionError("K3's device operations per call "
                                         "not measured")
                continue
            busy_us, wall_us, n_ops, rows = prof
            print(f"profile: {label} {name} x{PROFILE_CALLS}: device busy "
                  f"{busy_us / 1e3 / PROFILE_CALLS:.4f} ms of "
                  f"{wall_us / 1e3 / PROFILE_CALLS:.4f} ms wall per call, "
                  f"{n_ops / PROFILE_CALLS:.0f} device ops per call; top: "
                  + "; ".join(f"{us / 1e3 / count:.4f} ms x{count} "
                              f"{key[:60]}" for key, us, count in rows)
                  + f" {card}", flush=True)
            if label == "K3" and n_ops > K3_MAX_OPS * PROFILE_CALLS:
                raise AssertionError(
                    f"K3 makes {n_ops / PROFILE_CALLS} device operations per "
                    f"call, more than {K3_MAX_OPS}")
    c = ff_cases["production"]
    report_kernel("pass2_shade", f"full frame {FRAME_HW[0]}x{FRAME_HW[1]} "
                  "production",
                  lambda: rk.pass2_shade(c["attr"], c["iz"], c["win"], c["R"],
                                         c["t"], FRAME_HW, FAR),
                  lambda: rk.pass2_shade_ref(c["attr"], c["iz"], c["win"],
                                             c["R"], c["t"], FRAME_HW, FAR),
                  pass2_bound(c), card)
    pose = torch.as_tensor(gt[0]).to(dev)
    K = torch.as_tensor(K_PROD).to(dev)
    window = rz.full_frame_window(FRAME_HW[1], FRAME_HW[0])
    ms = {"K3": [], "K1": []}
    for i in range(RENDER_PAIRS):
        for which in (("K3", "K1") if i % 2 == 0 else ("K1", "K3")):
            ms[which].append(cuda_ms(lambda: rz.render(
                obj.mesh, pose, K, window, out_hw=FRAME_HW,
                worklist=which == "K3")))
    faster = sum(a <= b for a, b in zip(ms["K3"], ms["K1"]))
    print(f"timing full-frame render in turns (production mesh, median of "
          f"{TIMING_RUNS} each, pairs in the order K3 K1, K1 K3, ...): "
          f"through K3 {[round(m, 4) for m in ms['K3']]} ms, through K1 "
          f"{[round(m, 4) for m in ms['K1']]} ms; K3 no slower in {faster} "
          f"of {RENDER_PAIRS} pairs {card}", flush=True)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    frames = SB._quantize(*SB.render_test_video(obj.mesh, gt, K_PROD,
                                                hw=FRAME_HW, hard=True))
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    SB.evaluate_tracking(obj, gt, *frames, K=K_PROD)
    eval_s = time.perf_counter() - t0
    print(f"timing render_test_video (hard, quantized to the host): "
          f"{len(gt) / render_s:.2f} frames/s ({len(gt)} frames, warm) {card}")
    print(f"timing evaluate_tracking: {(len(gt) - 1) / eval_s:.2f} frames/s "
          f"({len(gt) - 1} tracked frames and their scores, warm) {card}")
    cloud = M.voxel_down_sample(obj.tm.verts, 0.005)
    ms = cuda_ms(lambda: ME.batch_errors(poses, gt, cloud, device=dev))
    print(f"timing batch_errors: {ms:.4f} ms ({len(gt)} frames, "
          f"{len(cloud)} points, median of {TIMING_RUNS}) {card}", flush=True)
    return out["production"]


def sampler_views_case(mesh, width_mm, n_pairs, device, seed):
    """The inputs (``render_case``) of the 2 x ``n_pairs`` views one
    training-sampler batch renders (poses from ``draw_synth`` on a CPU
    generator; A views, then B views, both in A's window) of ``mesh`` at
    RES^2, unculled, as ``data/dataset.py::render_pairs`` builds them:
    coef (2n, 12, F), attr (2n, F, C), R (2n, 3, 3), t (2n, 3), ..."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.data import dataset as DS
    from iros20_6d_pose_tracking_tpu_torch.ops import roi
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    d = DS.draw_synth(torch.Generator().manual_seed(seed), n_pairs, RES, None,
                      device)
    A, B = DS.sample_poses(d, TRAIN_XYZ, 0.02, 15.0)
    K = torch.as_tensor(K_PROD).to(device)
    window = rz.window_from_bbox(roi.compute_bbox(A, K, width_mm,
                                                  (1000.0, 1000.0, 1000.0)))
    return render_case(mesh, torch.cat([A, B]), K,
                       torch.cat([window, window]), (RES, RES), cull=False)


def check_sampler_views(name, case):
    """Batched K1 (one launch) on a sampler batch's views against its plain
    version and the per-view calls, then batched K2 and ``pass2_shade``
    (one launch each) on the same views' attribute forms and K1's outputs
    against their plain versions. Keeps K1's outputs in the case (iz,
    win). Returns (K1 error, K2 error, pass 2 error)."""
    import torch


    coef, attr = case["coef"], case["attr"]
    e1, iz, win = check_batched_pass1(name, coef, case["bbox"], (RES, RES),
                                      case["fb"])
    case.update(iz=iz, win=win)
    n = coef.shape[0]
    winner = torch.clamp(win, 0, coef.shape[-1] - 1).reshape(n, -1)
    covered = (iz > 1e-9).reshape(n, -1)
    n0 = read_launches()
    e2 = check_gather(f"batched {name}", attr, winner, covered)
    e3 = check_pass2(f"batched {name}", case, (RES, RES))
    n1 = read_launches()
    if attr.is_cuda and (n1["gather_rows"], n1["pass2_shade"]) != (
            n0["gather_rows"] + 1, n0["pass2_shade"] + 1):
        raise AssertionError("batched K2 or pass2_shade was not one launch")
    return e1, e2, e3


def check_batched_pass1(name, coef, bbox, hw, fb):
    """Batched K1 (one launch) against its plain version and against the
    call on each view alone: winners equal, iz bit-equal. Returns (max |iz
    difference|, iz, winner)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk

    n0 = launches_of("pass1_winners")
    iz, win = rk.pass1_winners(coef, bbox, hw, fb)
    if coef.is_cuda and launches_of("pass1_winners") != n0 + 1:
        raise AssertionError("batched K1 was not one launch")
    refs = {"plain": rk.pass1_winners_ref(coef, bbox, hw, fb),
            "one view at a time": tuple(torch.stack(a) for a in zip(*(
                rk.pass1_winners(c, b, hw, fb) for c, b in zip(coef, bbox))))}
    bad = {}
    for ref_name, (iz_ref, win_ref) in refs.items():
        bad[ref_name] = (
            int((win != win_ref).sum()),
            int((iz.view(torch.int32) != iz_ref.view(torch.int32)).sum()))
    err = float((iz - refs["plain"][0]).abs().max())
    covered = [int(c) for c in (iz > 0).sum(dim=(1, 2))]
    shown = covered if len(covered) <= BATCHED_VIEWS else \
        f"{min(covered)}-{max(covered)}"
    print(f"K1 batched {name}: B={coef.shape[0]} F={coef.shape[-1]} fb={fb} "
          f"hw={hw} covered per view={shown} (winner, iz bit) mismatches "
          f"{bad} max|d iz|={err}", flush=True)
    if any(n for pair in bad.values() for n in pair):
        raise AssertionError(f"batched K1 disagrees ({name}): {bad}")
    if min(covered) == 0:
        raise AssertionError(f"batched K1 case {name}: a view covers nothing")
    return err, iz, win


def check_batched_kernels(tracker):
    """Phase 3, the batch axis: K1, K2 and ``pass2_shade`` on the 8 views
    of a 4-pair sampler batch of the production mesh, and K1 on a ragged
    random batch and K2 on a ragged random batch of views. Returns (max K1
    error, max K2 error, max pass 2 error, the production views' case)."""
    import torch

    dev = tracker.device
    case = sampler_views_case(tracker.mesh, tracker.cfg.object_width_mm,
                              BATCHED_VIEWS // 2, dev, SEED)
    e1, e2, e3 = check_sampler_views("sampler views", case)
    rng = np.random.RandomState(SEED + 2)
    hw = (131, 97)
    cases = [fuzz_case(rng, 1500, hw, 512, dev) for _ in range(5)]
    e1 = max(e1, check_batched_pass1(
        "fuzz", torch.stack([c for c, _ in cases]),
        torch.stack([b for _, b in cases]), hw, 512)[0])
    attr_f = torch.as_tensor(rng.randn(3, 700, 36) * 100,
                             dtype=torch.float32).to(dev)
    win_f = torch.as_tensor(rng.randint(0, 700, (3, 7013)),
                            dtype=torch.int32).to(dev)
    cov_f = torch.as_tensor(rng.rand(3, 7013) > 0.3).to(dev)
    e2 = max(e2, check_gather("batched fuzz", attr_f, win_f, cov_f))
    return e1, e2, e3, case


def train_setup(device, res=RES):
    """The phase-7 sampler (cube, DR, production intrinsics) on
    ``device`` at ``res``^2, and its TrainConfig."""
    from iros20_6d_pose_tracking_tpu_torch.data import dataset as DS
    from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
    from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

    tm = M.make_cube(0.08)
    synth = DS.SyntheticPairs(
        rz.upload(tm, device), K_PROD, resolution=res,
        object_width_mm=tm.diameter * 1000 * 1.1, max_trans=0.02,
        max_rot_deg=15.0, xyz_range=TRAIN_XYZ, dr=DS.DRComposite())
    return tm, synth, tr.TrainConfig(resolution=res, batch_size=TRAIN_BATCH)


def run_train(synth, cfg, dev):
    """Phase 7, the training path through the entry points a user calls:
    ``compute_mean_std`` over MEAN_STD_BATCHES sampled batches, then
    TRAIN_STEPS ``train_step_synth`` steps from Flax's initialisers, each
    between two CUDA events. The kernels' launch counts are zeroed just
    before and read just after. Returns (launches, model, optimizer, mean,
    std, losses, step ms)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.models import tracknet
    from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

    model = tracknet.init_params(tracknet.Se3TrackNet(image_size=RES).to(dev),
                                 torch.Generator().manual_seed(SEED))
    opt, lr_at = tr.make_optimizer(model, cfg, steps_per_epoch=1000)
    torch.cuda.synchronize(dev)
    zero_launches()
    t0 = time.perf_counter()
    mean, std = tr.compute_mean_std(
        (synth.sample_batch(tr.step_generator(dev, 900, i), cfg.batch_size)
         for i in range(MEAN_STD_BATCHES)),
        cfg, dev, max_samples=MEAN_STD_BATCHES * cfg.batch_size)
    print(f"train: compute_mean_std over {MEAN_STD_BATCHES} batches of "
          f"{cfg.batch_size}: {time.perf_counter() - t0:.3f} s; mean "
          f"{np.round(mean, 3).tolist()}, std {np.round(std, 3).tolist()}",
          flush=True)
    mean = torch.as_tensor(mean, dtype=torch.float32).to(dev)
    std = torch.as_tensor(std, dtype=torch.float32).to(dev)
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = tr.train_step_synth(model, opt, lr_at(i), cfg, synth,
                                tr.step_generator(dev, 7, i),
                                tr.step_generator(dev, 7, 10**6 + i),
                                mean, std)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    return read_launches(), model, opt, mean, std, losses, step_ms


def _tree_to(d, device):
    if isinstance(d, dict):
        return {k: _tree_to(v, device) for k, v in d.items()}
    return d.to(device)


def random_raw_batch(res, n, seed):
    """A raw pair batch on the CPU of the kind the JAX parity test uses:
    RGB uniform in [0, 255], depth uniform in [300, 900] mm with 30% of the
    pixels invalid, A at random rotations within the view ranges, B = A
    perturbed by the sampler's pose perturbation."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.core import se3

    rng = np.random.RandomState(seed)
    A = se3.make_pose(
        se3.so3_exp(torch.as_tensor(rng.randn(n, 3), dtype=torch.float32)),
        torch.as_tensor(rng.uniform([-0.05, -0.05, 0.45], [0.05, 0.05, 0.7],
                                    (n, 3)), dtype=torch.float32))
    d = se3.draw_gaussian_magnitude(torch.Generator().manual_seed(seed),
                                    (n,), "cpu")
    depth = rng.uniform(300, 900, (2, n, res, res)).astype(np.float32)
    depth[rng.rand(*depth.shape) < 0.3] = 0.0
    return {"rgbA": torch.as_tensor(rng.uniform(0, 255, (n, res, res, 3)),
                                    dtype=torch.float32),
            "depthA": torch.from_numpy(depth[0]),
            "rgbB": torch.as_tensor(rng.uniform(0, 255, (n, res, res, 3)),
                                    dtype=torch.float32),
            "depthB": torch.from_numpy(depth[1]),
            "maskB": torch.from_numpy(depth[1] > 100),
            "A_in_cam": A,
            "B_in_cam": A @ se3.apply_gaussian_magnitude(d, 0.02, 15.0)}


def sampled_on_both(synth_cpu, synth_dev, n, seed):
    """One sampler batch of ``n`` pairs from draws on a CPU generator,
    rendered on the CPU and on ``synth_dev``'s device. Returns the CPU
    batch; raises unless RGB more than 1 level apart and depth coverage
    differ on under 0.1% of pixels each."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.data import dataset as DS

    cpu = torch.device("cpu")
    d = DS.draw_synth(torch.Generator().manual_seed(seed), n,
                      synth_cpu.resolution, synth_cpu.dr, cpu)
    raws = {}
    for s in (synth_cpu, synth_dev):
        dd = _tree_to(d, s.device)
        A, B = DS.sample_poses(dd, TRAIN_XYZ, 0.02, 15.0)
        raws[s.device.type] = _tree_to(DS.render_pairs(
            s.mesh, s.K, A, B, s.resolution, s.object_width_mm, s.dr,
            dd["dr"]), cpu)
    rc, rg = raws["cpu"], raws[synth_dev.device.type]
    rgb_off = max(float((torch.abs(rc[k] - rg[k]).amax(-1) > 1.0)
                        .float().mean()) for k in ("rgbA", "rgbB"))
    cov_off = max(float(((rc[k] > 0) != (rg[k] > 0)).float().mean())
                  for k in ("depthA", "depthB"))
    print(f"train card vs plain CPU path: sampled batch of {n} at "
          f"{synth_cpu.resolution}^2 with DR: rgb >1 level apart on "
          f"{rgb_off:.2e} of pixels, depth coverage differs on {cov_off:.2e}",
          flush=True)
    if rgb_off >= 1e-3 or cov_off >= 1e-3:
        raise AssertionError("card and CPU sampler batches disagree")
    return rc


def sampled_check_batch(dev, res, n):
    """The "sampled" train check's batch (``sampled_on_both``, seeded SEED
    + 5), its augmentation config and its statistics: (raw, aug_cfg, mean,
    std), on the CPU."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.data import augment as AUG

    _, synth_cpu, _ = train_setup(torch.device("cpu"), res)
    _, synth_dev, _ = train_setup(dev, res)
    raw = sampled_on_both(synth_cpu, synth_dev, n, SEED + 5)
    mean = torch.tensor([80, 80, 80, 0, 80, 80, 80, 0], dtype=torch.float32)
    std = torch.tensor([60, 60, 60, 100, 60, 60, 60, 100],
                       dtype=torch.float32)
    return raw, AUG.AugmentConfig(), mean, std


def train_run(base, raw, draws, mean, std, cfg, steps, device,
              onednn=True):
    """``steps`` train steps of a copy of ``base`` on ``device`` at
    ``cfg.learning_rate``, on one raw batch with the given augmentation
    draws. ``onednn=False`` runs the CPU's convolutions without oneDNN
    (another summation order). Returns (losses, each step's gradients, the
    state after each step), on the CPU."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.train import compare
    from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

    with torch.backends.mkldnn.flags(enabled=onednn):
        model = copy.deepcopy(base).to(device)
        opt, lr_at = tr.make_optimizer(model, cfg, steps_per_epoch=1000)
        losses, grads, states = [], [], []
        for i in range(steps):
            m = tr.train_step(model, opt, lr_at(i), cfg, None,
                              _tree_to(raw, device), mean.to(device),
                              std.to(device),
                              aug_draws=_tree_to(draws[i], device))
            losses.append(float(m["loss"]))
            grads.append(compare.grads_of(model))
            states.append({k: v.to("cpu", copy=True)
                           for k, v in model.state_dict().items()})
    return losses, grads, states


def compare_train_with_cpu(dev):
    """Phase 7, train steps on the card against the port's plain CPU path,
    from the same weights on the same batch and augmentation draws
    (TRAIN_CHECKS): at 48^2 on a random batch without augmentation, as the
    JAX parity test runs, under its bars, and at RES^2 on a sampled batch
    with the augmentation. There, beside the card, the CPU path with its
    convolutions out of oneDNN (another summation order) is held to the
    same bars against the CPU path: the witness that those bars are
    float32's own noise at that size. For each check and each run (lr,
    steps): losses, the first step's gradients and the state after
    ``state_after`` steps under ``train/compare.py``'s bars."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.data import augment as AUG
    from iros20_6d_pose_tracking_tpu_torch.models import tracknet
    from iros20_6d_pose_tracking_tpu_torch.train import compare
    from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    n = CPU_TRAIN_BATCH
    bad = []
    for name, check in TRAIN_CHECKS.items():
        res = check["res"]
        if check["sampled"]:
            raw, aug_cfg, mean, std = sampled_check_batch(dev, res, n)
        else:
            raw = random_raw_batch(res, n, SEED + 5)
            aug_cfg = AUG.AugmentConfig(
                hsv_prob=0.0, noise_prob=0.0, blur_prob=0.0,
                black_cover_prob=0.0, bright_mag=(1.0, 1.0))
            mean = torch.tensor([120, 110, 100, 0, 120, 110, 100, 0],
                                dtype=torch.float32)
            std = torch.tensor([70, 70, 70, 300, 70, 70, 70, 300],
                               dtype=torch.float32)
        base = tracknet.init_params(tracknet.Se3TrackNet(image_size=res),
                                    torch.Generator().manual_seed(SEED + 6))
        for lr, steps, state_after, loss_rtol, noisy_share in check["runs"]:
            cfg = tr.TrainConfig(resolution=res, batch_size=n,
                                 learning_rate=lr, aug=aug_cfg)
            draws = [AUG.draw_augment(
                torch.Generator().manual_seed(SEED + 10 + i), n, (res, res),
                cfg.aug, cpu) for i in range(steps)]
            ref = train_run(base, raw, draws, mean, std, cfg, steps, cpu)
            sides = {"card": (dev, True)}
            if check["witness"]:
                sides["CPU without oneDNN"] = (cpu, False)
            for side, (device, onednn) in sides.items():
                run = train_run(base, raw, draws, mean, std, cfg, steps,
                                device, onednn)
                loss_rel = max(abs(a - b) / abs(b)
                               for a, b in zip(run[0], ref[0]))
                grads = compare.compare_grads(base, run[1][0], ref[1][0],
                                              **check["grads"])
                states = compare.compare_states(
                    base, run[2][state_after - 1], ref[2][state_after - 1],
                    compare.noisy(run[1][:state_after], ref[1][:state_after]),
                    lr, state_after, noisy_share=noisy_share,
                    **check["states"])
                print(f"train {side} vs plain CPU path, {name} batch of {n} "
                      f"at {res}^2, {steps} steps at lr {lr}: losses "
                      f"{run[0]} vs {ref[0]} (max rel diff {loss_rel:.3e}, "
                      f"bar {loss_rtol}); first-step gradients (tensors, "
                      f"worst / bar, at) {grads}; state after step "
                      f"{state_after} {states}", flush=True)
                if loss_rel > loss_rtol or compare.failed(grads, states):
                    bad.append((side, name, lr))
    print(f"train card vs plain CPU path: {time.perf_counter() - t0:.1f} s",
          flush=True)
    if bad:
        raise AssertionError(f"train steps disagree with the CPU path: {bad}")


def track_trained(tm, model, mean, std, dev):
    """Phase 7, closing the loop: the trained state saved as a training
    checkpoint, loaded by ``Tracker(ckpt_dir=...)`` on the card, tracks 10
    frames of a clean rendered video. Returns the poses."""
    import tempfile

    import torch

    from iros20_6d_pose_tracking_tpu_torch.eval import synthetic_benchmark as SB
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
    from iros20_6d_pose_tracking_tpu_torch.train import checkpoint as ck

    info = {"resolution": RES, "object_width": tm.diameter * 1000 * 1.1,
            "camera": {"focalX": float(K_PROD[0, 0]),
                       "focalY": float(K_PROD[1, 1]),
                       "centerX": float(K_PROD[0, 2]),
                       "centerY": float(K_PROD[1, 2])}}
    gt = SB.make_gt_trajectory(11)
    frames = SB._quantize(*SB.render_test_video(rz.upload(tm, dev), gt,
                                                K_PROD, hw=FRAME_HW))
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/model_best_train.pt"
        ck.save_checkpoint(path, {"model": model.state_dict(),
                                  "mean": mean.cpu(), "std": std.cpu()})
        tracker = trk.Tracker(info, mean.cpu().numpy(), std.cpu().numpy(),
                              ckpt_dir=path, mesh=tm, trans_normalizer=0.02,
                              rot_normalizer=15 * np.pi / 180, device=dev)
    poses = tracker.track_video(gt[0], frames[0][1:], frames[1][1:])
    err_mm = np.linalg.norm(poses[:, :3, 3] - gt[1:, :3, 3], axis=1) * 1000
    print(f"trained checkpoint -> Tracker(ckpt_dir=...) on the card: "
          f"{len(poses)} frames, finite={np.isfinite(poses).all()}, "
          f"translation error {np.round(err_mm, 2).tolist()} mm", flush=True)
    if poses.shape != (10, 4, 4) or not np.isfinite(poses).all():
        raise AssertionError("the trained tracker's poses are not finite")
    return poses


def time_train(synth, cfg, model, opt, mean, std, batched_cases, card):
    """Phase 7 timings (CUDA events, median of TRAIN_STEPS): the sampler's
    parts at batch TRAIN_BATCH (render: draws, poses and the 400-view
    render; DR; augmentation), forward + backward, the optimizer; the
    sampler render and the whole train step in turns with the earlier
    unfused pass 2; and batched K1 and ``pass2_shade`` against their plain
    versions and bounds on each of ``batched_cases`` ({name: case with
    K1's outputs})."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.data import augment as AUG
    from iros20_6d_pose_tracking_tpu_torch.data import dataset as DS
    from iros20_6d_pose_tracking_tpu_torch.models import tracknet
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
    from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

    dev, n, runs = synth.device, cfg.batch_size, TRAIN_STEPS
    gen_seed = iter(range(10**9))

    def render():
        d = DS.draw_synth(tr.step_generator(dev, 5, next(gen_seed)), n, RES,
                          synth.dr, dev)
        A, B = DS.sample_poses(d, TRAIN_XYZ, 0.02, 15.0)
        return d, DS.render_pairs(synth.mesh, synth.K, A, B, RES,
                                  synth.object_width_mm)

    d, raw = render()
    bufs = tr.preprocess_batch(tr.step_generator(dev, 6), raw, mean, std,
                               cfg, train=True)

    def fwd_bwd():
        out = model(bufs[0], bufs[1])
        loss, _ = tracknet.loss_fn(out["trans"], out["rot"], bufs[2], bufs[3])
        opt.zero_grad(set_to_none=False)
        loss.backward()

    model.train()
    parts = {
        "sampler render (draws, poses, 2x200 views)": render,
        "sampler DR composite": lambda: DS.apply_dr(
            d["dr"], raw["rgbB"], raw["depthB"], synth.dr),
        "augmentation (draws + apply)": lambda: AUG.augment_batch(
            tr.step_generator(dev, 8), raw["rgbB"], raw["depthB"],
            raw["maskB"], cfg.aug),
        "forward + backward": fwd_bwd,
        "optimizer (Adam step)": opt.step,
    }
    ms = {}
    for name, fn in parts.items():
        ms[name] = cuda_ms(fn, runs=runs, warmup=2)
        print(f"timing train part {name}: {ms[name]:.4f} ms (batch {n}, "
              f"{RES}^2, median of {runs}) {card}", flush=True)
    n_prof = 3
    prof = profile_share(lambda: [tr.train_step_synth(
        model, opt, cfg.learning_rate, cfg, synth,
        tr.step_generator(dev, 9, i), tr.step_generator(dev, 9, 10**6 + i),
        mean, std) for i in range(n_prof)], top=10)
    if prof is None:
        print("profile: torch.profiler recorded no device time; device busy "
              "share of the train step not measured")
    else:
        busy_us, wall_us, n_ops, rows = prof
        print(f"profile: {n_prof} train_step_synth steps: device busy "
              f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
              f"({100 * busy_us / wall_us:.1f}%), {n_ops} device operations "
              f"{card}")
        for key, us, count in rows:
            print(f"profile:   {us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")
    turns = {}
    for which in ("fused", "unfused", "unfused", "fused"):
        with unfused_pass2() if which == "unfused" else \
                contextlib.nullcontext():
            r = cuda_ms(render, runs=runs, warmup=1)
            st = cuda_ms(lambda: tr.train_step_synth(
                model, opt, cfg.learning_rate, cfg, synth,
                tr.step_generator(dev, 10, next(gen_seed)),
                tr.step_generator(dev, 10, next(gen_seed)), mean, std),
                runs=5, warmup=1)
        turns.setdefault(which, []).append((r, st))
    for which, vals in turns.items():
        print(f"timing train in turns, pass 2 {which}: sampler render "
              f"{[round(v[0], 4) for v in vals]} ms (median of {runs}), "
              f"train step {[round(v[1], 4) for v in vals]} ms (median of 5; "
              f"{[round(n / v[1] * 1e3, 2) for v in vals]} samples/s) {card}",
              flush=True)
    for name, c in batched_cases.items():
        args = (c["coef"], c["bbox"], (RES, RES), c["fb"])
        plain_runs = 3 if c["coef"].shape[0] > BATCHED_VIEWS else None
        report_kernel("raster_pass1", f"batched, {name} at {RES}^2",
                      lambda: rk.pass1_winners(*args),
                      lambda: rk.pass1_winners_ref(*args),
                      pass1_bound(c, (RES, RES)), card, plain_runs=plain_runs)
        p2 = (c["attr"], c["iz"], c["win"], c["R"], c["t"], (RES, RES), FAR)
        report_kernel("pass2_shade", f"batched, {name} at {RES}^2",
                      lambda: rk.pass2_shade(*p2),
                      lambda: rk.pass2_shade_ref(*p2), pass2_bound(c), card,
                      plain_runs=plain_runs)
    return ms


def time_video_in_turns(tracker, pose0, rgb, depth, n, card):
    """The eager step over ``n`` frames (``eager_video``: a captured
    program would replay whichever pass 2 it was captured with) with pass 2
    fused and with the earlier unfused pass 2, in turns (fused, unfused,
    unfused, fused), host clock around work that ends with the poses on the
    host."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    dev = tracker.device
    rgb_t = trk.upload_rgb(np.stack([rgb] * n), dev)
    depth_t = trk.upload_depth(np.stack([depth] * n), dev)
    p0 = torch.as_tensor(pose0).to(dev)
    hz = {}
    for which in ("fused", "unfused", "unfused", "fused"):
        with unfused_pass2() if which == "unfused" else \
                contextlib.nullcontext():
            eager_video(tracker, p0, rgb_t[:3], depth_t[:3]).cpu()  # warm
            t0 = time.perf_counter()
            eager_video(tracker, p0, rgb_t, depth_t).cpu()
            hz.setdefault(which, []).append(n / (time.perf_counter() - t0))
    print(f"timing the eager step loop in turns ({n} frames each): pass 2 "
          f"fused {[round(h, 2) for h in hz['fused']]} Hz, unfused (K2 + "
          f"shade_rows) {[round(h, 2) for h in hz['unfused']]} Hz {card}",
          flush=True)


# ---------------------------------------------------------------------------
# Phase 8: the serving path (multi-hypothesis and chunked tracking, the
# predict CLI).
# ---------------------------------------------------------------------------


def serve_poses(pose0, n, seed):
    """``n`` hypotheses around ``pose0`` as ``track_step_multi`` makes them,
    on the CPU: the pose itself, then ``pose0 @ perturb`` for n - 1 draws of
    ``se3.draw_gaussian_magnitude`` (1 cm, 5 degrees) on a seeded CPU
    generator. Returns (hypotheses (n, 4, 4), perturb (n - 1, 4, 4))."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.core import se3

    prev = torch.as_tensor(pose0)
    draws = se3.draw_gaussian_magnitude(torch.Generator().manual_seed(seed),
                                        (n - 1,), "cpu")
    perturb = se3.apply_gaussian_magnitude(draws, 0.01, 5.0)
    return torch.cat([prev[None], prev[None] @ perturb]), perturb


def culled_views_case(tracker, poses, res):
    """The pass-1 and pass-2 inputs (``render_case``) of the culled render
    of N views at ``res``^2, each in its own ROI, as ``render`` builds them
    for the N hypotheses of a serving frame."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.ops import roi
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    poses = torch.as_tensor(poses).to(tracker.device)
    window = rz.window_from_bbox(roi.compute_bbox(
        poses, tracker.K, tracker.cfg.object_width_mm,
        (1000.0, 1000.0, 1000.0)))
    case = render_case(tracker.mesh, poses, tracker.K, window, (res, res),
                       cull=True)
    case.update(poses=poses, window=window)
    return case


def check_culled_views(tracker, pose0):
    """Phase 8.1: K1 and ``pass2_shade`` over the culled N-view inputs of
    the serving path (N = 4 and 8 at 176^2 and at the 88^2 scoring
    resolution): K1 against its plain version and the one-view calls
    (winners equal, iz bit-equal), ``pass2_shade`` against its plain
    version (depth bit-equal, rgb within 1e-3), and the batched culled
    ``render`` against the single-pose culled render of each pose, bit for
    bit. Returns (K1 error, pass 2 error, {(N, res): case})."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    e1 = e3 = 0.0
    cases = {}
    for n in SERVE_VIEWS:
        poses, _ = serve_poses(pose0, n, SEED + n)
        for res in (RES, SCORE_RES):
            name = f"serving {n} views culled at {res}^2"
            c = culled_views_case(tracker, poses, res)
            err, iz, win = check_batched_pass1(name, c["coef"], c["bbox"],
                                               (res, res), c["fb"])
            c.update(iz=iz, win=win)
            e1 = max(e1, err)
            e3 = max(e3, check_pass2(name, c, (res, res)))
            rgb_b, depth_b = rz.render(tracker.mesh, c["poses"], tracker.K,
                                       c["window"], out_hw=(res, res),
                                       cull_backfaces=True)
            bad = []
            for b in range(n):
                rgb1, depth1 = rz.render(tracker.mesh, c["poses"][b],
                                         tracker.K, c["window"][b],
                                         out_hw=(res, res),
                                         cull_backfaces=True)
                if not (torch.equal(rgb_b[b], rgb1)
                        and torch.equal(depth_b[b], depth1)):
                    bad.append(b)
            print(f"render {name}: views different from the single-pose "
                  f"culled render {bad}", flush=True)
            if bad:
                raise AssertionError(f"batched culled render differs ({name})")
            cases[n, res] = c
    return e1, e3, cases


def sync(device):
    """Wait for the card's queue when ``device`` is a CUDA device."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rendered_frame(tracker, pose):
    """A 480x640 observed frame of the tracker's mesh at ``pose``, rendered
    by the port (culled) and quantized to uint8 RGB and uint16 mm depth:
    the scene whose depth the health score should agree with."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    rgb, depth = rz.render(
        tracker.mesh, torch.as_tensor(pose).to(tracker.device), tracker.K,
        rz.full_frame_window(FRAME_HW[1], FRAME_HW[0]), out_hw=FRAME_HW,
        cull_backfaces=True)
    return (rgb.cpu().numpy().astype(np.uint8),
            depth.cpu().numpy().astype(np.uint16))


def serving_tracker(tracker):
    """A fresh Tracker (frame_cnt 0) on the phase-4 tracker's parts."""
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    t = tracker
    return trk.Tracker.from_parts(t.model, t.cfg, t.mesh, K_PROD,
                                  t.mean.cpu().numpy(), t.std.cpu().numpy())


def run_multi(tracker, pose0, rgb, depth):
    """Phase 8.2, ``Tracker.on_track`` with ``samples`` 1, 4 and 8 over
    MULTI_FRAMES frames each, from a fresh tracker, timed on the host clock
    (pose fetched every frame) after 3 warm-up frames. Launch counts are
    zeroed just before and read just after each run. Returns {samples:
    (launches, poses, scores, seconds)}."""
    import torch

    runs = {}
    for samples, n in MULTI_FRAMES.items():
        t = serving_tracker(tracker)
        for _ in range(3):
            t.on_track(pose0, rgb, depth, samples=samples)
        t.frame_cnt = 0
        sync(t.device)
        zero_launches()
        pose, poses, scores = pose0, [], []
        t0 = time.perf_counter()
        for _ in range(n):
            pose = t.on_track(pose, rgb, depth, samples=samples)
            poses.append(pose)
            scores.append(getattr(t, "last_score", None))
        runs[samples] = (read_launches(), np.stack(poses), scores,
                         time.perf_counter() - t0)
    return runs


def check_multi(runs, tracker, pose0):
    """Exact launch counts of the multi-hypothesis runs (2 K1 and 2
    ``pass2_shade`` a frame at samples > 1, 1 and 1 at samples 1; no K2, no
    K3), finite poses and scores in [0, 1], every winner's ROI holding the
    object's centre."""
    for samples, (launches, poses, scores, _) in runs.items():
        n = len(poses)
        per = 2 if samples > 1 else 1
        want = {"raster_pass1": per * n, "gather_rows": 0,
                "raster_pass1_worklist": 0, "pass2_shade": per * n}
        print(f"serving on_track samples={samples}: {n} frames, launches "
              f"{launches} (want {want}), scores "
              f"{None if samples == 1 else np.round(scores, 4).tolist()}",
              flush=True)
        if launches != want:
            raise AssertionError(f"samples={samples}: launch counts "
                                 f"{launches} != {want}")
        if samples > 1 and not all(0.0 <= x <= 1.0 for x in scores):
            raise AssertionError(f"samples={samples}: scores out of [0, 1]")
    check_on_object({f"on_track samples={k}": v[1] for k, v in runs.items()},
                    pose0, tracker.cfg.object_width_mm)


def compare_multi(net, tracker, pose0, rgb, depth):
    """Phase 8.2 against references: the batched step over N hypotheses
    against N single steps on the card (renders and crops bit for bit,
    poses within BATCH_STEP_BAR: the CNN at batch N runs other cuDNN
    algorithms than at batch 1), and ``track_step_multi`` on the card
    against the port's plain CPU path with the same perturbations: poses
    within 5e-4 m and 5e-3 rad, scores within CPU_SCORE_BAR, and the same
    winner unless the CPU's scores of the two winners lie within that bar
    (a near tie)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.tracking import hypotheses as hy
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    t, dev = tracker, tracker.device
    rgb_t, depth_t = trk.upload_rgb(rgb, dev), trk.upload_depth(depth, dev)
    cpu = make_tracker(net, torch.device("cpu"))
    rgb_c, depth_c = trk.upload_rgb(rgb, "cpu"), trk.upload_depth(depth, "cpu")
    for n in SERVE_VIEWS:
        hypo, perturb = serve_poses(pose0, n, SEED + 10 + n)
        batch, aux = trk.track_step(t.model, t.cfg, t.mesh, t.K, t.mean,
                                    t.std, hypo.to(dev), rgb_t, depth_t)
        d_pose, bad = 0.0, []
        for b in range(n):
            one, aux1 = trk.track_step(t.model, t.cfg, t.mesh, t.K, t.mean,
                                       t.std, hypo[b].to(dev), rgb_t, depth_t)
            d_pose = max(d_pose, float((batch[b] - one).abs().max()))
            bad += [(b, k) for k in ("rgbA", "depthA", "rgbB", "depthB")
                    if not torch.equal(aux[k][b], aux1[k])]
        print(f"serving batched step, {n} hypotheses, against {n} single "
              f"steps on the card: max |d pose| {d_pose:.3e} (bar "
              f"{BATCH_STEP_BAR}), (view, image) different {bad}", flush=True)
        if bad or d_pose > BATCH_STEP_BAR:
            raise AssertionError(f"batched step differs from single steps "
                                 f"({n} hypotheses)")
        outs = {}
        for name, tt, r, d in (("card", t, rgb_t, depth_t),
                               ("cpu", cpu, rgb_c, depth_c)):
            outs[name] = hy.track_step_multi(
                tt.model, tt.cfg, tt.mesh, tt.K, tt.mean, tt.std,
                hypo[0].to(tt.device), r, d, samples=n,
                perturb=perturb.to(tt.device))
        (pg, sg, ag), (pc, sc, ac) = outs["card"], outs["cpu"]
        poses_g, poses_c = ag["poses"].cpu().numpy(), ac["poses"].numpy()
        scores_g, scores_c = ag["scores"].cpu().numpy(), ac["scores"].numpy()
        dt = float(np.abs(poses_g[:, :3, 3] - poses_c[:, :3, 3]).max())
        dr = max(rot_angle(a[:3, :3], b[:3, :3])
                 for a, b in zip(poses_g, poses_c))
        ds = float(np.abs(scores_g - scores_c).max())
        wg, wc = int(np.argmax(scores_g)), int(np.argmax(scores_c))
        tie = abs(scores_c[wg] - scores_c[wc]) <= CPU_SCORE_BAR
        print(f"serving track_step_multi, {n} hypotheses, card vs plain CPU "
              f"path: max |dt| {dt:.3e} m, max rotation {dr:.3e} rad, max "
              f"|d score| {ds:.3e} (bar {CPU_SCORE_BAR}), winner card {wg} "
              f"cpu {wc}, scores card {np.round(scores_g, 5).tolist()}",
              flush=True)
        if dt > 5e-4 or dr > 5e-3 or ds > CPU_SCORE_BAR or (
                wg != wc and not tie):
            raise AssertionError(f"track_step_multi: card and CPU disagree "
                                 f"({n} hypotheses)")


def run_chunked(tracker, pose0, rgb, depth):
    """Phase 8.3: ``track_video_chunked`` over CHUNK_FRAMES frames at
    CHUNK_SIZE (a ragged last chunk) fed by callables, bit-equal to
    ``track_video`` over the same frames, with exactly one K1 and one
    ``pass2_shade`` launch a frame (counts zeroed just before, read just
    after)."""
    rgbs = np.stack([rgb] * CHUNK_FRAMES)
    depths = np.stack([depth] * CHUNK_FRAMES)
    whole = tracker.track_video(pose0, rgbs, depths)
    sync(tracker.device)
    zero_launches()
    chunked = tracker.track_video_chunked(
        pose0, lambda a, b: rgbs[a:b], lambda a, b: depths[a:b],
        chunk_size=CHUNK_SIZE, n_frames=CHUNK_FRAMES)
    launches = read_launches()
    want = {"raster_pass1": CHUNK_FRAMES, "gather_rows": 0,
            "raster_pass1_worklist": 0, "pass2_shade": CHUNK_FRAMES}
    n_diff = int((chunked != whole).sum())
    print(f"serving track_video_chunked: {CHUNK_FRAMES} frames in chunks of "
          f"{CHUNK_SIZE} from callables, launches {launches} (want {want}), "
          f"pose entries different from track_video: {n_diff}", flush=True)
    if launches != want:
        raise AssertionError(f"chunked launch counts {launches} != {want}")
    if n_diff or chunked.shape != whole.shape:
        raise AssertionError("track_video_chunked is not bit-equal to "
                             "track_video")
    check_on_object({"track_video_chunked": chunked}, pose0,
                    tracker.cfg.object_width_mm)
    return launches


def write_png(path, img):
    """Write an (H, W, 3) uint8, an (H, W) uint8 or an (H, W) uint16 image
    as a PNG with zlib alone: filter 0 on every row, 16-bit samples
    big-endian as the format stores them. The port reads it back with
    Pillow."""
    import struct
    import zlib

    img = np.ascontiguousarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        bits, color = 8, 2
    elif img.dtype == np.uint8 and img.ndim == 2:
        bits, color = 8, 0
    elif img.dtype == np.uint16 and img.ndim == 2:
        bits, color = 16, 0
        img = img.astype(">u2")
    else:
        raise ValueError(f"need (H, W, 3) uint8, (H, W) uint8 or (H, W) "
                         f"uint16, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, color,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def write_ycb_tree(root, tm, pose0, dev):
    """A YCB-style tree under ``root`` for the predict CLI: sequence 0048
    of class 4 (PREDICT_FRAMES frames of ``tm`` rendered by the port on the
    card at 480x640 as uint8/uint16 PNGs, the object drifting 1 mm and 0.3
    degrees a frame, and its gt poses), the mesh as OBJ,
    ``dataset_info.yml`` (the production intrinsics, 176^2; JSON, which is
    YAML), mean/std, and a zero-head Flax checkpoint of the seeded network,
    written with msgpack and numpy. Frames render on ``dev``. Returns (gt poses, checkpoint
    path)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.core import se3
    from iros20_6d_pose_tracking_tpu_torch.models import convert
    from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
    from iros20_6d_pose_tracking_tpu_torch.train import checkpoint as ck

    seq = root / "0048"
    for d in ("color", "depth_filled", "pose_gt/4"):
        (seq / d).mkdir(parents=True)
    mesh = rz.upload(tm, dev)
    K = torch.as_tensor(K_PROD).to(dev)
    gts = []
    for i in range(PREDICT_FRAMES):
        pose = se3.make_pose(
            se3.so3_exp(torch.tensor([0.0, 0.005 * i, 0.002 * i])),
            torch.as_tensor(pose0[:3, 3]) + torch.tensor(
                [0.001 * i, -0.0005 * i, 0.0005 * i]))
        rgb, depth = rz.render(mesh, pose.to(dev), K,
                               rz.full_frame_window(FRAME_HW[1], FRAME_HW[0]),
                               out_hw=FRAME_HW, cull_backfaces=True)
        write_png(seq / "color" / f"{i:06d}.png",
                  rgb.cpu().numpy().astype(np.uint8))
        write_png(seq / "depth_filled" / f"{i:06d}.png",
                  depth.cpu().numpy().astype(np.uint16))
        np.savetxt(seq / "pose_gt" / "4" / f"{i:06d}.txt", pose.numpy())
        gts.append(pose.numpy().astype(np.float64))
    M.save_obj(tm, str(root / "object.obj"))
    (root / "train_data").mkdir()
    info = {"camera": {"focalX": float(K_PROD[0, 0]),
                       "focalY": float(K_PROD[1, 1]),
                       "centerX": float(K_PROD[0, 2]),
                       "centerY": float(K_PROD[1, 2]),
                       "width": FRAME_HW[1], "height": FRAME_HW[0]},
            "resolution": RES, "boundingbox": 10}
    (root / "dataset_info.yml").write_text(json.dumps(info, indent=1))
    np.save(root / "mean.npy", np.zeros(8, np.float32))
    np.save(root / "std.npy", np.full(8, 100.0, np.float32))
    net = build_model(SEED)
    with torch.no_grad():
        for head in (net.trans_out, net.rot_out):
            head[0].weight.zero_()
            head[0].bias.zero_()
    ckpt = str(root / "zero_head.msgpack")
    ck.save_flax_checkpoint(ckpt, convert.state_dict_to_variables(
        net.state_dict()))
    return gts, ckpt


def run_predict(root, ckpt, gts, dev, card):
    """Phase 8.4: the predict CLI on the card, ``--mode ycbv`` on the tree
    of :func:`write_ycb_tree`: scan at chunk PREDICT_CHUNK with canvases,
    then ontrack. Each run's launches are zeroed just before and read just
    after (scan: 1 K1 + 1 ``pass2_shade`` a tracked frame, and one more of
    each for its canvas; ontrack: 1 + 1). The two modes' pose files hold the
    same poses, every pose within 1e-4 of the init gt (the heads are zero,
    the realdata_dryrun bar), one canvas a tracked frame. Then the scan's
    decode and tracking alone (``_track_files`` on a built tracker) timed
    on the host clock: 1 K1 + 1 ``pass2_shade`` a frame, the CLI's poses.
    Returns the runs' launches by name."""
    from iros20_6d_pose_tracking_tpu_torch.apps import predict

    base = ["--mode", "ycbv", "--seq_id", "48", "--class_id", "4",
            "--ycb_dir", str(root), "--train_data_path",
            str(root / "train_data"), "--mean_std_path", str(root),
            "--model_path", str(root / "object.obj"), "--ckpt_dir", ckpt,
            "--device", str(dev)]
    n = PREDICT_FRAMES - 1  # the first frame holds the init
    want1 = {"raster_pass1": n, "gather_rows": 0, "raster_pass1_worklist": 0,
             "pass2_shade": n}
    want2 = {k: 2 * v for k, v in want1.items()}
    poses, launches = {}, {}
    for mode, extra, want in (
            ("scan", ["--chunk_size", str(PREDICT_CHUNK), "--canvas_dir",
                      str(root / "canvas")], want2),
            ("ontrack", [], want1)):
        out = root / f"out_{mode}"
        sync(dev)
        zero_launches()
        t0 = time.perf_counter()
        predict.main(base + ["--outdir", str(out), "--track_mode", mode]
                     + extra)
        secs = time.perf_counter() - t0
        launches[mode] = read_launches()
        files = sorted(p.name for p in out.glob("*.txt")
                       if not p.name.endswith("gt.txt"))
        poses[mode] = np.stack([np.loadtxt(out / f) for f in files])
        print(f"serving predict --track_mode {mode}: {len(files)} pose files "
              f"in {secs:.3f} s (tracker construction, PNG decode, tracking,"
              f" files{', canvases' if extra else ''}), launches "
              f"{launches[mode]} (want {want})", flush=True)
        if launches[mode] != want:
            raise AssertionError(f"predict {mode}: launch counts "
                                 f"{launches[mode]} != {want}")
    n_canvas = len(list((root / "canvas").glob("*.png")))
    held = float(np.abs(poses["scan"] - gts[0][None]).max())
    same = np.array_equal(poses["scan"], poses["ontrack"])
    print(f"serving predict: scan and ontrack poses equal: {same}; max |pose "
          f"- init gt| {held:.3e} (bar 1e-4); {n_canvas} canvases", flush=True)
    if not same or poses["scan"].shape != (PREDICT_FRAMES, 4, 4) or \
            held > 1e-4 or n_canvas != n:
        raise AssertionError("predict CLI output is wrong")
    args = predict.build_parser().parse_args(
        base + ["--outdir", str(root / "out_timed"), "--chunk_size",
                str(PREDICT_CHUNK)])
    info = json.loads((root / "dataset_info.yml").read_text())
    tracker = predict._make_tracker(info, np.zeros(8), np.full(8, 100.0),
                                    args)
    rgb_files = sorted(str(p) for p in (root / "0048" / "color").glob("*"))
    depth_files = sorted(str(p) for p in
                         (root / "0048" / "depth_filled").glob("*"))
    predict._track_files(tracker, rgb_files[:3], depth_files[:3], gts[0],
                         args)  # warm
    sync(dev)
    zero_launches()
    t0 = time.perf_counter()
    timed = predict._track_files(tracker, rgb_files, depth_files, gts[0],
                                 args)
    secs = time.perf_counter() - t0
    launches["scan, timed"] = read_launches()
    print(f"timing predict scan: {n / secs:.2f} frames/s ({n} frames of "
          f"{FRAME_HW[0]}x{FRAME_HW[1]} PNGs, chunk {PREDICT_CHUNK}: PNG "
          f"decode on the loader thread, upload, tracking, poses on the "
          f"host), launches {launches['scan, timed']} (want {want1}) {card}",
          flush=True)
    if launches["scan, timed"] != want1 or \
            not np.array_equal(timed.astype(np.float32),
                               poses["scan"].astype(np.float32)):
        raise AssertionError("the timed predict scan differs from the CLI's")
    return launches


def time_serving(tracker, pose0, frame, rendered, runs, cases, card):
    """Phase 8.5: ``on_track`` Hz at samples 1, 4 and 8 (from ``runs``);
    ``track_video_chunked`` and ``track_video`` over CHUNK_FRAMES frames in
    turns (host clock, poses on the host at the end); the multi-hypothesis
    step split at 8 hypotheses (CUDA events, median of 20): the batched
    culled render at 176^2, the CNN at batch 8, the scoring (render at
    88^2 and score) and the whole step; and K1 and ``pass2_shade`` on the
    culled N-view cases against their plain versions and bounds. Returns
    the kernels-line numbers of the N-view cases. ``frame`` is phase 4's
    observed frame (the chunked video's), ``rendered`` the rendered frame of
    the multi-hypothesis runs."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.models import tracknet
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
    from iros20_6d_pose_tracking_tpu_torch.tracking import hypotheses as hy
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    for samples, (_, poses, _, secs) in runs.items():
        print(f"timing on_track samples={samples}: {len(poses) / secs:.2f} Hz "
              f"({len(poses)} frames, pose fetched every frame) {card}",
              flush=True)
    rgbs = np.stack([frame[0]] * CHUNK_FRAMES)
    depths = np.stack([frame[1]] * CHUNK_FRAMES)
    hz = {}
    for which in ("track_video", "chunked", "chunked", "track_video"):
        sync(tracker.device)
        t0 = time.perf_counter()
        if which == "chunked":
            tracker.track_video_chunked(
                pose0, lambda a, b: rgbs[a:b], lambda a, b: depths[a:b],
                chunk_size=CHUNK_SIZE, n_frames=CHUNK_FRAMES)
        else:
            tracker.track_video(pose0, rgbs, depths)
        hz.setdefault(which, []).append(
            CHUNK_FRAMES / (time.perf_counter() - t0))
    print(f"timing in turns over {CHUNK_FRAMES} frames: track_video_chunked "
          f"(chunk {CHUNK_SIZE}, callables) {[round(h, 2) for h in hz['chunked']]}"
          f" Hz, track_video {[round(h, 2) for h in hz['track_video']]} Hz "
          f"{card}", flush=True)

    t, n = tracker, max(SERVE_VIEWS)
    rgb_t, depth_t = trk.upload_rgb(rendered[0], t.device), trk.upload_depth(
        rendered[1], t.device)
    c = cases[n, RES]
    hypo = c["poses"]
    _, aux = trk.track_step(t.model, t.cfg, t.mesh, t.K, t.mean, t.std, hypo,
                            rgb_t, depth_t)
    bufA, bufB = tracknet.normalize_pair(aux["rgbA"], aux["depthA"],
                                         aux["rgbB"], aux["depthB"],
                                         hypo[:, None, None], t.mean, t.std)
    gen = torch.Generator(t.device).manual_seed(0)
    parts = {
        f"batched culled render ({n} views, {RES}^2)": lambda: rz.render(
            t.mesh, hypo, t.K, c["window"], out_hw=(RES, RES),
            cull_backfaces=True),
        f"CNN at batch {n}": lambda: t.model(bufA, bufB),
        f"scoring ({n} views: render at {SCORE_RES}^2, crop, score)":
            lambda: hy.depth_agreement(t.mesh, hypo, t.K, depth_t, t.cfg,
                                       score_res=SCORE_RES),
        f"whole track_step_multi ({n} hypotheses)": lambda: (
            hy.track_step_multi(t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
                                hypo[0], rgb_t, depth_t, gen, samples=n)),
    }
    with torch.no_grad():
        for name, fn in parts.items():
            print(f"timing serving step part {name}: "
                  f"{cuda_ms(fn, runs=20):.4f} ms (median of 20) {card}",
                  flush=True)
    n_prof = 5
    t8 = serving_tracker(tracker)
    prof = profile_share(lambda: [t8.on_track(pose0, *rendered, samples=n)
                                  for _ in range(n_prof)])
    if prof is None:
        print("profile: torch.profiler recorded no device time; the serving "
              "frame's device share not measured")
    else:
        busy_us, wall_us, n_ops, _ = prof
        print(f"profile: on_track samples={n} over {n_prof} frames: device "
              f"busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
              f"({100 * busy_us / wall_us:.1f}%), {n_ops / n_prof:.0f} device "
              f"operations a frame {card}", flush=True)
    nview = {"raster_pass1": [], "pass2_shade": []}
    for (views, res), c in cases.items():
        hw = (res, res)
        label = f"culled, {views} serving views at {res}^2"
        args1 = (c["coef"], c["bbox"], hw, c["fb"])
        args2 = (c["attr"], c["iz"], c["win"], c["R"], c["t"], hw, FAR)
        for name, fn, plain, bnd in (
                ("raster_pass1", rk.pass1_winners, rk.pass1_winners_ref,
                 pass1_bound(c, hw)),
                ("pass2_shade", rk.pass2_shade, rk.pass2_shade_ref,
                 pass2_bound(c))):
            args = args1 if name == "raster_pass1" else args2
            r = report_kernel(name, label, lambda: fn(*args),
                              lambda: plain(*args), bnd, card, plain_runs=5)
            nview[name].append({"views": views, "res": res, **r})
    return nview


# ---------------------------------------------------------------------------
# Phase 9: the live path (StreamTracker, the ROS core with fill_depth, predict
# in stream mode, the native PNG loader).
# ---------------------------------------------------------------------------


def live_stream(tracker, **kw):
    """A StreamTracker on a fresh tracker of the phase-4 parts."""
    from iros20_6d_pose_tracking_tpu_torch.tracking.stream import (
        StreamTracker)

    return StreamTracker(serving_tracker(tracker), **kw)


def drain(s):
    """Wait for a stream's background pose fetch, if one is running."""
    if s._fetch_future is not None:
        s._fetch_future.result(timeout=60)


def run_live(tracker, pose0, rgb, depth):
    """Phase 9.1: the windowed and the full-frame stream over LIVE_FRAMES
    pushes of phase 4's frame, each bit-equal to ``track_video`` on the
    same frames, no containment violation, the window below the frame;
    exactly one K1 and one ``pass2_shade`` launch a push (counts zeroed
    just before the pushes, read after the poses). Returns the launches of
    each run."""
    n = LIVE_FRAMES
    want = serving_tracker(tracker).track_video(
        pose0, np.stack([rgb] * n), np.stack([depth] * n))
    per = {"raster_pass1": n, "gather_rows": 0, "raster_pass1_worklist": 0,
           "pass2_shade": n}
    launches = {}
    for window in (True, False):
        s = live_stream(tracker, window=window)
        s.begin(pose0)
        sync(tracker.device)
        zero_launches()
        for _ in range(n):
            s.push(rgb, depth)
        got = s.poses()
        launches[window] = read_launches()
        s.close()
        stats = s.stats()
        n_diff = int((got != want).sum())
        print(f"live stream window={window}: {n} pushes, pose entries "
              f"different from track_video {n_diff}, stats {stats}, launches "
              f"{launches[window]} (want {per})", flush=True)
        if n_diff or got.shape != want.shape:
            raise AssertionError(f"stream window={window} is not bit-equal "
                                 "to track_video")
        if launches[window] != per:
            raise AssertionError(f"stream launch counts {launches[window]}")
        if stats["containment_violations"] or (
                window and not stats["bucket"] < min(FRAME_HW)):
            raise AssertionError(f"stream window: {stats}")
    check_on_object({"live stream": want}, pose0,
                    tracker.cfg.object_width_mm)
    return launches


def check_push_syncs(tracker, pose0, rgb, depth):
    """Phase 9.2: SYNC_PUSHES windowed pushes (refetches every 8) under
    ``torch.cuda.set_sync_debug_mode``: first "warn", every warning
    recorded with its thread and Python stack (all are printed, and any
    fails the run), then "error" (a synchronizing call raises). The pushes
    before them warm the window side's program up and capture it, so the
    checked pushes are replays."""
    import threading
    import traceback
    import warnings

    import torch

    from iros20_6d_pose_tracking_tpu_torch.tracking import compiled

    s = live_stream(tracker)
    s.begin(pose0)
    for _ in range(compiled.WARMUP_CALLS + 1):  # the side's program captured
        s.push(rgb, depth)
    drain(s)
    hits = []

    def record(message, category, filename, lineno, file=None, line=None):
        hits.append((threading.current_thread().name, str(message)[:200],
                     "".join(traceback.format_stack(limit=14)[:-1])))

    torch.cuda.set_sync_debug_mode("warn")  # warns once that it is new
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            for _ in range(SYNC_PUSHES):
                s.push(rgb, depth)
            drain(s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for thread, msg, stack in hits[:5]:
        print(f"live sync (thread {thread}): {msg}\n{stack}", flush=True)
    print(f"live sync check: {SYNC_PUSHES} pushes under sync debug mode "
          f"'warn': {len(hits)} synchronizing calls", flush=True)
    if hits:
        raise AssertionError("a push synchronized with the card")
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(SYNC_PUSHES):
            s.push(rgb, depth)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    s.close()
    print(f"live sync check: {SYNC_PUSHES} pushes under sync debug mode "
          f"'error': none raised; refetches {s.refetches}", flush=True)


def launch_queue_depth():
    """Launches the card's queue holds before the host waits: one-element
    adds enqueued one by one behind a device sleep of SLEEP_MS, counted
    until the host clock passes SLEEP_BAR of the sleep (the host enqueues
    a thousand of them in a few ms; a launch into a full queue returns only
    when the sleep ends)."""
    import torch

    x = torch.zeros(1, device="cuda")
    cycles = int(SLEEP_MS * sleep_cycles_per_ms())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    n = 0
    while n < 100_000 and (time.perf_counter() - t0) * 1e3 < \
            SLEEP_BAR * SLEEP_MS:
        x.add_(1.0)
        n += 1
    torch.cuda.synchronize()
    return n


def check_push_behind_sleep(tracker, pose0, rgb, depth, card):
    """Phase 9.2: SLEEP_PUSHES windowed pushes enqueued behind a device
    sleep of SLEEP_MS, each push's return on the host clock from just after
    the sleep was queued. A push that does not wait for the card returns at
    once while the card's launch queue has room for its device operations
    (``launch_queue_depth``; a push's operations from the profiler): every
    push that fits, and at least the first, must return within SLEEP_BAR of
    the sleep; the queue must take the sleep's length to drain."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.tracking import compiled

    s = live_stream(tracker)
    s.begin(pose0)
    for _ in range(compiled.WARMUP_CALLS + 1):  # the program captured
        s.push(rgb, depth)
    s.current_pose()
    prof = profile_share(lambda: ([s.push(rgb, depth) for _ in range(5)],
                                  s.current_pose()))
    ops = None if prof is None else prof[2] / 5
    depth_q = launch_queue_depth()
    fits = max(1, int(depth_q // ops)) if ops else 1
    cycles = int(SLEEP_MS * sleep_cycles_per_ms())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    back = []
    for _ in range(SLEEP_PUSHES):
        s.push(rgb, depth)
        back.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    s.close()
    early = sum(b < SLEEP_BAR * SLEEP_MS for b in back)
    print(f"live pushes behind a {SLEEP_MS:.0f} ms device sleep: returned "
          f"at {np.round(back, 3).tolist()} ms, queue drained at "
          f"{total:.3f} ms; {early} of {SLEEP_PUSHES} back before "
          f"{SLEEP_BAR * SLEEP_MS:.0f} ms (bar: the first {fits}, which fit "
          f"in the launch queue: {depth_q} launches, "
          f"{'not measured' if ops is None else f'{ops:.0f}'} device "
          f"operations a push) {card}", flush=True)
    if max(back[:fits]) > SLEEP_BAR * SLEEP_MS or total < 0.9 * SLEEP_MS:
        raise AssertionError("a push waited for the card")


def run_live_multi(tracker, pose0, rgb_r, depth_r):
    """Phase 9.4: a samples-4 windowed stream over LIVE_MULTI_FRAMES pushes
    of the rendered frame, bit-equal (poses and scores) to
    ``Tracker.on_track(samples=4)`` over the same frames from a fresh
    tracker; finite scores in [0, 1]; exactly 2 K1 and 2 ``pass2_shade``
    launches a push. Returns (launches, seconds of the pushes and the
    fetch)."""
    n, samples = LIVE_MULTI_FRAMES, 4
    t = serving_tracker(tracker)
    pose, want, want_scores = pose0, [], []
    for _ in range(n):
        pose = t.on_track(pose, rgb_r, depth_r, samples=samples)
        want.append(pose)
        want_scores.append(t.last_score)
    s = live_stream(tracker, samples=samples)
    s.begin(pose0)
    s.push(rgb_r, depth_r)  # warm: the stream's first multi step
    s.begin(pose0)
    sync(tracker.device)
    zero_launches()
    t0 = time.perf_counter()
    for _ in range(n):
        s.push(rgb_r, depth_r)
    got, scores = s.poses(), s.scores()
    secs = time.perf_counter() - t0
    launches = read_launches()
    s.close()
    per = {"raster_pass1": 2 * n, "gather_rows": 0,
           "raster_pass1_worklist": 0, "pass2_shade": 2 * n}
    n_diff = int((got != np.stack(want)).sum()) + int(
        (scores != np.asarray(want_scores, np.float32)).sum())
    print(f"live stream samples={samples}: {n} pushes, entries different "
          f"from on_track(samples={samples}) {n_diff}, scores "
          f"{np.round(scores, 4).tolist()}, launches {launches} (want {per})",
          flush=True)
    if n_diff or launches != per:
        raise AssertionError("samples-4 stream differs from on_track")
    if not (np.isfinite(scores).all() and ((scores >= 0) & (scores <= 1))
            .all()):
        raise AssertionError("stream scores not finite or out of [0, 1]")
    return launches, secs


def check_live_failure_paths(tracker, pose0, rgb_r, depth_r):
    """Phase 9.5-9.6: a teleported device pose must be caught by the
    containment check (a violation, the pad widened by 16 px); a
    ReinitPolicy whose callback returns a pose must fire on black frames
    and the next push must apply that pose (a new generation, its step one
    bounded update from it)."""
    import torch

    s = live_stream(tracker, refetch_every=1)
    s.begin(pose0)
    s.push(rgb_r, depth_r)
    tele = pose0.copy()
    tele[:3, 3] += [0.2, 0.15, 0.0]
    s._pose_dev = torch.as_tensor(tele).to(tracker.device)
    for _ in range(4):
        s.push(rgb_r, depth_r)
        drain(s)
    s.close()
    stats = s.stats()
    print(f"live containment: teleported pose, stats {stats}", flush=True)
    if stats["containment_violations"] < 1 or stats["pad_boost_px"] < 16:
        raise AssertionError("the containment check missed a teleport")

    from iros20_6d_pose_tracking_tpu_torch.tracking.hypotheses import (
        ReinitPolicy)

    calls = []

    def on_lost(idx, score):
        calls.append((idx, score))
        return pose0

    s = live_stream(tracker, samples=2, refetch_every=1,
                    reinit_policy=ReinitPolicy(patience=2),
                    on_track_lost=on_lost)
    s.begin(pose0)
    for _ in range(3):
        s.push(rgb_r, depth_r)
        drain(s)
    healthy = s.track_lost_events
    black = (np.zeros_like(rgb_r), np.zeros_like(depth_r))
    gen = s._gen
    for _ in range(10):
        s.push(*black)
        drain(s)
        if s._gen > gen:
            break
    step = s.current_pose()
    s.close()
    moved = float(np.linalg.norm(step[:3, 3] - pose0[:3, 3]))
    print(f"live re-init: events {s.track_lost_events} (0 on the healthy "
          f"frames: {healthy == 0}), callback calls {calls}, generation "
          f"{gen} -> {s._gen}, first step from the returned pose moved "
          f"{moved * 1000:.3f} mm", flush=True)
    if healthy or not calls or s._gen <= gen or \
            moved > np.sqrt(3) * tracker.cfg.trans_normalizer + 1e-6:
        raise AssertionError("the closed-loop re-init did not fire or apply")


def holey_depth_m(depth_r, seed):
    """The rendered frame's depth in metres with 5% of its pixels and a
    band of rows dropped to 0 (holes for fill_depth)."""
    d = depth_r.astype(np.float32) / 1000.0
    rng = np.random.RandomState(seed)
    d[rng.rand(*d.shape) < 0.05] = 0.0
    d[200:206] = 0.0
    return d


def check_fill_and_ros(tracker, pose0, rgb_r, depth_r, card):
    """Phase 9.7: ``fill_depth`` of a 480x640 depth with holes on the card
    against the port's CPU path (within FILL_BAR_M), its time (CUDA events,
    median of 20); the ROS core, stream against blocking, over ROS_FRAMES
    frames with filling on (within ROS_BAR_M and ROS_BAR_RAD a frame); the
    stream core's rate with filling on and off (host clock, the pose fetched
    every frame as the TF broadcast needs it)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.apps.predict_ros import (
        TrackerRosCore)
    from iros20_6d_pose_tracking_tpu_torch.ops import depthproc

    holey = holey_depth_m(depth_r, SEED + 9)
    card_fill = depthproc.fill_depth(
        torch.as_tensor(holey).to(tracker.device)).cpu().numpy()
    cpu_fill = depthproc.fill_depth(torch.as_tensor(holey)).numpy()
    err = float(np.abs(card_fill - cpu_fill).max())
    ms = cuda_ms(lambda: depthproc.fill_depth(
        torch.as_tensor(holey).to(tracker.device)), runs=20)
    holes = (holey == 0) & (depth_r > 0)  # dropped inside the object
    filled = float((holes & (card_fill > 0)).sum()) / max(1, int(holes.sum()))
    print(f"live fill_depth {FRAME_HW[0]}x{FRAME_HW[1]}: card vs CPU max "
          f"|d| {err:.3e} m (bar {FILL_BAR_M}), holes in the object filled "
          f"{100 * filled:.1f}%, {ms:.4f} ms a call with the upload (CUDA "
          f"events, median of 20) {card}", flush=True)
    if err > FILL_BAR_M:
        raise AssertionError("fill_depth on the card differs from the CPU")

    frames = [holey_depth_m(depth_r, SEED + 20 + i) for i in range(ROS_FRAMES)]
    out = {}
    for use_stream in (True, False):
        core = TrackerRosCore(serving_tracker(tracker), use_stream=use_stream)
        core.set_init_pose(pose0)
        poses = []
        for d in frames:
            core.grab_color(rgb_r)
            core.grab_depth(d)
            poses.append(core.on_track())
        core.close()
        out[use_stream] = np.stack(poses)
    dt = float(np.abs(out[True][:, :3, 3] - out[False][:, :3, 3]).max())
    dr = max(rot_angle(a[:3, :3], b[:3, :3])
             for a, b in zip(out[True], out[False]))
    print(f"live ROS core, stream vs blocking, {ROS_FRAMES} frames with "
          f"filling: max |dt| {dt:.3e} m, max rotation {dr:.3e} rad",
          flush=True)
    if dt > ROS_BAR_M or dr > ROS_BAR_RAD or not np.isfinite(out[True]).all():
        raise AssertionError("ROS stream core and blocking core disagree")
    hz = {}
    for fill in (True, False):
        core = TrackerRosCore(serving_tracker(tracker), fill_depth_holes=fill)
        core.set_init_pose(pose0)
        core.grab_color(rgb_r)
        core.grab_depth(frames[0])
        core.on_track()
        t0 = time.perf_counter()
        for d in frames:
            core.grab_color(rgb_r)
            core.grab_depth(d)
            core.on_track()
        hz[fill] = ROS_FRAMES / (time.perf_counter() - t0)
        core.close()
    print(f"timing ROS core (stream, pose fetched every frame): "
          f"{hz[True]:.2f} Hz with filling, {hz[False]:.2f} Hz without "
          f"({ROS_FRAMES} frames) {card}", flush=True)
    return {"fill_ms": ms, "ros_hz": hz}


def run_predict_stream(root, ckpt, dev, card):
    """Phase 9.8: ``apps/predict.main`` in stream mode, windowed and with
    ``--no_window``, on phase 8's tree: pose files equal to the scan run's
    of phase 8, exactly 1 K1 + 1 ``pass2_shade`` a tracked frame; the
    stream's decode and tracking alone timed on the host clock; and, where
    the native loader builds, its frames against Pillow's (equal) and both
    decoders' frames/s. Returns the CLI runs' launches."""
    from iros20_6d_pose_tracking_tpu_torch.apps import predict

    base = ["--mode", "ycbv", "--seq_id", "48", "--class_id", "4",
            "--ycb_dir", str(root), "--train_data_path",
            str(root / "train_data"), "--mean_std_path", str(root),
            "--model_path", str(root / "object.obj"), "--ckpt_dir", ckpt,
            "--device", str(dev), "--track_mode", "stream"]
    n = PREDICT_FRAMES - 1
    want = {"raster_pass1": n, "gather_rows": 0, "raster_pass1_worklist": 0,
            "pass2_shade": n}
    scan_files = sorted(p.name for p in (root / "out_scan").glob("*.txt"))
    launches = {}
    for name, extra in (("stream", []), ("stream --no_window",
                                         ["--no_window"])):
        out = root / f"out_{name.replace(' --', '_')}"
        sync(dev)
        zero_launches()
        predict.main(base + ["--outdir", str(out)] + extra)
        launches[name] = read_launches()
        files = sorted(p.name for p in out.glob("*.txt"))
        same = files == scan_files and all(
            (out / f).read_bytes() == (root / "out_scan" / f).read_bytes()
            for f in files)
        print(f"live predict --track_mode {name}: {len(files)} files, equal "
              f"to the scan run's: {same}, launches {launches[name]} (want "
              f"{want})", flush=True)
        if not same or launches[name] != want:
            raise AssertionError(f"predict {name} differs from scan")
    args = predict.build_parser().parse_args(
        base + ["--outdir", str(root / "out_stream_timed")])
    info = json.loads((root / "dataset_info.yml").read_text())
    tracker = predict._make_tracker(info, np.zeros(8), np.full(8, 100.0),
                                    args)
    rgb_files = sorted(str(p) for p in (root / "0048" / "color").glob("*"))
    depth_files = sorted(str(p) for p in
                         (root / "0048" / "depth_filled").glob("*"))
    gt0 = np.loadtxt(root / "0048" / "pose_gt" / "4" / "000000.txt")
    predict._track_files(tracker, rgb_files[:3], depth_files[:3], gt0, args)
    sync(dev)
    t0 = time.perf_counter()
    predict._track_files(tracker, rgb_files, depth_files, gt0, args)
    secs = time.perf_counter() - t0
    print(f"timing predict stream: {n / secs:.2f} frames/s ({n} frames of "
          f"{FRAME_HW[0]}x{FRAME_HW[1]} PNGs: decode in chunks of 16 on the "
          f"loader thread, windowed pushes, poses on the host at the end) "
          f"{card}", flush=True)
    nl = predict._png_decoder()
    if nl is None:
        print("live PNG decode: the native loader does not build on this "
              "machine (no g++ or libpng); frames decode with Pillow",
              flush=True)
        return launches
    t0 = time.perf_counter()
    nat = (nl.read_png_batch(rgb_files, np.uint8)[..., :3],
           nl.read_png_batch(depth_files, np.uint16))
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pil = (np.stack([predict._load_rgb(f) for f in rgb_files]),
           np.stack([predict._load_depth(f) for f in depth_files]))
    pil_s = time.perf_counter() - t0
    same = all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(nat, pil))
    print(f"live PNG decode: native and Pillow frames equal: {same}; "
          f"timing decode of {len(rgb_files)} RGB + {len(depth_files)} depth "
          f"PNGs: native {len(rgb_files) / nat_s:.2f} frames/s, Pillow "
          f"{len(rgb_files) / pil_s:.2f} frames/s {card}", flush=True)
    if not same:
        raise AssertionError("the native PNG loader and Pillow disagree")
    return launches


def moving_stream(tracker):
    """The JAX bench's host_loop_moving stream: a copy of the phase-4
    network whose translation-head bias is arctanh(MOVING_DRIFT_MM / 30 mm)
    on x, so the pose drifts MOVING_DRIFT_MM a frame through the full CNN
    path and the window machinery must chase it."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
    from iros20_6d_pose_tracking_tpu_torch.tracking.stream import (
        StreamTracker)

    t = tracker
    net = copy.deepcopy(t.model)
    with torch.no_grad():
        net.trans_out[0].bias.zero_()
        net.trans_out[0].bias[0] = float(np.arctanh(
            MOVING_DRIFT_MM * 1e-3 / t.cfg.trans_normalizer))
    return StreamTracker(trk.Tracker.from_parts(
        net, t.cfg, t.mesh, K_PROD, t.mean.cpu().numpy(),
        t.std.cpu().numpy()))


def time_live(tracker, pose0, rgb, depth, multi_s, card):
    """Phase 9 timings: host_loop (bench.py:328-385: HOST_LOOP_FRAMES
    windowed pushes, the pose fetched at the end, best of
    HOST_LOOP_REPEATS; the window, the host's ms a push, the device's busy
    share over a profiler window of LIVE_PROFILE_PUSHES pushes) and
    host_loop_moving (bench.py:388-433), each in turns with ``track_video``
    and ``on_track`` over the same frames (track_video, on_track, host_loop,
    moving, then the other way round, where host_loop is one run); the
    samples-4 stream's rate."""
    n = HOST_LOOP_FRAMES
    s = live_stream(tracker)
    mv = moving_stream(tracker)
    t_on = serving_tracker(tracker)
    rgbs, depths = np.stack([rgb] * n), np.stack([depth] * n)
    for st in (s, mv):  # warm: the window side's program captured
        st.begin(pose0)
        for _ in range(10):
            st.push(rgb, depth)
        st.current_pose()

    def host_loop(repeats):
        best, push_ms = 0.0, []
        for _ in range(repeats):
            s.begin(pose0)
            t0 = time.perf_counter()
            for _ in range(n):
                s.push(rgb, depth)
            push_ms.append((time.perf_counter() - t0) * 1e3 / n)
            s.current_pose()
            best = max(best, n / (time.perf_counter() - t0))
        return best, min(push_ms)

    def moving():
        mv.begin(pose0)
        buckets = set()
        t0 = time.perf_counter()
        for _ in range(n):
            mv.push(rgb, depth)
            buckets.add(mv._cur_bucket)
        end = mv.current_pose()
        hz = n / (time.perf_counter() - t0)
        return hz, buckets, abs(end[0, 3] - pose0[0, 3]) * 1e3

    def on_track():
        pose = pose0
        t0 = time.perf_counter()
        for _ in range(n):
            pose = t_on.on_track(pose, rgb, depth)
        return n / (time.perf_counter() - t0)

    def video():
        t0 = time.perf_counter()
        t_on.track_video(pose0, rgbs, depths)
        return n / (time.perf_counter() - t0)

    hz = {k: [] for k in ("track_video", "on_track", "host_loop", "moving")}
    push_ms, buckets, moved = [], set(), 0.0
    order = list(hz)
    for turn, name in enumerate(order + order[::-1]):
        sync(tracker.device)
        if name == "host_loop":  # the bench's best of 3 in the first round
            h, ms = host_loop(HOST_LOOP_REPEATS if turn < len(order) else 1)
            push_ms.append(ms)
        elif name == "moving":
            h, b, moved = moving()
            buckets |= b
        else:
            h = on_track() if name == "on_track" else video()
        hz[name].append(h)
    side = s._cur_bucket
    print(f"timing host_loop: {[round(h, 2) for h in hz['host_loop']]} Hz "
          f"(the best of {HOST_LOOP_REPEATS} runs, then one run, of {n} "
          f"windowed pushes, the pose fetched at the end; host ms per push "
          f"from the run's pushes alone), window_px {side}, window_kb "
          f"{side * side * 5 / 1024:.1f}, host ms per push "
          f"{[round(m, 4) for m in push_ms]} {card}", flush=True)
    print(f"timing host_loop_moving: {[round(h, 2) for h in hz['moving']]} "
          f"Hz ({n} frames, drift {MOVING_DRIFT_MM} mm/frame scripted, "
          f"{moved:.1f} mm moved), buckets visited {sorted(buckets)}, "
          f"refetches {mv.refetches}, containment violations "
          f"{mv.containment_violations}, stats {mv.stats()} {card}",
          flush=True)
    print(f"timing in turns over {n} frames (track_video, on_track, "
          f"host_loop, host_loop_moving, then reversed): track_video "
          f"{[round(h, 2) for h in hz['track_video']]} Hz, on_track "
          f"{[round(h, 2) for h in hz['on_track']]} Hz {card}", flush=True)
    print(f"timing stream samples=4: {LIVE_MULTI_FRAMES / multi_s:.2f} Hz "
          f"({LIVE_MULTI_FRAMES} windowed pushes of the rendered frame, the "
          f"poses and scores fetched at the end) {card}", flush=True)
    if moved < 0.5 * MOVING_DRIFT_MM * n:
        raise AssertionError("the moving stream never chased the drift")
    s.begin(pose0)
    prof = profile_share(lambda: ([s.push(rgb, depth)
                                   for _ in range(LIVE_PROFILE_PUSHES)],
                                  s.current_pose()))
    s.close()
    mv.close()
    if prof is None:
        print("profile: torch.profiler recorded no device time; the live "
              "loop's device share not measured")
    else:
        busy_us, wall_us, n_ops, _ = prof
        print(f"profile: host_loop over {LIVE_PROFILE_PUSHES} pushes: device "
              f"busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
              f"({100 * busy_us / wall_us:.1f}%), "
              f"{n_ops / LIVE_PROFILE_PUSHES:.0f} device operations a push "
              f"{card}", flush=True)
    return hz


# ---------------------------------------------------------------------------
# Phase 10: the adaptive dispatcher (tracking/dispatch.py) and the synthetic
# pair factory (datagen/pair_producer.py).
# ---------------------------------------------------------------------------


def k_launches(k1=0, k3=0, p2=0):
    """A launch-count dict: K1, K3 and pass2_shade as given, K2 none."""
    return {"raster_pass1": k1, "gather_rows": 0,
            "raster_pass1_worklist": k3, "pass2_shade": p2}


def adaptive_video(rgb, depth):
    """Phase 4's ADAPTIVE_CHUNK frames followed by the same frames in
    reverse."""
    rgbs = np.stack([rgb] * ADAPTIVE_CHUNK)
    depths = np.stack([depth] * ADAPTIVE_CHUNK)
    return (np.concatenate([rgbs, rgbs[::-1]]),
            np.concatenate([depths, depths[::-1]]))


def run_adaptive(tracker, pose0, rgb, depth, card):
    """Phase 10.1: ``AdaptiveVideoTracker`` (ADAPTIVE_CANDIDATES,
    ADAPTIVE_PROBE) over ``adaptive_video``'s frames in chunks of
    ADAPTIVE_CHUNK from callables: bit-equal to ``track_video`` over the
    same frames; exactly one K1 and one ``pass2_shade`` a tracked frame, and
    ``compiled.WARMUP_CALLS`` + 1 of each a candidate in ``warmup`` (counted
    apart: it runs each candidate's program until it is captured). Returns
    the tracked run's launches."""
    from iros20_6d_pose_tracking_tpu_torch.tracking import compiled
    from iros20_6d_pose_tracking_tpu_torch.tracking.dispatch import (
        AdaptiveVideoTracker)

    rgbs, depths = adaptive_video(rgb, depth)
    n = len(rgbs)
    whole = tracker.track_video(pose0, rgbs, depths)
    d = AdaptiveVideoTracker(tracker, candidates=ADAPTIVE_CANDIDATES,
                             probe_frames=ADAPTIVE_PROBE)
    sync(tracker.device)
    zero_launches()
    d.warmup(rgb, depth, pose0, chunk_size=ADAPTIVE_CHUNK)
    warm = read_launches()
    zero_launches()
    poses, scores = d.track(pose0, lambda a, b: rgbs[a:b],
                            lambda a, b: depths[a:b], n_frames=n,
                            chunk_size=ADAPTIVE_CHUNK)
    launches = read_launches()
    nc = len(ADAPTIVE_CANDIDATES) * (compiled.WARMUP_CALLS + 1)
    want, want_warm = k_launches(n, 0, n), k_launches(nc, 0, nc)
    n_diff = int((poses != whole).sum())
    print(f"adaptive: {n} frames (phase 4's {ADAPTIVE_CHUNK}, then reversed) "
          f"in chunks of {ADAPTIVE_CHUNK}, candidates {ADAPTIVE_CANDIDATES}, "
          f"probe_frames {ADAPTIVE_PROBE}: launches {launches} (want {want}), "
          f"warm-up launches {warm} (want {want_warm}), pose entries "
          f"different from track_video: {n_diff}", flush=True)
    print(f"adaptive telemetry: {d.telemetry()}, steady ms/frame "
          f"{d.steady_ms_per_frame()}, segments (mode, frames, ms/frame, "
          f"phase) {d.segments} {card}", flush=True)
    if launches != want or warm != want_warm:
        raise AssertionError("adaptive launch counts are wrong")
    if n_diff or poses.shape != whole.shape or scores is not None:
        raise AssertionError("adaptive poses are not track_video's bits")
    # The random heads drift off the object within 200 frames; the first
    # ADAPTIVE_CHUNK are phase 4's video, held on the object there.
    check_on_object({"adaptive": poses[:ADAPTIVE_CHUNK]}, pose0,
                    tracker.cfg.object_width_mm)
    return launches


def run_adaptive_multi(tracker, pose0, rgb_r, depth_r):
    """Phase 10.2: samples 4 through the dispatcher (candidates
    ADAPTIVE_MULTI_CANDIDATES, probe_frames 4, chunks of
    ADAPTIVE_MULTI_CHUNK) on ADAPTIVE_MULTI_FRAMES copies of phase 8's
    rendered frame: every mode runs, and the poses and health scores are the
    bits of ``track_video_multi(first_frame=0)``; 2 K1 and 2
    ``pass2_shade`` a frame. Returns the launches."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.tracking import hypotheses as hy
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
    from iros20_6d_pose_tracking_tpu_torch.tracking.dispatch import (
        AdaptiveVideoTracker)

    t, dev, n = tracker, tracker.device, ADAPTIVE_MULTI_FRAMES
    rgbs, depths = np.stack([rgb_r] * n), np.stack([depth_r] * n)
    want_p, want_s = hy.track_video_multi(
        t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
        torch.as_tensor(pose0).to(dev), trk.upload_rgb(rgbs, dev),
        trk.upload_depth(depths, dev), samples=4)
    d = AdaptiveVideoTracker(t, candidates=ADAPTIVE_MULTI_CANDIDATES,
                             probe_frames=4, samples=4)
    d.warmup(rgb_r, depth_r, pose0, chunk_size=ADAPTIVE_MULTI_CHUNK)
    sync(dev)
    zero_launches()
    poses, scores = d.track(pose0, rgbs, depths,
                            chunk_size=ADAPTIVE_MULTI_CHUNK)
    launches = read_launches()
    want = k_launches(2 * n, 0, 2 * n)
    modes = sorted({m for m, *_ in d.segments})
    same = (np.array_equal(poses, want_p.cpu().numpy())
            and np.array_equal(scores, want_s.cpu().numpy()))
    print(f"adaptive samples=4: {n} frames, modes run {modes}, segments "
          f"{[(m, k, ph) for m, k, _, ph in d.segments]}, poses and scores "
          f"bit-equal to track_video_multi(first_frame=0): {same}, scores "
          f"{float(scores.min()):.4f}..{float(scores.max()):.4f}, launches "
          f"{launches} (want {want})", flush=True)
    if not same or launches != want or \
            modes != sorted(ADAPTIVE_MULTI_CANDIDATES):
        raise AssertionError("the samples-4 dispatcher differs from "
                             "track_video_multi")
    return launches


def run_predict_adaptive(root, ckpt, dev):
    """Phase 10.3: ``apps/predict.main --track_mode adaptive`` at chunk
    PREDICT_CHUNK on phase 8's tree: pose files equal to the scan run's of
    phase 8, 1 K1 + 1 ``pass2_shade`` a tracked frame plus
    ``compiled.WARMUP_CALLS`` + 1 of each a candidate's warm-up. Returns the
    launches."""
    from iros20_6d_pose_tracking_tpu_torch.apps import predict
    from iros20_6d_pose_tracking_tpu_torch.tracking import compiled

    n = PREDICT_FRAMES - 1
    cands = (1 + len([c for c in (PREDICT_CHUNK, 8, 1)
                      if PREDICT_CHUNK % c == 0])  # and the stream
             ) * (compiled.WARMUP_CALLS + 1)
    want = k_launches(n + cands, 0, n + cands)
    out = root / "out_adaptive"
    sync(dev)
    zero_launches()
    predict.main(["--mode", "ycbv", "--seq_id", "48", "--class_id", "4",
                  "--ycb_dir", str(root), "--train_data_path",
                  str(root / "train_data"), "--mean_std_path", str(root),
                  "--model_path", str(root / "object.obj"), "--ckpt_dir",
                  ckpt, "--device", str(dev), "--track_mode", "adaptive",
                  "--chunk_size", str(PREDICT_CHUNK), "--outdir", str(out)])
    launches = read_launches()
    scan_files = sorted(p.name for p in (root / "out_scan").glob("*.txt"))
    files = sorted(p.name for p in out.glob("*.txt"))
    same = files == scan_files and all(
        (out / f).read_bytes() == (root / "out_scan" / f).read_bytes()
        for f in files)
    print(f"adaptive predict --track_mode adaptive: {len(files)} files, equal "
          f"to the scan run's: {same}, launches {launches} (want {want}: {n} "
          f"tracked frames and {cands} warm-up frames)", flush=True)
    if not same or launches != want:
        raise AssertionError("predict adaptive differs from scan")
    return launches


def time_adaptive(tracker, pose0, rgb, depth, card):
    """Phase 10.4: Hz over ADAPTIVE_TURN_FRAMES frames (host clock, the
    poses on the host at the end) of ``track_video``, the dispatcher with
    ADAPTIVE_CANDIDATES and each candidate forced alone
    (``candidates=(c,)``), in turns and then the other way round; each
    dispatcher warmed up first. Returns the Hz by run."""
    from iros20_6d_pose_tracking_tpu_torch.tracking.dispatch import (
        AdaptiveVideoTracker)

    n = ADAPTIVE_TURN_FRAMES
    rgbs, depths = np.stack([rgb] * n), np.stack([depth] * n)
    runs = {"adaptive": AdaptiveVideoTracker(
        tracker, candidates=ADAPTIVE_CANDIDATES, probe_frames=ADAPTIVE_PROBE)}
    for c in ADAPTIVE_CANDIDATES:
        runs[f"forced {c}"] = AdaptiveVideoTracker(
            tracker, candidates=(c,), probe_frames=ADAPTIVE_PROBE)
    for d in runs.values():
        d.warmup(rgb, depth, pose0, chunk_size=n)
    order = ["track_video"] + list(runs)
    hz, steady = {k: [] for k in order}, []
    for name in order + order[::-1]:
        sync(tracker.device)
        t0 = time.perf_counter()
        if name == "track_video":
            tracker.track_video(pose0, rgbs, depths)
        else:
            runs[name].track(pose0, rgbs, depths, chunk_size=n)
        hz[name].append(n / (time.perf_counter() - t0))
        if name == "adaptive":
            steady.append((runs[name].mode, runs[name].steady_ms_per_frame()))
    print(f"timing adaptive in turns over {n} frames ({order}, then "
          f"reversed): " + ", ".join(f"{k} {[round(h, 2) for h in v]} Hz"
                                     for k, v in hz.items())
          + f"; adaptive (mode, steady ms/frame) {steady}; ms/frame "
          + ", ".join(f"{k} {[round(1e3 / h, 3) for h in v]}"
                      for k, v in hz.items()) + f" {card}", flush=True)
    return hz


def datagen_setup():
    """The pair factory's configuration: the production mesh, and from
    configs/dataset_info.yml (read by the port's ``utils/config``) the
    camera, the resolution, the normalisers (the perturbations' bounds) and
    the pose ranges; the object width as ``apps/datagen.py`` computes it;
    DR scenes with max_distractors 2 and occluder_prob 0.5. Returns (tm, K,
    ProducerConfig, DRSceneConfig, xyz_range)."""
    from iros20_6d_pose_tracking_tpu_torch.core.camera import Camera
    from iros20_6d_pose_tracking_tpu_torch.datagen import pair_producer as pp
    from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
    from iros20_6d_pose_tracking_tpu_torch.utils import config

    info = config.load_yaml(str(pathlib.Path(__file__).resolve().parent
                                / "configs" / "dataset_info.yml"))
    tm, _ = production_mesh()
    cam = Camera.from_dict(info["camera"])
    width = M.compute_obj_max_width(tm.verts) * (
        1 + info.get("boundingbox", 0) / 100.0)
    cfg = pp.ProducerConfig(
        resolution=int(info["resolution"]), object_width_mm=float(width),
        max_translation=float(info["max_translation"]),
        max_rotation_deg=float(info["max_rotation"]), width=cam.width,
        height=cam.height)
    b = info["blender"]
    xyz = (tuple(b["range_x"]), tuple(b["range_y"]), tuple(b["range_z"]))
    scene_cfg = pp.DRSceneConfig(width=cam.width, height=cam.height,
                                 max_distractors=2, occluder_prob=0.5)
    return tm, cam.K.astype(np.float32), cfg, scene_cfg, xyz


def run_datagen(tracker, dev, root, card):
    """Phase 10.5: ``produce_dataset`` of DATAGEN_TRAIN + DATAGEN_VAL pairs
    on the card into ``root`` (``datagen_setup``), timed on the host clock;
    launches exactly one K3 and one ``pass2_shade`` a scene layer and one
    K1 and one ``pass2_shade`` a pair (the counts the run records); the
    port's ``PairDataset`` reads both splits back, and one batch-4
    ``train_step`` on a copy of phase 4's network gives finite losses.
    Returns the launches."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.data.dataset import PairDataset
    from iros20_6d_pose_tracking_tpu_torch.datagen import pair_producer as pp
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
    from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

    tm, K, cfg, scene_cfg, xyz = datagen_setup()
    mesh = rz.upload(tm, dev)
    stats = {}
    sync(dev)
    zero_launches()
    t0 = time.perf_counter()
    train_dir, val_dir = pp.produce_dataset(
        mesh, K, str(root), cfg, DATAGEN_TRAIN, DATAGEN_VAL, xyz_range=xyz,
        seed=SEED, scene_cfg=scene_cfg, stats=stats)
    secs = time.perf_counter() - t0
    launches = read_launches()
    want = k_launches(stats["pairs"], stats["layers"],
                      stats["layers"] + stats["pairs"])
    ds, ds_val = (PairDataset(train_dir, cfg.resolution),
                  PairDataset(val_dir, cfg.resolution))
    print(f"datagen produce_dataset: {stats} at {cfg.width}x{cfg.height}, "
          f"resolution {cfg.resolution}, width {cfg.object_width_mm:.2f} mm, "
          f"normalisers {cfg.max_translation} m / {cfg.max_rotation_deg} "
          f"deg, xyz {xyz}; launches {launches} (want {want}); PairDataset "
          f"reads {len(ds)} train + {len(ds_val)} val pairs", flush=True)
    print(f"timing datagen: {stats['pairs'] / secs:.2f} pairs/s end to end "
          f"({stats['pairs']} pairs from {stats['scenes']} scenes of "
          f"{stats['layers']} layers in {secs:.3f} s: scenes, pairs, PNG "
          f"files) {card}", flush=True)
    if launches != want or stats["pairs"] != DATAGEN_TRAIN + DATAGEN_VAL \
            or (len(ds), len(ds_val)) != (DATAGEN_TRAIN, DATAGEN_VAL):
        raise AssertionError("produce_dataset's launches or pairs are wrong")
    net = copy.deepcopy(tracker.model)
    tcfg = tr.TrainConfig(resolution=cfg.resolution, batch_size=4)
    opt, lr_at = tr.make_optimizer(net, tcfg, 10)
    m = tr.train_step(net, opt, lr_at(0), tcfg,
                      torch.Generator(dev).manual_seed(SEED),
                      next(ds.batches(4, shuffle=False)), tracker.mean,
                      tracker.std)
    losses = {k: float(v) for k, v in m.items()}
    print(f"datagen train_step on a batch of 4 read back: {losses}",
          flush=True)
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError("the train step on the produced pairs is not "
                             "finite")
    return launches


def check_dr_scenes_with_cpu(dev):
    """Phase 10.6: DATAGEN_CPU_SCENES scenes of ``DRSceneGenerator`` on the
    card and on the port's plain CPU path, with the same seed (layouts) and
    draws: fewer than DR_PIXEL_SHARE of the pixels off (coverage or seg
    differ, depth beyond DR_DEPTH_BAR_MM, or rgb more than 1 level
    apart)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.datagen import pair_producer as pp
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    tm, K, _, scene_cfg, _ = datagen_setup()
    cpu = torch.device("cpu")
    gens = {d: pp.DRSceneGenerator(rz.upload(tm, d), K, scene_cfg,
                                   seed=SEED + 10) for d in (dev, cpu)}
    t0 = time.perf_counter()
    for i in range(DATAGEN_CPU_SCENES):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.03 * i, -0.02, 0.55 + 0.1 * i]
        draws = pp.draw_dr_photometry(torch.Generator().manual_seed(SEED + i),
                                      scene_cfg.height, scene_cfg.width, cpu,
                                      noise=False)
        out = {}
        for d, g in gens.items():
            n0 = g.layers
            out[d] = [x.cpu() for x in g.scene(pose, {
                k: None if v is None else v.to(d) for k, v in draws.items()})]
            layers = g.layers - n0
        (rgb, depth, seg), (rgb_c, depth_c, seg_c) = out[dev], out[cpu]
        bg = float(draws["bg_depth"])  # the depth where no layer renders
        cov = (depth != bg) != (depth_c != bg)
        far = (depth - depth_c).abs() > DR_DEPTH_BAR_MM
        seg_off = seg != seg_c
        rgb_off = (rgb - rgb_c).abs().amax(-1) > 1.0
        share = float((cov | far | seg_off | rgb_off).float().mean())
        n_bits = int((depth.view(torch.int32) != depth_c.view(torch.int32))
                     .sum())
        print(f"datagen scene {i} card vs plain CPU path: {layers} layers, "
              f"seg pixels {int(seg.sum())}; pixels whose coverage differs "
              f"{int(cov.sum())}, depth beyond {DR_DEPTH_BAR_MM} mm "
              f"{int(far.sum())}, seg differs {int(seg_off.sum())}, rgb > 1 "
              f"level {int(rgb_off.sum())}: {share:.2e} of the frame (bar "
              f"{DR_PIXEL_SHARE}); depth not bit-equal on {n_bits} pixels, "
              f"max |d depth| {float((depth - depth_c).abs().max()):.3e} mm, "
              f"max |d rgb| {float((rgb - rgb_c).abs().max()):.3e}",
              flush=True)
        if share >= DR_PIXEL_SHARE or seg.sum() == 0:
            raise AssertionError("a DR scene differs between the card and "
                                 "the CPU")
    print(f"datagen scenes card vs CPU: {time.perf_counter() - t0:.1f} s",
          flush=True)


def run_complete_blender(dev, root):
    """Phase 10.7: DATAGEN_BLENDER_IMAGES full-frame renders of the
    production mesh on the card written in the Blender stage-1 layout
    (``%07d{rgb,depth,seg}.png`` by ``write_png``, ``poses_in_world.npz``,
    class id 7, the camera at (0.1, 0.2, 1.5) in the world) into ``root``,
    then ``complete_blender``: one K1 and one ``pass2_shade`` a pair, one
    pair moved to validation, the stored B the CV-frame pose (1e-5).
    Returns the launches."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.datagen import pair_producer as pp
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    tm, K, cfg, _, _ = datagen_setup()
    mesh = rz.upload(tm, dev)
    gen = root / "generated_data"
    gen.mkdir(parents=True)
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    cam_in_world = np.eye(4)
    cam_in_world[:3, 3] = [0.1, 0.2, 1.5]
    poses = []
    for i in range(DATAGEN_BLENDER_IMAGES):
        pose_cv = np.eye(4)
        pose_cv[:3, 3] = [0.01 * i, -0.01 * i, 0.6]
        rgb, depth = rz.render(
            mesh, torch.as_tensor(pose_cv, dtype=torch.float32).to(dev),
            torch.as_tensor(K).to(dev),
            rz.full_frame_window(cfg.width, cfg.height),
            out_hw=(cfg.height, cfg.width), cull_backfaces=True)
        depth = depth.cpu().numpy()
        write_png(gen / f"{i:07d}rgb.png", rgb.cpu().numpy().astype(np.uint8))
        write_png(gen / f"{i:07d}depth.png", depth.astype(np.uint16))
        write_png(gen / f"{i:07d}seg.png", (depth > 0).astype(np.uint8) * 7)
        np.savez(gen / f"{i:07d}poses_in_world.npz", class_ids=np.array([7]),
                 poses_in_world=(cam_in_world @ np.linalg.inv(flip)
                                 @ pose_cv)[None],
                 blendercam_in_world=cam_in_world)
        poses.append(pose_cv)
    info = {"camera": {"focalX": float(K[0, 0]), "focalY": float(K[1, 1]),
                       "centerX": float(K[0, 2]), "centerY": float(K[1, 2]),
                       "width": cfg.width, "height": cfg.height},
            "resolution": cfg.resolution,
            "object_width": cfg.object_width_mm,
            "max_translation": cfg.max_translation,
            "max_rotation": cfg.max_rotation_deg, "val_samples": 1}
    sync(dev)
    zero_launches()
    train_dir, val_dir = pp.complete_blender(str(gen), str(root / "pairs"),
                                             info, mesh=mesh, class_id=7)
    launches = read_launches()
    n_train = len(list(pathlib.Path(train_dir).glob("*rgbA.png")))
    n_val = len(list(pathlib.Path(val_dir).glob("*rgbA.png")))
    want = k_launches(n_train + n_val, 0, n_train + n_val)
    B = [np.load(p)["B_in_cam"] for p in
         sorted(pathlib.Path(train_dir).glob("*meta.npz"))]
    err = max(float(np.abs(b - p).max()) for b, p in zip(B, poses))
    print(f"datagen complete_blender: {DATAGEN_BLENDER_IMAGES} Blender-layout "
          f"renders -> {n_train} train + {n_val} val pairs, launches "
          f"{launches} (want {want}), max |B_in_cam - pose| {err:.2e}",
          flush=True)
    if launches != want or n_val != 1 or \
            n_train + n_val != DATAGEN_BLENDER_IMAGES or err > 1e-5:
        raise AssertionError("complete_blender's pairs are wrong")
    return launches


def time_datagen(dev, card):
    """Phase 10.8: the pair factory's split over DATAGEN_TIMED scenes and
    pairs (a generator and producer of their own): scene render ms
    (``DRSceneGenerator.scene``) and pair render + crop ms
    (``PairProducer.generate`` with its PNG writer held back), CUDA events,
    median; PNG write ms (``_save``, host clock, median); then K3 and
    ``pass2_shade`` at the factory's new shapes, a 256-face primitive layer
    (a cube) and the 3072-face target layer at full frame, against their
    plain versions and bounds. Returns the kernels-line numbers of those
    shapes."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.datagen import pair_producer as pp
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    tm, K, cfg, scene_cfg, _ = datagen_setup()
    mesh = rz.upload(tm, dev)
    scenes = pp.DRSceneGenerator(mesh, K, scene_cfg, seed=SEED + 20)
    producer = pp.PairProducer(mesh, K, cfg)
    gen = torch.Generator(dev).manual_seed(SEED)
    held, scene_ms, pair_ms = [], [], []
    producer._save = lambda *a: held.append(a)

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        return res, start.elapsed_time(end)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dg_") as tmp:
        for i in range(DATAGEN_TIMED + 1):  # the first warms up
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = [0.02 * (i % 3), -0.01 * (i % 2), 0.5 + 0.02 * i]
            draws = pp.draw_dr_photometry(gen, cfg.height, cfg.width, dev,
                                          noise=False)
            (rgb, depth, seg), ms = timed(lambda: scenes.scene(pose, draws))
            _, ms2 = timed(lambda: producer.generate(
                tmp, pose, rgb, depth, 1, class_id=1, current_seg=seg,
                generator=gen))
            if i:
                scene_ms.append(ms)
                pair_ms.append(ms2)
        save = pp.PairProducer._save
        png_ms = []
        for a in held[1:]:
            t0 = time.perf_counter()
            save(producer, tmp, *a[1:])
            png_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"timing datagen split over {DATAGEN_TIMED} scenes: scene render "
          f"{float(np.median(scene_ms)):.3f} ms (DRSceneGenerator.scene, "
          f"{scenes.layers} layers in all, CUDA events, median), pair render "
          f"+ crop {float(np.median(pair_ms)):.3f} ms (generate without its "
          f"PNGs, {len(held) - 1} pairs, CUDA events, median), PNG write "
          f"{float(np.median(png_ms)):.3f} ms (5 PNGs and the npz, host "
          f"clock, median) {card}", flush=True)
    shapes = []
    prim_pose = np.eye(4, dtype=np.float32)
    prim_pose[:3, 3] = [0.04, -0.03, 0.45]
    target = np.eye(4, dtype=np.float32)
    target[:3, 3] = [0.02, -0.01, 0.55]
    for name, m, p in (("cube primitive layer", scenes._prims[0], prim_pose),
                       ("target layer", mesh, target)):
        c = render_case(m, p, K, rz.full_frame_window(cfg.width, cfg.height),
                        FRAME_HW, cull=False)
        c["iz"], c["win"] = rk.pass1_worklist(c["coef"], c["bbox"], FRAME_HW,
                                              c["fb"])
        label = (f"(datagen {name}: {int(m.fmask.sum())} faces padded to "
                 f"{m.fmask.shape[0]}, full frame)")
        args1 = (c["coef"], c["bbox"], FRAME_HW, c["fb"])
        args2 = (c["attr"], c["iz"], c["win"], c["R"], c["t"], FRAME_HW, FAR)
        for kname, fn, plain, bnd, args in (
                ("raster_pass1_worklist", rk.pass1_worklist,
                 rk.pass1_worklist_ref, pass1_bound(c, FRAME_HW), args1),
                ("pass2_shade", rk.pass2_shade, rk.pass2_shade_ref,
                 pass2_bound(c), args2)):
            r = report_kernel(kname, label, lambda: fn(*args),
                              lambda: plain(*args), bnd, card, plain_runs=5)
            shapes.append({"kernel": kname, "shape": name,
                           "faces": int(m.fmask.shape[0]), **r})
    return shapes


# ---------------------------------------------------------------------------
# Phase 11: the accuracy suite (the sensor model, the sweep, the ablation,
# the long-horizon and live recovery) and the bf16 CNN.
# ---------------------------------------------------------------------------


def check_suite_lighting(ff_production, dev, card):
    """Phase 11.1: ``pass2_shade`` against its plain version on full
    480x640 frames at the suite's lighting: the production mesh at the
    sensor model's x1 and x4 lighting (x4: ambient -0.15, the light at (1.4,
    -1.5, 1.3), beyond the object, so most lit values fall below 0 and the
    [0, 1] clamp does the work), and the textured box at
    ``texture_hostile``'s lighting (depth bit-equal, rgb within 1e-3, as
    ``check_pass2``); each timed beside its plain version and bound.
    ``ff_production``: phase 3's full-frame case of the production mesh
    with K3's outputs. Returns (max error, kernels-line rows)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.core import se3
    from iros20_6d_pose_tracking_tpu_torch.eval import domain_shift as DS
    from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    box = rz.upload(M.make_textured_box(), dev)
    pose = se3.make_pose(se3.so3_exp(torch.tensor([0.5, 0.3, -0.2])),
                         torch.tensor([0.01, -0.01, 0.55])).numpy()
    tex_case = full_frame_case(box, pose)
    tex_case["iz"], tex_case["win"] = rk.pass1_worklist(
        tex_case["coef"], tex_case["bbox"], FRAME_HW, tex_case["fb"])
    cases = [(f"production full frame, suite lighting x{s:g}", ff_production,
              None, DS.SensorModel().scaled(s)) for s in SUITE_SEVERITIES]
    cases.append(("textured box full frame, texture_hostile lighting",
                  tex_case, box.texture, DS.texture_hostile()))
    err, rows = 0.0, []
    for name, c, texture, sm in cases:
        light = sm.lighting(dev)
        err = max(err, check_pass2(name, c, FRAME_HW, texture=texture,
                                   lighting=light))
        args = (c["attr"], c["iz"], c["win"], c["R"], c["t"], FRAME_HW, FAR)
        kw = {"texture": texture, "lighting": light}
        r = report_kernel("pass2_shade", f"({name})",
                          lambda: rk.pass2_shade(*args, **kw),
                          lambda: rk.pass2_shade_ref(*args, **kw),
                          pass2_bound(c, texture), card, plain_runs=5)
        rows.append({"shape": name, "lighting": light.tolist(), **r})
    return err, rows


def shift_close(rgb_a, dep_a, rgb_b, dep_b, quant_mm):
    """The CPU tests' bars on two shifted videos: (max |rgb difference|,
    share of depth pixels that differ, whether every differing pixel is one
    quantization step apart or dropped on one side)."""
    d_rgb = float((rgb_a - rgb_b).abs().max())
    diff = dep_a != dep_b
    step = ((dep_a - dep_b).abs() - quant_mm).abs() <= 1e-5 * quant_mm
    dropped = (dep_a == 0) | (dep_b == 0)
    return (d_rgb, float(diff.float().mean()),
            bool((step | dropped)[diff].all()))


def check_shift_video(frames, gt, dev, card):
    """Phase 11.2: ``shift_video`` on the card against the port's CPU path
    on the same draws (made on the CPU), over the first SHIFT_CPU_FRAMES
    frames of phase 5's hard video, at the sensor model's x1 and x4: rgb
    within 1e-3 (of 255), depth different on at most 0.1% of pixels, each
    by one quantization step or by dropout (the CPU tests' bars). Then
    ``shift_video`` of the whole video on the card (its draws made there),
    ms per frame (CUDA events, median of SHIFT_TIMED_RUNS)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.eval import domain_shift as DS

    n = SHIFT_CPU_FRAMES
    rgb = torch.from_numpy(frames[0]).to(torch.float32)
    dep = torch.from_numpy(frames[1].astype(np.float32))
    draws = DS.draw_sensor_noise(torch.Generator().manual_seed(SEED), n,
                                 FRAME_HW, "cpu")
    draws_dev = {k: v.to(dev) for k, v in draws.items()}
    for s in SUITE_SEVERITIES:
        sm = DS.SensorModel().scaled(s)
        t0 = time.perf_counter()
        rgb_c, dep_c = DS.shift_video(rgb[:n], dep[:n], gt[:n], K_PROD, sm,
                                      draws=draws)
        cpu_s = time.perf_counter() - t0
        rgb_g, dep_g = DS.shift_video(rgb[:n].to(dev), dep[:n].to(dev),
                                      gt[:n], K_PROD, sm, draws=draws_dev)
        d_rgb, share, explained = shift_close(rgb_g.cpu(), dep_g.cpu(), rgb_c,
                                              dep_c, sm.depth_quant_mm)
        print(f"shift_video x{s:g} card vs plain CPU path, {n} frames of "
              f"phase 5's video at {FRAME_HW[0]}x{FRAME_HW[1]}: rgb max|d| "
              f"{d_rgb:.3e}, depth differs on {share:.2e} of pixels "
              f"(each a quantization step or dropout: {explained}); valid "
              f"depth {float((dep_g > 0).float().mean()):.4f} of pixels "
              f"(CPU path {cpu_s:.1f} s)", flush=True)
        if not (d_rgb <= 1e-3 and share <= 1e-3 and explained):
            raise AssertionError(f"shift_video x{s:g}: card and CPU disagree")
    rgb_d, dep_d = rgb.to(dev), dep.to(dev)
    T = rgb_d.shape[0]
    for s in SUITE_SEVERITIES:
        sm = DS.SensorModel().scaled(s)
        ms = cuda_ms(lambda: DS.shift_video(rgb_d, dep_d, gt, K_PROD, sm,
                                            seed=SEED),
                     runs=SHIFT_TIMED_RUNS, warmup=1)
        print(f"timing shift_video x{s:g}: {ms / T:.4f} ms per frame at "
              f"{FRAME_HW[0]}x{FRAME_HW[1]} ({T} frames in one batch, draws "
              f"made on the card; CUDA events, median of {SHIFT_TIMED_RUNS}) "
              f"{card}", flush=True)


def suite_launches_predicted(tracked_with_health):
    """The kernels' launches the reduced ``run_suite`` of phase 11 makes,
    from the code, for one untextured object on the hard video (object and
    occluder rendered a frame, each through K3 and ``pass2_shade``):
    training, one K1 + one ``pass2_shade`` per sampled batch (4 for the
    mean/std pass, one a step); ``evaluate_tracking`` one K1 + one
    ``pass2_shade`` a tracked frame (F - 1); videos: the matched one, the
    shifted one, one per sweep severity, two for the ablation (its seven
    rows share the renders of two lightings), the long horizon's (L
    frames); the long-horizon protocol and its recovery 2 + 2 a frame they
    track (the step and the health's render; ``tracked_with_health``, the
    frames of every ``track_video_with_health`` call: a chunk is tracked
    whole, and the frames after a fire are tracked again); the live
    recovery 2 + 2 a push (samples 4), L - 1 pushes; K2 never."""
    F, L, n_s = SUITE_FRAMES, SUITE_LONG, len(SUITE_SWEEP)
    train = 4 + SUITE_STEPS
    evals = 2 + n_s + 7  # matched, shifted, sweep, ablation rows
    videos = 2 + n_s + 2  # matched, shifted, sweep, ablation's two
    tracked = 2 * tracked_with_health + 2 * (L - 1)
    return {"raster_pass1": train + evals * (F - 1) + tracked,
            "gather_rows": 0,
            "raster_pass1_worklist": 2 * F * videos + 2 * L,
            "pass2_shade": (train + evals * (F - 1) + 2 * F * videos
                            + 2 * L + tracked)}


def run_suite_reduced(dev, card):
    """Phase 11.3: ``run_suite`` cut to size on the card: the production
    mesh as the object, SUITE_STEPS train steps at batch SUITE_BATCH,
    SUITE_FRAMES hard frames, the domain-shifted table, the sweep
    SUITE_SWEEP, the ablation, a SUITE_LONG-frame long horizon with its
    recovery and the live recovery (paced at 30 Hz, its default). Every AUC
    must be
    finite, the live row must say ``recovered`` and hold no nan, and each
    kernel's launches (zeroed just before, read just after) must be what
    ``suite_launches_predicted`` derives. Returns the launches."""
    from iros20_6d_pose_tracking_tpu_torch.eval import domain_shift as DS
    from iros20_6d_pose_tracking_tpu_torch.eval import synthetic_benchmark as SB

    lengths = []
    orig = DS.hy.track_video_with_health

    def counted(*a, **kw):
        lengths.append(int(a[7].shape[0]))  # frames_rgb
        return orig(*a, **kw)

    SB.OBJECTS["production"] = lambda: production_mesh()[0]
    DS.hy.track_video_with_health = counted
    try:
        t0 = time.perf_counter()
        zero_launches()
        results = SB.run_suite(
            ("production",), steps=SUITE_STEPS, frames=SUITE_FRAMES,
            batch=SUITE_BATCH, domain_shift=True,
            long_horizon_frames=SUITE_LONG, shift_sweep=SUITE_SWEEP,
            sweep_objects=("production",), recovery_objects=("production",),
            live_recovery_objects=("production",),
            ablation_objects=("production",), K=K_PROD, hw=FRAME_HW,
            log=lambda *a: print("suite:", *a, flush=True), device=dev)
        launches = read_launches()
        secs = time.perf_counter() - t0
    finally:
        del SB.OBJECTS["production"]
        DS.hy.track_video_with_health = orig
    want = suite_launches_predicted(sum(lengths))
    for k in launches:
        print(f"suite launches {k}: {launches[k]} (predicted {want[k]})")
    print(f"suite: track_video_with_health tracked {sum(lengths)} frames in "
          f"{len(lengths)} chunks; run_suite took {secs:.1f} s on the card "
          f"{card}", flush=True)
    if launches != want:
        raise AssertionError(f"suite launch counts {launches} != {want}")
    r = results[0]
    aucs = [r["add_auc"], r["adi_auc"], r["domain_shifted"]["add_auc"]]
    aucs += [p["add_auc"] for p in r["shift_sweep"] + r["shift_ablation"]]
    aucs += [r[k][a] for k in ("long_horizon", "recovery", "live_recovery")
             for a in ("add_auc", "adi_auc")]
    live = r["live_recovery"]
    print(f"suite: ADD AUC {r['add_auc']:.2f}, shifted "
          f"{r['domain_shifted']['add_auc']:.2f}, sweep "
          f"{[round(p['add_auc'], 2) for p in r['shift_sweep']]}, ablation "
          f"{[round(p['add_auc'], 2) for p in r['shift_ablation']]}, long "
          f"horizon {r['long_horizon']['add_auc']:.2f} (re-inits "
          f"{r['long_horizon']['reinit_frames']}), recovery "
          f"{SB.recovery_auc_text(r['recovery'])}, live "
          f"{SB.recovery_auc_text(live)} (random weights, {SUITE_STEPS} "
          "steps: a smoke run, not an accuracy)", flush=True)
    if not np.isfinite(aucs).all():
        raise AssertionError(f"suite AUCs not finite: {aucs}")
    floats = [v for v in live.values() if isinstance(v, float)]
    if "recovered" not in live or not np.isfinite(floats).all():
        raise AssertionError(f"live recovery row: {live}")
    return launches


def check_bf16(net, tracker, pose0, rgb, depth, card):
    """Phase 11.4, the bf16 CNN on the card with phase 4's weights and
    frames: one bf16 step against the float32 step under JAX's bars (1 mm,
    5e-3 on the rotation matrix); the drift of a BF16_VIDEO_FRAMES-frame
    bf16 ``track_video`` from the float32 one (printed, ROADMAP F1); the
    card's
    bf16 path against the CPU's bf16 path over BF16_CPU_FRAMES frames
    (BF16_CPU_BAR_M, BF16_CPU_BAR_RAD); ``track_video`` Hz bf16 and float32
    in turns; batch-200 ``train_step_synth`` samples/s bf16 and float32 in
    turns (TF32 off)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.models import tracknet
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
    from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

    dev, bf16 = tracker.device, torch.bfloat16
    t16 = make_tracker(net, dev, bf16)
    args = (torch.as_tensor(pose0).to(dev), trk.upload_rgb(rgb, dev),
            trk.upload_depth(depth, dev))
    steps = {}
    for name, t in (("float32", tracker), ("bf16", t16)):
        p, _ = trk.track_step(t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
                              *args)
        steps[name] = p.cpu().numpy()
    dt = float(np.linalg.norm(steps["bf16"][:3, 3] - steps["float32"][:3, 3]))
    dr = float(np.abs(steps["bf16"][:3, :3] - steps["float32"][:3, :3]).max())
    print(f"bf16 step vs float32 step on the card: |dt| {dt:.3e} m, max "
          f"|dR| {dr:.3e} (bars 1e-3, 5e-3)", flush=True)
    if not (dt < 1e-3 and dr < 5e-3):
        raise AssertionError("bf16 step disagrees with the float32 step")
    n = BF16_VIDEO_FRAMES
    rgbs, depths = np.stack([rgb] * n), np.stack([depth] * n)
    v32 = tracker.track_video(pose0, rgbs, depths)
    v16 = t16.track_video(pose0, rgbs, depths)
    drift_t = np.linalg.norm(v16[:, :3, 3] - v32[:, :3, 3], axis=-1)
    drift_r = [rot_angle(a[:3, :3], b[:3, :3]) for a, b in zip(v16, v32)]
    print(f"bf16 drift from float32 over {n} track_video frames: max "
          f"translation {drift_t.max():.4e} m (frame "
          f"{int(drift_t.argmax())}), last {drift_t[-1]:.4e} m; max angle "
          f"{max(drift_r):.4e} rad, last {drift_r[-1]:.4e} rad", flush=True)
    if not np.isfinite(v16).all():
        raise AssertionError("bf16 poses not finite")
    m = BF16_CPU_FRAMES
    t0 = time.perf_counter()
    c16 = make_tracker(net, "cpu", bf16).track_video(pose0, rgbs[:m],
                                                     depths[:m])
    dt = float(np.abs(c16[:, :3, 3] - v16[:m, :3, 3]).max())
    dr = max(rot_angle(a[:3, :3], b[:3, :3]) for a, b in zip(c16, v16[:m]))
    print(f"bf16 card vs plain CPU bf16 path, {m} frames: max |dt| "
          f"{dt:.3e} m, max rotation {dr:.3e} rad (bars {BF16_CPU_BAR_M}, "
          f"{BF16_CPU_BAR_RAD}; {time.perf_counter() - t0:.1f} s)",
          flush=True)
    if dt > BF16_CPU_BAR_M or dr > BF16_CPU_BAR_RAD:
        raise AssertionError("bf16 card and CPU trajectories disagree")
    hz = {}
    for name in ("float32", "bf16", "bf16", "float32"):
        t = tracker if name == "float32" else t16
        t.track_video(pose0, rgbs[:3], depths[:3])  # warm
        t0 = time.perf_counter()
        t.track_video(pose0, rgbs, depths)
        hz.setdefault(name, []).append(n / (time.perf_counter() - t0))
    print(f"timing track_video in turns ({n} frames each): float32 "
          f"{[round(h, 2) for h in hz['float32']]} Hz, bf16 "
          f"{[round(h, 2) for h in hz['bf16']]} Hz {card}", flush=True)
    _, synth, cfg = train_setup(dev)
    mean = torch.zeros(8, device=dev)
    std = torch.full((8,), 100.0, device=dev)
    models = {}
    for name, dtype in (("float32", torch.float32), ("bf16", bf16)):
        model = tracknet.init_params(
            tracknet.Se3TrackNet(image_size=RES, dtype=dtype).to(dev),
            torch.Generator().manual_seed(SEED))
        models[name] = (model, *tr.make_optimizer(model, cfg, 1000))
    rate, losses = {}, {}
    for turn, name in enumerate(("float32", "bf16", "bf16", "float32")):
        model, opt, lr_at = models[name]
        ms = []
        for i in range(BF16_TRAIN_STEPS + (1 if turn < 2 else 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            mt = tr.train_step_synth(model, opt, lr_at(i), cfg, synth,
                                     tr.step_generator(dev, 7, i),
                                     tr.step_generator(dev, 7, 10**6 + i),
                                     mean, std)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.setdefault(name, []).append(float(mt["loss"]))
        ms = ms[1:] if turn < 2 else ms  # the first turn's first step warms
        rate.setdefault(name, []).append(
            cfg.batch_size / float(np.median(ms)) * 1e3)
    print(f"timing train_step_synth in turns (batch {cfg.batch_size}, "
          f"{RES}^2, {BF16_TRAIN_STEPS} steps a turn, CUDA events, median): "
          f"float32 {[round(r, 2) for r in rate['float32']]} samples/s, bf16 "
          f"{[round(r, 2) for r in rate['bf16']]} samples/s (TF32 off) "
          f"{card}", flush=True)
    state16 = models["bf16"][0].state_dict().values()
    if not (np.isfinite(losses["bf16"]).all()
            and all(v.dtype in (torch.float32, torch.int64)
                    for v in state16)):
        raise AssertionError("bf16 training: losses not finite, or state "
                             "not float32")



# ---------------------------------------------------------------------------
# Phase 12: the scale-out layer (parallel/spmd.py, parallel/latency.py): an
# object ensemble and batched videos on the one card, ensemble training, the
# suite's ensemble mode, and two ranks sharing the card over gloo.
# ---------------------------------------------------------------------------

def ensemble_case(dev):
    """The JAX ``bench.py`` ``bench_ensemble`` objects: ENSEMBLE_O
    icospheres of subdivision 3, radii 0.04 to 0.07 m, each with its own
    seeded network (``build_model(SEED + o)``) and width, all tracking
    ENSEMBLE_T copies of phase 4's production frame from its pose. Returns
    a dict of the stacked state, meshes and inputs."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.parallel import spmd
    from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    O, T = ENSEMBLE_O, ENSEMBLE_T
    tms = [M.make_icosphere(subdiv=3, radius=r)
           for r in (0.04, 0.05, 0.06, 0.07)][:O]
    nets = [build_model(SEED + o).to(dev) for o in range(O)]
    pose0, rgb, depth = production_frames()
    frames_rgb = trk.upload_rgb(rgb, dev).expand((O, T) + rgb.shape)
    frames_depth = trk.upload_depth(depth, dev).expand((O, T) + depth.shape)
    return {"tms": tms, "nets": nets, "ens": spmd.stack_states(nets),
            "meshes": spmd.stack_meshes(tms, dev),
            "own": [rz.upload(tm, dev) for tm in tms],
            "widths": [float(tm.diameter) * 1000 * 1.1 for tm in tms],
            "cfg": trk.TrackerConfig(resolution=RES, cull_backfaces=True),
            "K": torch.as_tensor(K_PROD).to(dev),
            "mean": torch.zeros(8, device=dev),
            "std": torch.full((8,), 100.0, device=dev),
            "init": torch.as_tensor(pose0).to(dev).expand(O, 4, 4),
            "rgb": frames_rgb, "depth": frames_depth}


def check_track_close(name, poses, ref):
    """Per frame within 5e-4 m and 5e-3 rad of ``ref`` (phase 4's bars)."""
    poses, ref = poses.cpu().numpy(), ref.cpu().numpy()
    worst_t = float(np.abs(poses[..., :3, 3] - ref[..., :3, 3]).max())
    worst_r = max(rot_angle(a[:3, :3], b[:3, :3]) for a, b in zip(
        poses.reshape(-1, 4, 4), ref.reshape(-1, 4, 4)))
    print(f"{name}: worst translation {worst_t:.3e} m, rotation "
          f"{worst_r:.3e} rad", flush=True)
    if not np.isfinite(poses).all() or worst_t > 5e-4 or worst_r > 5e-3:
        raise AssertionError(f"{name}: beyond 5e-4 m / 5e-3 rad")


def timed_turns(runs, turns=SCALE_TURNS, warm=True):
    """{name: [seconds]} of each ``fn`` of ``runs`` ({name: (fn, frames)}),
    run in turns (each ends with its result on the host), after a warm-up
    call each unless ``warm`` is False (each has just run)."""
    import torch

    for fn, _ in runs.values() if warm else ():
        fn()
    torch.cuda.synchronize()
    secs = {k: [] for k in runs}
    for _ in range(turns):
        for k, (fn, _) in runs.items():
            t0 = time.perf_counter()
            fn().cpu()
            secs[k].append(time.perf_counter() - t0)
    return secs


def print_rates(what, runs, secs, card):
    for k, (_, frames) in runs.items():
        rates = [frames / s for s in secs[k]]
        print(f"timing {what} {k}: {np.median(rates):.2f} frames/s aggregate "
              f"(median of {len(rates)} turns, all "
              f"{np.round(rates, 2).tolist()}) {card}", flush=True)


def run_ensemble_tracking(c, card):
    """Phase 12.1: ``multi_object_track_videos`` on the one-card layout.
    Serial: each object's poses are ``track_video``'s on its own mesh, bit
    for bit, with ENSEMBLE_O x ENSEMBLE_T K1 and ``pass2_shade`` launches;
    batched: within 5e-4 m and 5e-3 rad of serial, one K1 and one
    ``pass2_shade`` launch a frame over the O views. Aggregate frames/s of
    serial, batched and O sequential ``track_video`` runs, in turns; K1 and
    ``pass2_shade`` at the O-view shape. Returns (launches by path, the
    kernels' numbers at the O-view shape)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.parallel import spmd
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    O, T = ENSEMBLE_O, ENSEMBLE_T
    one = spmd.make_mesh(1)
    args = (c["ens"], c["meshes"], c["K"], c["mean"], c["std"], c["init"],
            c["rgb"], c["depth"], c["widths"])
    fns = {serial: functools.partial(spmd.multi_object_track_videos(
        c["ens"].model, c["cfg"], one, serial=serial), *args)
        for serial in (True, False)}
    launches, poses = {}, {}
    for serial, want in ((True, O * T), (False, T)):
        torch.cuda.synchronize()
        zero_launches()
        poses[serial] = fns[serial]()
        got = read_launches()
        launches[serial] = got
        exp = {"raster_pass1": want, "gather_rows": 0,
               "raster_pass1_worklist": 0, "pass2_shade": want}
        print(f"ensemble tracking {'serial' if serial else 'batched'} "
              f"(O={O}, T={T}): launches {got} (predicted {exp})", flush=True)
        if got != exp:
            raise AssertionError(f"ensemble launches {got} != {exp}")

    def sequential():
        return torch.stack([trk.track_video(
            c["nets"][o], c["cfg"], c["own"][o], c["K"], c["mean"], c["std"],
            c["init"][o], c["rgb"][o], c["depth"][o], c["widths"][o])
            for o in range(O)])

    ref = sequential()
    bad = [o for o in range(O) if not torch.equal(ref[o], poses[True][o])]
    moved = float((poses[True][:, -1, :3, 3] - c["init"][:, :3, 3]).norm(
        dim=-1).min())
    print(f"ensemble serial against per-object track_video: objects "
          f"different {bad}; least motion {moved * 1e3:.2f} mm", flush=True)
    if bad:
        raise AssertionError("serial ensemble is not track_video's bits")
    check_track_close("ensemble batched against serial", poses[False],
                      poses[True])
    runs = {"serial": (fns[True], O * T), "batched": (fns[False], O * T),
            f"{O} sequential track_video": (sequential, O * T)}
    print_rates(f"ensemble_{O}obj", runs, timed_turns(runs, warm=False),
                card)
    return launches, views_report(c["meshes"], c["init"], c["K"],
                                  torch.tensor(c["widths"], device=c[
                                      "K"].device), f"{O} ensemble objects",
                                  card)


def views_report(meshes, poses, K, widths, label, card):
    """K1 and ``pass2_shade`` at the culled views of one batched step (each
    checked against its plain version first), timed beside their plain
    versions and bounds. Returns ({kernel: numbers}, K1 error, pass 2
    error)."""
    from iros20_6d_pose_tracking_tpu_torch.ops import roi
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    hw = (RES, RES)
    window = rz.window_from_bbox(roi.compute_bbox(
        poses, K, widths, (1000.0, 1000.0, 1000.0)))
    c = render_case(meshes, poses, K, window, hw, cull=True)
    e1, c["iz"], c["win"] = check_batched_pass1(label, c["coef"], c["bbox"],
                                                hw, c["fb"])
    e3 = check_pass2(label, c, hw)
    out = {}
    args1 = (c["coef"], c["bbox"], hw, c["fb"])
    args2 = (c["attr"], c["iz"], c["win"], c["R"], c["t"], hw, FAR)
    for name, fn, plain, args, bnd in (
            ("raster_pass1", rk.pass1_winners, rk.pass1_winners_ref, args1,
             pass1_bound(c, hw)),
            ("pass2_shade", rk.pass2_shade, rk.pass2_shade_ref, args2,
             pass2_bound(c))):
        r = report_kernel(name, f"(culled, {label} at {RES}^2)",
                          lambda: fn(*args), lambda: plain(*args), bnd, card,
                          plain_runs=5)
        out[name] = {"views": int(poses.shape[0]), "res": RES,
                     **{k: v for k, v in r.items() if k != "library_ms"}}
    return out, e1, e3


def run_batched_videos(tracker, pose0, rgb, depth, card):
    """Phase 12.2: ``batched_track_videos`` at the JAX ``bench_multi``
    shape, VIDEOS_V videos of VIDEOS_T production frames (inits 2 mm
    apart), against per-video ``track_video`` within 5e-4 m and 5e-3 rad,
    with one K1 and one ``pass2_shade`` launch a frame; aggregate frames/s
    in turns with V sequential ``track_video`` runs."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.parallel import spmd
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    V, T = VIDEOS_V, VIDEOS_T
    dev = tracker.device
    init = torch.as_tensor(pose0).to(dev).repeat(V, 1, 1)
    init[:, 0, 3] += torch.arange(V, device=dev) * 0.002 - 0.007
    frames_rgb = trk.upload_rgb(rgb, dev).expand((V, T) + rgb.shape)
    frames_depth = trk.upload_depth(depth, dev).expand((V, T) + depth.shape)
    run = functools.partial(
        spmd.batched_track_videos(tracker.model, tracker.cfg,
                                  spmd.make_mesh(1)),
        tracker.mesh, tracker.K, tracker.mean, tracker.std, init,
        frames_rgb, frames_depth)
    torch.cuda.synchronize()
    zero_launches()
    poses = run()
    launches = read_launches()
    exp = {"raster_pass1": T, "gather_rows": 0, "raster_pass1_worklist": 0,
           "pass2_shade": T}
    print(f"batched videos (V={V}, T={T}): launches {launches} (predicted "
          f"{exp})", flush=True)
    if launches != exp:
        raise AssertionError(f"batched video launches {launches} != {exp}")

    def sequential():
        return torch.stack([trk.track_video(
            tracker.model, tracker.cfg, tracker.mesh, tracker.K, tracker.mean,
            tracker.std, init[v], frames_rgb[v], frames_depth[v])
            for v in range(V)])

    check_track_close("batched videos against per-video track_video", poses,
                      sequential())
    runs = {"batched": (run, V * T),
            f"{V} sequential track_video": (sequential, V * T)}
    print_rates(f"aggregate_{V}video", runs, timed_turns(runs, warm=False),
                card)
    w = torch.full((V,), tracker.cfg.object_width_mm, device=dev)
    return launches, views_report(tracker.mesh, init, tracker.K, w,
                                  f"{V} videos", card)


def run_ensemble_training(dev, card):
    """Phase 12.3: ``ensemble_train_step`` at ENSEMBLE_O objects, batch
    TRAIN_BATCH at 176^2 (the cube's sampler with DR for every object, its
    batches drawn by ``ensemble_synth_batch``), ENSEMBLE_TRAIN_STEPS steps at
    lr 1e-5 serial and batched, each against per-object ``train_step`` on
    the same batches and draws under the card's training bars
    (TRAIN_CHECKS["sampled"]: cuDNN's training is not bit-reproducible);
    then samples/s of serial, batched and per-object steps in turns."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.data import augment as A
    from iros20_6d_pose_tracking_tpu_torch.data import dataset as DS
    from iros20_6d_pose_tracking_tpu_torch.models import tracknet
    from iros20_6d_pose_tracking_tpu_torch.parallel import spmd
    from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
    from iros20_6d_pose_tracking_tpu_torch.train import compare
    from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

    O, n, lr = ENSEMBLE_O, TRAIN_BATCH, 1e-5
    tms = [M.make_cube(0.08)] * O
    cfg = tr.TrainConfig(resolution=RES, batch_size=n)
    ens_mesh = spmd.stack_meshes(tms, dev)
    widths = [tms[0].diameter * 1000 * 1.1] * O
    Kt = torch.as_tensor(K_PROD).to(dev)
    steps = ENSEMBLE_TRAIN_STEPS
    batches = [DS.ensemble_synth_batch(
        ens_mesh, Kt, [tr.step_generator(dev, 7, i, o) for o in range(O)],
        widths, n, RES, 0.02, 15.0, TRAIN_XYZ, DS.DRComposite())
        for i in range(steps)]
    draws = [[A.draw_augment(tr.step_generator(dev, 8, i, o), n, (RES, RES),
                             cfg.aug, dev) for o in range(O)]
             for i in range(steps)]
    mean = torch.tensor([120, 110, 100, 0, 120, 110, 100, 0],
                        dtype=torch.float32, device=dev)
    std = torch.tensor([70, 70, 70, 300, 70, 70, 70, 300],
                       dtype=torch.float32, device=dev)

    def fresh():
        pairs = []
        for o in range(O):
            net = tracknet.init_params(
                tracknet.Se3TrackNet(image_size=RES).to(dev),
                torch.Generator().manual_seed(SEED + o))
            pairs.append((net, tr.make_optimizer(net, cfg, 1000)[0]))
        return pairs

    refs = []
    for o, (net, opt) in enumerate(fresh()):
        losses, grads = [], []
        for i in range(steps):
            m = tr.train_step(net, opt, lr, cfg, None,
                              {k: v[o] for k, v in batches[i].items()},
                              mean, std, aug_draws=draws[i][o])
            losses.append(float(m["loss"]))
            grads.append(compare.grads_of(net))
        refs.append((net, losses, grads, net.state_dict()))
    bars = TRAIN_CHECKS["sampled"]
    steppers = {}
    for serial in (True, False):
        ens = spmd.stack_states(fresh())
        step = spmd.ensemble_train_step(ens.model, ens.opt, cfg,
                                        spmd.make_mesh(1), serial=serial)
        steppers[serial] = (ens, step)
        zero_launches()
        grads = []
        for i in range(steps):
            m = step(ens, lr, None, batches[i], mean, std,
                     aug_draws=draws[i])
            grads.append({k: v.grad.detach().cpu() for k, v in
                          ens.params.items()})
            losses = m["loss"].cpu().numpy()
            ref_l = np.array([r[1][i] for r in refs])
            rel = float(np.abs(losses / ref_l - 1).max())
            if rel > 1e-4:
                raise AssertionError(f"ensemble train loss {losses} vs "
                                     f"{ref_l}")
        if read_launches() != {k: 0 for k in WRAPPERS}:
            raise AssertionError("the train step launched a raster kernel")
        for o, (net, _, g_ref, sd_ref) in enumerate(refs):
            g = [{k: v[o] for k, v in gi.items()} for gi in grads]
            p, b = ens.tensors(o)
            rg = compare.compare_grads(net, g[0], g_ref[0], **bars["grads"])
            rs = compare.compare_states(
                net, {k: v.detach() for k, v in {**p, **b}.items()}, sd_ref,
                compare.noisy(g, g_ref), lr, steps, **bars["states"])
            worst = {k: round(v[1], 3) for k, v in {**rg, **rs}.items()
                     if k != "noisy"}
            print(f"ensemble train {'serial' if serial else 'batched'} object "
                  f"{o}: loss within {rel:.2e} relative; bars (worst ratio) "
                  f"{worst}", flush=True)
            if compare.failed(rg, rs):
                raise AssertionError(f"ensemble train object {o} beyond the "
                                     f"card's bars: {compare.failed(rg, rs)}")

    per = fresh()

    def turn(fn):
        def run():
            for i in range(steps):
                out = fn(i)
            return out
        return run

    runs = {
        "serial": (turn(lambda i: steppers[True][1](
            steppers[True][0], lr, None, batches[i], mean, std,
            aug_draws=draws[i])["loss"]), O * n * steps),
        "batched": (turn(lambda i: steppers[False][1](
            steppers[False][0], lr, None, batches[i], mean, std,
            aug_draws=draws[i])["loss"]), O * n * steps),
        f"{O} per-object train_step": (turn(lambda i: torch.stack([
            tr.train_step(net, opt, lr, cfg, None,
                          {k: v[o] for k, v in batches[i].items()}, mean,
                          std, aug_draws=draws[i][o])["loss"]
            for o, (net, opt) in enumerate(per)])), O * n * steps)}
    secs = timed_turns(runs, turns=2)
    for k, (_, samples) in runs.items():
        rates = [samples / s for s in secs[k]]
        print(f"timing ensemble train {k}: {np.median(rates):.2f} samples/s "
              f"(O={O}, batch {n} each, {RES}^2, float32, TF32 off; median "
              f"of {len(rates)} turns of {steps} steps, all "
              f"{np.round(rates, 2).tolist()}) {card}", flush=True)


def suite_ensemble_predicted(n_obj):
    """The launches of the reduced ``run_suite(ensemble=True)`` of phase
    12.4, from the code: training, one K1 + one ``pass2_shade`` a sampled
    batch an object (``ensemble_synth_batch``; 4 for the statistics, one a
    step); each object's hard video, object and occluder through K3 and
    ``pass2_shade`` a frame; the ensemble evaluation (serial on one card),
    one K1 + one ``pass2_shade`` a tracked frame an object; K2 never."""
    F = SUITE_ENSEMBLE_FRAMES
    k1 = n_obj * (4 + SUITE_ENSEMBLE_STEPS) + n_obj * (F - 1)
    k3 = n_obj * 2 * F
    return {"raster_pass1": k1, "gather_rows": 0,
            "raster_pass1_worklist": k3, "pass2_shade": k1 + k3}


def run_suite_ensemble(dev, card):
    """Phase 12.4: ``run_suite(ensemble=True)`` cut to size on the card: the
    production mesh and the cube trained as one ensemble
    (SUITE_ENSEMBLE_STEPS steps at batch SUITE_BATCH), SUITE_ENSEMBLE_FRAMES
    hard frames each, evaluated in one call: every row ``"ensemble"``, the
    AUCs finite, and the launches ``suite_ensemble_predicted``'s."""
    from iros20_6d_pose_tracking_tpu_torch.eval import synthetic_benchmark as SB

    SB.OBJECTS["production"] = lambda: production_mesh()[0]
    try:
        t0 = time.perf_counter()
        zero_launches()
        results = SB.run_suite(
            ("production", "cube"), ensemble=True, steps=SUITE_ENSEMBLE_STEPS,
            frames=SUITE_ENSEMBLE_FRAMES, batch=SUITE_BATCH, K=K_PROD,
            hw=FRAME_HW, log=lambda *a: print("suite ensemble:", *a,
                                              flush=True), device=dev)
        launches = read_launches()
        secs = time.perf_counter() - t0
    finally:
        del SB.OBJECTS["production"]
    want = suite_ensemble_predicted(2)
    print(f"suite ensemble: launches {launches} (predicted {want}); "
          f"eval paths {[r['eval_path'] for r in results]}; ADD AUC "
          f"{[round(r['add_auc'], 2) for r in results]}; {secs:.1f} s {card}",
          flush=True)
    if launches != want:
        raise AssertionError(f"suite ensemble launches {launches} != {want}")
    if [r["eval_path"] for r in results] != ["ensemble", "ensemble"] or \
            not np.isfinite([r["add_auc"] for r in results]).all():
        raise AssertionError("suite ensemble rows")
    return launches


def _rank_main(rank, world, tmp):
    """One of the two ranks of phase 12.5, sharing card 0 over gloo."""
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        out = rank_checks(rank, world)
        torch.save(out, f"{tmp}/rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def rank_checks(rank, world):
    """Phase 12.5 on one rank (card 0, CUDA tensors, gloo): the face-sharded
    render of the production icosphere before its decimation (5120 faces,
    3072 a shard, each shard holding real faces) at phase 4's pose in its
    ROI, without the cull (so both shards cover pixels), against the
    single
    render at the bars of JAX's test (depth within 0.02 mm, under 2e-3 of
    pixels more than 2 levels apart in rgb), K1 and K2 at the rank's shard
    against their plain versions bit for bit, ``sp_track_step`` against
    ``track_step`` (1e-5, JAX's bar), ``dp_train_step`` against
    ``train_step`` on the whole batch (the card's training bars), their
    launches, and the sharded render's and K2's times."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.core import se3
    from iros20_6d_pose_tracking_tpu_torch.data import augment as A
    from iros20_6d_pose_tracking_tpu_torch.kernels import build as kbuild
    from iros20_6d_pose_tracking_tpu_torch.models import tracknet
    from iros20_6d_pose_tracking_tpu_torch.ops import roi
    from iros20_6d_pose_tracking_tpu_torch.parallel import latency as lat
    from iros20_6d_pose_tracking_tpu_torch.parallel import spmd
    from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
    from iros20_6d_pose_tracking_tpu_torch.train import compare
    from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    se3.pin_full_fp32()
    for name in REPLACES:
        kbuild.load(name)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    card = f"[{card}, rank {rank} of {world}]"
    tracker = make_tracker(build_model(SEED), dev)
    pose0, rgb, depth = production_frames()
    pose = torch.as_tensor(pose0).to(dev)
    # the production mesh before its decimation (5120 faces): shards of
    # 3072 faces, each holding real ones; no cull, so both shards' faces
    # cover pixels and the z-test across ranks decides
    mesh = rz.upload(M.make_icosphere(subdiv=4, radius=0.05), dev)
    cfg = dataclasses.replace(tracker.cfg, cull_backfaces=False)
    spm = lat.sp_mesh()
    shard = lat.shard_mesh_faces(mesh, spm)
    bbox = roi.compute_bbox(pose, tracker.K, tracker.cfg.object_width_mm,
                            (1000.0, 1000.0, 1000.0))
    render = lat.sharded_render(cfg, spm)
    seen = {}
    zero_launches()
    rgb_s, depth_s = render(shard, pose, tracker.K, bbox, parts=seen)
    launches = {"sharded_render": read_launches()}
    rgb_1, depth_1 = rz.render(mesh, pose, tracker.K,
                               rz.window_from_bbox(bbox), out_hw=(RES, RES))
    d_err = float((depth_s - depth_1).abs().max())
    off = float(((rgb_s - rgb_1).abs().amax(-1) > 2.0).float().mean())
    hits = int((depth_1 > 0).sum())
    print(f"rank {rank}: sharded render ({shard.fverts.shape[0]} faces a "
          f"shard) against the single render: depth max|d| {d_err:.3e} mm, "
          f"rgb >2 levels apart on {off:.2e} of pixels, {hits} hit pixels",
          flush=True)
    if d_err > 0.02 or off >= 2e-3 or hits < 1000:
        raise AssertionError(f"rank {rank}: sharded render beyond JAX's bars")
    coef, bb, hw, fb = seen["k1"]
    e1 = check_pass1(f"rank {rank} shard", coef, bb, hw, fb)[0]
    attr, win, cov = seen["k2"]
    e2 = check_gather(f"rank {rank} owned rows of the shard", attr, win, cov)

    zero_launches()
    frame_rgb = trk.upload_rgb(rgb, dev)
    frame_depth = trk.upload_depth(depth, dev)
    sp_pose = lat.sp_track_step(tracker.model, cfg, spm)(
        shard, tracker.K, tracker.mean, tracker.std, pose, frame_rgb,
        frame_depth)
    launches["sp_track_step"] = read_launches()
    one_pose, _ = trk.track_step(tracker.model, cfg, mesh,
                                 tracker.K, tracker.mean, tracker.std, pose,
                                 frame_rgb, frame_depth)
    p_err = float((sp_pose - one_pose).abs().max())
    print(f"rank {rank}: sp_track_step against track_step: max|d pose| "
          f"{p_err:.3e}; launches {launches}", flush=True)
    if p_err > 1e-5:
        raise AssertionError(f"rank {rank}: sp_track_step beyond 1e-5")

    # dp_train_step on the whole batch's halves against train_step
    n, lr = DP_BATCH, 1e-5
    synth = train_setup(dev)[1]
    cfg = tr.TrainConfig(resolution=RES, batch_size=n)
    raw = synth.sample_batch(tr.step_generator(dev, 5, 0), n)
    draws = [A.draw_augment(tr.step_generator(dev, 6, i), n, (RES, RES),
                            cfg.aug, dev) for i in range(2)]
    mean = torch.tensor([120, 110, 100, 0, 120, 110, 100, 0],
                        dtype=torch.float32, device=dev)
    std = torch.tensor([70, 70, 70, 300, 70, 70, 70, 300],
                       dtype=torch.float32, device=dev)
    runs = {}
    for how in ("dp", "one"):
        net = tracknet.init_params(tracknet.Se3TrackNet(image_size=RES).to(
            dev), torch.Generator().manual_seed(SEED))
        opt, _ = tr.make_optimizer(net, cfg, 1000)
        step = spmd.dp_train_step(net, opt, cfg, spmd.make_mesh()) \
            if how == "dp" else functools.partial(tr.train_step, net, opt)
        losses, grads = [], []
        for d in draws:
            m = step(lr, None, raw, mean, std, aug_draws=d) if how == "dp" \
                else step(lr, cfg, None, raw, mean, std, aug_draws=d)
            losses.append(float(m["loss"]))
            grads.append(compare.grads_of(net))
        runs[how] = (net, losses, grads, net.state_dict())
    bars = TRAIN_CHECKS["sampled"]
    net = runs["one"][0]
    rg = compare.compare_grads(net, runs["dp"][2][0], runs["one"][2][0],
                               **bars["grads"])
    rs = compare.compare_states(
        net, runs["dp"][3], runs["one"][3],
        compare.noisy(runs["dp"][2], runs["one"][2]), lr, 2,
        **bars["states"])
    rel = max(abs(a / b - 1) for a, b in zip(runs["dp"][1], runs["one"][1]))
    worst = {k: round(v[1], 3) for k, v in {**rg, **rs}.items()
             if k != "noisy"}
    print(f"rank {rank}: dp_train_step (batch {n}, {n // world} a rank) "
          f"against train_step: loss within {rel:.2e} relative; bars (worst "
          f"ratio) {worst}", flush=True)
    if rel > 1e-4 or compare.failed(rg, rs):
        raise AssertionError(f"rank {rank}: dp_train_step beyond the card's "
                             f"bars")

    # times: the sharded render against the single render; K2 at the shape
    sharded_ms = cuda_ms(lambda: render(shard, pose, tracker.K, bbox))
    single_ms = cuda_ms(lambda: rz.render(
        mesh, pose, tracker.K, rz.window_from_bbox(bbox),
        out_hw=(RES, RES)))
    print(f"timing rank {rank}: sharded render {sharded_ms:.4f} ms (CUDA "
          f"events, median of {TIMING_RUNS}; its three collectives through "
          f"gloo), single render {single_ms:.4f} ms {card}", flush=True)
    k2 = report_kernel(
        "gather_rows", f"(owned rows of a shard, ({RES}x{RES}) x "
        f"{attr.shape[1]} rows, rank {rank})", lambda: rk.gather_rows(
            attr, win, cov), lambda: rk.gather_rows_ref(attr, win, cov),
        bound(nbytes(win, cov) + winner_rows_bytes(attr, win, cov)
              + win.numel() * attr.shape[1] * 4, 0), card,
        library_fn=lambda: torch.index_select(attr, 0, win))
    return {"launches": launches, "k1_err": e1, "k2_err": e2,
            "sharded_ms": sharded_ms, "single_ms": single_ms,
            "k2": {"rows": int(win.numel()), "cols": int(attr.shape[1]),
                   **{k: v for k, v in k2.items()}}}


def run_two_ranks(card):
    """Phase 12.5: two processes on the one card, gloo on CUDA tensors
    (NCCL refuses two ranks on one device), each running ``rank_checks``;
    joined with a timeout. Returns rank 0's result."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(_rank_main, args=(2, tmp), nprocs=2,
                                 join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                if time.perf_counter() - t0 > RANKS_TIMEOUT_S:
                    raise AssertionError("the two ranks did not end within "
                                         f"{RANKS_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        import torch

        outs = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                for r in range(2)]
    want = {"raster_pass1": 1, "gather_rows": 1, "raster_pass1_worklist": 0,
            "pass2_shade": 0}
    for r, o in enumerate(outs):
        for path, got in o["launches"].items():
            if got != want:
                raise AssertionError(f"rank {r} {path} launches {got} != "
                                     f"{want}")
    print(f"two ranks: both ranks' checks passed in "
          f"{time.perf_counter() - t0:.1f} s (process start-up included); "
          f"launches per rank {outs[0]['launches']} {card}", flush=True)
    return outs[0]


# ---------------------------------------------------------------------------
# Phase 13: the TF32 pin (F16), profiling, render_at_bbox and the apps.
# ---------------------------------------------------------------------------

def _f16_child(rank, tmp):
    """Phase 13.1's fresh process: TF32 left at torch's default, the
    module-level ``track_video`` over F16_FRAMES production frames with no
    ``Tracker`` built; every convolution's ``cudnn.allow_tf32`` recorded by
    a forward pre-hook (the hooks run where the forward runs in Python: the
    program's eager warm-up calls and its capture; a replay runs the
    convolutions the capture recorded)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
    from iros20_6d_pose_tracking_tpu_torch.tracking import compiled
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    default = [torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32]
    dev = torch.device("cuda", 0)
    net = build_model(SEED).to(dev)
    seen = []
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_pre_hook(
                lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
    tm, cull = production_mesh()
    cfg = trk.TrackerConfig(
        resolution=RES, object_width_mm=float(tm.diameter) * 1000 * 1.1,
        cull_backfaces=cull)
    pose0, rgb, depth = production_frames()
    poses = trk.track_video(
        net, cfg, rz.upload(tm, dev), torch.from_numpy(K_PROD).to(dev),
        torch.zeros(8, device=dev), torch.full((8,), 100.0, device=dev),
        torch.from_numpy(pose0).to(dev),
        trk.upload_rgb(np.stack([rgb] * F16_FRAMES), dev),
        trk.upload_depth(np.stack([depth] * F16_FRAMES), dev))
    prog, = compiled.programs.programs()
    torch.save({"default": default, "seen": seen, "poses": poses.cpu(),
                "eager_calls": prog.eager_calls, "replays": prog.replays,
                "captured": prog.graph is not None}, f"{tmp}/f16.pt")


def check_f16(tracker, pose0, rgb, depth, card):
    """Phase 13.1, F16 on the card: ``_f16_child`` in a spawned process; its
    convolutions all ran with TF32 off (each Python-side forward: the
    program's eager calls and its capture, which every replay runs), and
    its poses are the bits of this (pinned) process's module-level
    ``track_video`` on the same inputs."""
    import torch
    import torch.multiprocessing as mp

    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    dev = tracker.device
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f16_") as tmp:
        ctx = mp.start_processes(_f16_child, args=(tmp,), nprocs=1,
                                 join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                if time.perf_counter() - t0 > F16_TIMEOUT_S:
                    raise AssertionError("the unpinned process did not end "
                                         f"within {F16_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        child = torch.load(f"{tmp}/f16.pt", weights_only=False)
    child_s = time.perf_counter() - t0
    pinned = trk.track_video(
        tracker.model, tracker.cfg, tracker.mesh, tracker.K, tracker.mean,
        tracker.std, torch.from_numpy(pose0).to(dev),
        trk.upload_rgb(np.stack([rgb] * F16_FRAMES), dev),
        trk.upload_depth(np.stack([depth] * F16_FRAMES), dev)).cpu()
    seen = child["seen"]
    n_on = sum(bool(v) for v in seen)
    diff = float((child["poses"] - pinned).abs().max())
    equal = torch.equal(child["poses"], pinned)
    print(f"F16: a fresh process with TF32 at torch's default (matmul, "
          f"cudnn allow_tf32 = {child['default']}) ran the module-level "
          f"track_video over {F16_FRAMES} production frames, no Tracker "
          f"({child['eager_calls']} eager calls, captured "
          f"{child['captured']}, {child['replays']} replays): "
          f"{len(seen)} convolution calls, {n_on} with cudnn.allow_tf32 on; "
          f"poses bit-equal to the pinned process's: {equal} (max |d| "
          f"{diff:.3e}); {child_s:.1f} s with the process's start {card}",
          flush=True)
    if not child["default"][1]:
        raise AssertionError("the fresh process did not start with torch's "
                             "default cudnn.allow_tf32")
    n_conv = sum(isinstance(m, torch.nn.Conv2d)
                 for m in tracker.model.modules())
    forwards = child["eager_calls"] + child["captured"]
    if len(seen) != n_conv * forwards or n_on or not child["captured"] or \
            child["eager_calls"] + child["replays"] != F16_FRAMES:
        raise AssertionError(f"F16: {n_on} of {len(seen)} convolution calls "
                             f"ran with TF32 allowed ({forwards} forwards "
                             "in Python)")
    if not equal:
        raise AssertionError("F16: the unpinned process's poses differ from "
                             "the pinned process's")


@contextlib.contextmanager
def tf32_convolutions():
    """For the F1 measurement only: the network's forward stops pinning
    float32 and cuDNN may run its convolutions in TF32 (``flags`` with
    ``enabled=True``: its default, ``enabled=False``, turns cuDNN off)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.core import se3

    pin = se3.pin_full_fp32
    se3.pin_full_fp32 = lambda: None
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            yield
    finally:
        se3.pin_full_fp32 = pin


def tf32_drift(tracker, card):
    """Phase 13.2, F1 measured: the production network's heads at batch 1
    and 200 (seeded standard-normal 176^2 inputs) with TF32 convolutions
    against float32; printed in head units and as pose (x the tracker's
    normalizers). Gates nothing but finite outputs."""
    import torch

    model, cfg = tracker.model, tracker.cfg
    gen = torch.Generator(tracker.device).manual_seed(SEED + 13)
    rows = []
    for n in TF32_BATCHES:
        A, B = (torch.randn((n, RES, RES, 4), generator=gen,
                            device=tracker.device) for _ in range(2))
        with torch.no_grad():
            ref = model(A, B)
            with tf32_convolutions():
                tf = model(A, B)
        if torch.backends.cudnn.allow_tf32:
            raise AssertionError("TF32 stayed on after the measurement")
        dt = float((tf["trans"] - ref["trans"]).abs().max())
        dr = float((tf["rot"] - ref["rot"]).abs().max())
        if not all(bool(torch.isfinite(o[k]).all()) for o in (ref, tf)
                   for k in ("trans", "rot")):
            raise AssertionError("the TF32 measurement gave non-finite heads")
        rows.append((n, dt, dr))
        print(f"F1: TF32 against float32 convolutions, batch {n} at {RES}^2 "
              f"(seeded N(0, 1) inputs): max |d trans head| {dt:.3e} "
              f"({dt * cfg.trans_normalizer:.3e} m), max |d rot head| "
              f"{dr:.3e} ({dr * cfg.rot_normalizer:.3e} rad) {card}",
              flush=True)
    return rows


def check_profiling(tracker, pose0, rgb, depth, card):
    """Phase 13.3, ``utils/profiling`` on the card: ``StepTimer`` over a
    function that only enqueues a TIMER_SLEEP_MS device sleep reports no
    less than the sleep's device time (CUDA events); its ``track_step`` ms
    beside ``cuda_ms``'s; ``trace`` around TRACE_FRAMES ``track_video``
    frames writes a trace naming K1's and ``pass2_shade``'s kernels."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
    from iros20_6d_pose_tracking_tpu_torch.utils import profiling as prof

    sleep_cycles_per_ms.cache_clear()
    cycles = int(TIMER_SLEEP_MS * sleep_cycles_per_ms())

    def sleep():
        torch.cuda._sleep(cycles)

    sleep_ms = cuda_ms(sleep, runs=5, warmup=1)
    timed = prof.StepTimer(warmup=1, reps=5).measure(sleep)
    print(f"StepTimer: a function that enqueues a {TIMER_SLEEP_MS:g} ms "
          f"device sleep ({cycles} cycles, {sleep_ms:.4f} ms by CUDA events, "
          f"median of 5): per_iter_ms {timed['per_iter_ms']:.4f} (best of "
          f"5), mean_s {timed['mean_s']:.6f} {card}", flush=True)
    # A timer that returned at the enqueue would read ~0.01 ms. The sleep's
    # own length varies by microseconds from call to call, so the bar is
    # the nominal length, or the sleep's median where clocks ran it
    # shorter, not one call's length.
    if not timed["per_iter_ms"] >= min(TIMER_SLEEP_MS, sleep_ms):
        raise AssertionError("StepTimer returned before the device finished")

    dev = tracker.device
    args = (tracker.model, tracker.cfg, tracker.mesh, tracker.K, tracker.mean,
            tracker.std, torch.from_numpy(pose0).to(dev),
            trk.upload_rgb(rgb, dev), trk.upload_depth(depth, dev))
    step = prof.StepTimer(warmup=3, reps=20).measure(trk.track_step, *args)
    ev_ms = cuda_ms(lambda: trk.track_step(*args))
    print(f"StepTimer: track_step at the production shape per_iter_ms "
          f"{step['per_iter_ms']:.4f} (best of 20, host clock to "
          f"synchronize) beside {ev_ms:.4f} ms (CUDA events, median of "
          f"{TIMING_RUNS}), {step['hz']:.2f} Hz {card}", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as logdir:
        with prof.trace(logdir):
            tracker.track_video(pose0, np.stack([rgb] * TRACE_FRAMES),
                                np.stack([depth] * TRACE_FRAMES))
        files = list(pathlib.Path(logdir).rglob("*.json*"))
        size = sum(f.stat().st_size for f in files)
        text = "".join(f.read_text(errors="replace") for f in files)
    named = {k: DEVICE_FN[k] in text for k in ("raster_pass1", "pass2_shade")}
    print(f"trace: {len(files)} file(s), {size} bytes around "
          f"{TRACE_FRAMES} track_video frames; kernels named {named} {card}",
          flush=True)
    if not files or not size or not all(named.values()):
        raise AssertionError("trace wrote no trace naming K1 and "
                             "pass2_shade")


def check_render_at_bbox(tracker, pose0, net, card):
    """Phase 13.4: ``render_at_bbox`` at the production pose, bit-equal to
    ``render`` at ``window_from_bbox(compute_bbox(...))`` on the card, one
    K1 and one ``pass2_shade`` launch, and against the CPU path: bbox equal,
    and tests/test_torch_raster.py's bars for renders whose projections
    round differently (its jitted-JAX case): coverage differing on under
    0.1% of pixels, depth within 2e-3 relative where both cover, rgb more
    than 1 level apart on under 0.1% of pixels. (The card's projection and
    per-face forms round otherwise than the CPU's, so their depths differ
    in the last bits; given the same pass-1 outputs, ``pass2_shade`` is
    held to its plain version's bits by ``check_pass2``.) Returns its
    launches."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.ops import roi
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    kw = {"out_hw": (RES, RES), "cull_backfaces": tracker.cfg.cull_backfaces}

    def args(t):
        return (t.mesh, torch.from_numpy(pose0).to(t.device), t.K,
                t.cfg.object_width_mm)

    zero_launches()
    rgb, depth, bbox = rz.render_at_bbox(*args(tracker), **kw)
    torch.cuda.synchronize()
    launches = read_launches()
    mesh, pose, K, width = args(tracker)
    ref = rz.render(mesh, pose, K, rz.window_from_bbox(roi.compute_bbox(
        pose, K, width, (1000.0, 1000.0, 1000.0))), **kw)
    bit_equal = torch.equal(rgb, ref[0]) and torch.equal(depth, ref[1])
    rgb_c, depth_c, bbox_c = (x.to(tracker.device) for x in rz.render_at_bbox(
        *args(make_tracker(net, torch.device("cpu"))), **kw))
    cov_off = float(((depth > 0) != (depth_c > 0)).float().mean())
    both = (depth > 0) & (depth_c > 0)
    rel = float(((depth - depth_c).abs() / depth_c.clamp(min=1e-6))[both]
                .max()) if bool(both.any()) else float("inf")
    depth_bits = int((depth.view(torch.int32) != depth_c.view(torch.int32))
                     [both].sum())
    d_rgb = (rgb - rgb_c).abs()
    rgb_off = float((d_rgb.amax(-1) > 1.0).float().mean())
    want = {"raster_pass1": 1, "gather_rows": 0, "raster_pass1_worklist": 0,
            "pass2_shade": 1}
    print(f"render_at_bbox: production pose at {RES}^2, cull="
          f"{tracker.cfg.cull_backfaces}: bit-equal to render at its window "
          f"{bit_equal}, launches {launches}; against the CPU path: bbox "
          f"equal {torch.equal(bbox, bbox_c)}, coverage differs on "
          f"{cov_off:.2e} of pixels, depth bits differ on {depth_bits} of "
          f"{int(both.sum())} pixels both cover (max relative |d| "
          f"{rel:.3e}), rgb max|d| {float(d_rgb.max()):.3e}, >1 level apart "
          f"on {rgb_off:.2e} of pixels {card}", flush=True)
    if not bit_equal or launches != want or not torch.equal(bbox, bbox_c) \
            or cov_off >= 1e-3 or not rel <= 2e-3 or rgb_off >= 1e-3:
        raise AssertionError("render_at_bbox disagrees")
    return launches


def demo_launches_predicted(steps, frames):
    """The kernels' launches of ``apps/demo_train_and_track`` (clean, no
    DR), from the code: ``train_object`` renders one batch of views (one K1
    and one ``pass2_shade``) for each of its 4 mean/std batches and each
    step; ``render_test_video`` one full frame (K3 and ``pass2_shade``) a
    frame; ``evaluate_tracking`` one ROI (K1 and ``pass2_shade``) for each
    frame after the first."""
    return {"raster_pass1": 4 + steps + frames - 1, "gather_rows": 0,
            "raster_pass1_worklist": frames,
            "pass2_shade": 4 + steps + 2 * frames - 1}


def run_apps(root, dev, card):
    """Phase 13.5: the demo at DEMO_STEPS steps, batch DEMO_BATCH and
    DEMO_FRAMES frames (launches as ``demo_launches_predicted``, finite
    metrics, ``add_per_frame.txt`` with a value a frame, the ``DEMO``
    line), the YCB-style fixture and the real-data dry run, all on
    ``dev``. Returns each one's launches."""
    import io

    import torch

    from iros20_6d_pose_tracking_tpu_torch.apps import (demo_train_and_track,
                                                         make_ycb_fixture,
                                                         realdata_dryrun)

    class Tee(io.StringIO):
        def write(self, s):
            sys.__stdout__.write(s)
            return super().write(s)

    out, got, secs = Tee(), {}, {}
    t0 = time.perf_counter()
    zero_launches()
    with contextlib.redirect_stdout(out):
        rc = demo_train_and_track.main([
            "--steps", str(DEMO_STEPS), "--batch", str(DEMO_BATCH),
            "--frames", str(DEMO_FRAMES), "--device", str(dev),
            "--outdir", str(root / "demo")])
    torch.cuda.synchronize()
    got["demo"] = read_launches()
    secs["demo"] = time.perf_counter() - t0
    want = demo_launches_predicted(DEMO_STEPS, DEMO_FRAMES)
    add = np.loadtxt(root / "demo" / "add_per_frame.txt")
    lines = out.getvalue().splitlines()
    metrics = [float(v) for v in re.findall(
        r"(?:mean|max|AUC|err)[=:] ?(-?[\d.]+|nan|inf)", out.getvalue())]
    print(f"demo: {DEMO_STEPS} steps at batch {DEMO_BATCH}, {DEMO_FRAMES} "
          f"frames: exit code {rc}, launches {got['demo']} (predicted "
          f"{want}), {secs['demo']:.1f} s {card}", flush=True)
    if got["demo"] != want:
        raise AssertionError("the demo's launches differ from the prediction")
    if add.shape != (DEMO_FRAMES,) or not np.isfinite(add).all() or \
            len(metrics) != 6 or not np.isfinite(metrics).all():
        raise AssertionError("the demo's metrics are not finite")
    if not lines or lines[-1] not in ("DEMO clean PASS", "DEMO clean FAIL") \
            or rc != (0 if lines[-1].endswith("PASS") else 1):
        raise AssertionError("the demo printed no DEMO line")

    t0 = time.perf_counter()
    zero_launches()
    make_ycb_fixture.main(["--root", str(root / "fixture"), "--frames",
                           str(FIXTURE_FRAMES), "--device", str(dev)])
    torch.cuda.synchronize()
    got["fixture"] = read_launches()
    secs["fixture"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    zero_launches()
    realdata_dryrun.main(["--frames", str(DRYRUN_FRAMES), "--device",
                          str(dev), "--root", str(root / "dryrun")])
    torch.cuda.synchronize()
    got["dryrun"] = read_launches()
    secs["dryrun"] = time.perf_counter() - t0
    n = DRYRUN_FRAMES
    # the fixture renders a full frame a frame (K3); the dry run renders
    # the frames of two objects (K3) and tracks three videos (K1): the two
    # ycbv_all runs from frame 1 (frame 0 holds the init), the ycbineoat
    # run from frame 0
    wants = {"fixture": {"raster_pass1": 0, "gather_rows": 0,
                         "raster_pass1_worklist": FIXTURE_FRAMES,
                         "pass2_shade": FIXTURE_FRAMES},
             "dryrun": {"raster_pass1": 3 * n - 2, "gather_rows": 0,
                        "raster_pass1_worklist": 2 * n,
                        "pass2_shade": 5 * n - 2}}
    for name, w in wants.items():
        print(f"{name} on the card: launches {got[name]} (predicted {w}), "
              f"{secs[name]:.1f} s {card}", flush=True)
        if got[name] != w:
            raise AssertionError(f"{name}: launches differ from the "
                                 "prediction")
    return got


# ---------------------------------------------------------------------------
# Phase 14: where a track is lost (XLA's int32 conversion, the lost-track
# regimes of tests/test_torch_lost_track.py on the card) and F14's float64
# witness.
# ---------------------------------------------------------------------------

def check_int32_conversion(dev, card):
    """Phase 14.1: ``core/camera.round_to_int32``, ``project_points`` and
    ``compute_bbox`` give XLA's ints for INT32_INPUTS on the card and on the
    CPU (unit intrinsics and z = 1 put each input on a pixel axis as it
    is). torch's own conversion on the card is printed beside them (a
    reading: the port does not use it)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.core import camera
    from iros20_6d_pose_tracking_tpu_torch.ops import roi

    x = torch.tensor(INT32_INPUTS, dtype=torch.float32)
    K1 = torch.eye(3)
    pts = torch.stack([x, x.flip(0), torch.ones_like(x)], -1)
    poses = torch.eye(4).repeat(len(x), 1, 1)
    poses[:, 0, 3], poses[:, 1, 3] = x, x.flip(0)
    want = torch.tensor(INT32_XLA, dtype=torch.int32)
    got = {}
    for d in (torch.device("cpu"), dev):
        got[d.type] = [camera.round_to_int32(x.to(d)).cpu(),
                       camera.project_points(pts.to(d), K1.to(d)).cpu(),
                       roi.compute_bbox(poses.to(d), K1.to(d), 0.0).cpu()]
    own = torch.round(x.to(dev)).to(torch.int32).cpu()
    print(f"int32 conversion of {list(INT32_INPUTS)}: round_to_int32 on the "
          f"card {got[dev.type][0].tolist()}, XLA {list(INT32_XLA)}; torch's "
          f"own .to(torch.int32) on the card {own.tolist()} {card}",
          flush=True)
    for where, (conv, proj, bbox) in got.items():
        for name, a, b in (("round_to_int32", conv, want),
                           ("project_points u", proj[:, 0], want),
                           ("project_points v", proj[:, 1], want.flip(0)),
                           ("compute_bbox u", bbox[:, :, 1],
                            want[:, None].expand(-1, 4)),
                           ("compute_bbox v", bbox[:, :, 0],
                            want.flip(0)[:, None].expand(-1, 4))):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} on the {where}: {a.tolist()} "
                                     f"is not XLA's {b.tolist()}")


def lost_track_poses(width_mm):
    """The prior poses of the lost-track regimes at the production camera,
    name -> (4, 4) float32: the window clipped by the left border, wholly
    right of the frame, inside the near plane, behind the camera, at z = 0,
    a NaN translation, and one corner of the window on the principal point
    with the others past 2^31 pixels."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.core import se3

    fx, cx = float(K_PROD[0, 0]), float(K_PROD[0, 2])
    z, half = 0.6, width_mm / 2000.0
    regimes = {
        "clipped": ((CLIPPED_PX - cx) * z / fx, 0.0, z),
        "outside": ((FRAME_HW[1] + OUTSIDE_PX - cx) * z / fx, 0.05, z),
        "near plane": (0.004, -0.003, 0.05),
        "behind": (0.004, -0.003, -0.3),
        "z0": (0.01, -0.005, 0.0),
        "nan": (float("nan"), 0.0, 0.5),
        "corner past int32": (half, half, 1e-9),
    }
    R = se3.so3_exp(torch.tensor([0.2, 0.4, 0.1])).numpy()
    out = {}
    for name, t in regimes.items():
        p = np.eye(4, dtype=np.float32)
        p[:3, :3], p[:3, 3] = R, t
        out[name] = p
    return out


def check_regime(name, bbox, aux):
    """The regime ``name`` was reached by a step with ``aux`` from a prior
    pose whose bbox is ``bbox`` (numpy (4, 2) (v, u))."""
    u, depth_a, depth_b = bbox[:, 1], aux["depthA"], aux["depthB"]
    extreme = (bbox == 2147483647) | (bbox == -2147483648)
    ok = {"clipped": u.min() < 0 < u.max() < FRAME_HW[1]
          and bool((depth_a > 0).any()),
          "outside": u.min() >= FRAME_HW[1] and not depth_b.any(),
          "near plane": not depth_a.any(),
          "behind": not depth_a.any(),
          "z0": bool(extreme.all()) and not depth_a.any(),
          "nan": bool((u == 0).all()) and not depth_a.any(),
          "corner past int32": bool(extreme.any()) and bool(
              (bbox == np.round([K_PROD[1, 2], K_PROD[0, 2]])).all(-1).any())
          and not depth_a.any()}[name]
    if not ok:
        raise AssertionError(f"lost track {name}: regime not reached (bbox "
                             f"{bbox.tolist()})")


def run_lost_track(net, tracker, rgb, depth, card):
    """Phase 14.2: one ``track_step`` on the card from each prior pose of
    :func:`lost_track_poses` on phase 4's frame, and the same step on the
    port's plain CPU path: each regime reached, the bbox ints and B's crop
    equal, the poses within phase 4's bars (5e-4 m, 5e-3 rad) with NaN at
    the same entries, and K1 and ``pass2_shade`` launched once a step
    without error. Returns the launches."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.ops import roi
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    cpu = make_tracker(net, torch.device("cpu"))
    poses = lost_track_poses(tracker.cfg.object_width_mm)
    frames = {t.device.type: (trk.upload_rgb(rgb, t.device),
                              trk.upload_depth(depth, t.device))
              for t in (tracker, cpu)}
    out = {}
    zero_launches()
    for name, prior in poses.items():
        for t in (tracker, cpu):
            p = torch.as_tensor(prior).to(t.device)
            pose, aux = trk.track_step(t.model, t.cfg, t.mesh, t.K, t.mean,
                                       t.std, p, *frames[t.device.type])
            bbox = roi.compute_bbox(p, t.K, t.cfg.object_width_mm,
                                    (1000.0, 1000.0, 1000.0))
            out[t.device.type] = (pose.cpu().numpy(), bbox.cpu().numpy(),
                                  {k: v.cpu().numpy() for k, v in
                                   aux.items()})
        (pc, bc, ac), (pg, bg, ag) = out["cpu"], out[tracker.device.type]
        check_regime(name, bg, ag)
        dt = float(np.nanmax(np.abs(pg[:3, 3] - pc[:3, 3]), initial=0.0))
        dr = (rot_angle(pg[:3, :3], pc[:3, :3])
              if np.isfinite(pg[:3, :3]).all() else 0.0)
        same_nan = np.array_equal(np.isnan(pg), np.isnan(pc))
        print(f"lost track {name}: bbox {bg[:, 0].min()}..{bg[:, 0].max()} x "
              f"{bg[:, 1].min()}..{bg[:, 1].max()} (CPU equal: "
              f"{np.array_equal(bg, bc)}), rendered pixels "
              f"{int((ag['depthA'] > 0).sum())}, observed "
              f"{int((ag['depthB'] > 0).sum())}; card vs CPU |dt| {dt:.3e} m,"
              f" rotation {dr:.3e} rad, NaN entries "
              f"{int(np.isnan(pg).sum())} (same: {same_nan})", flush=True)
        if not (np.array_equal(bg, bc) and same_nan and dt <= 5e-4
                and dr <= 5e-3 and np.array_equal(ag["depthB"], ac["depthB"])
                and np.array_equal(ag["rgbB"], ac["rgbB"])):
            raise AssertionError(f"lost track {name}: card and CPU disagree")
    sync(tracker.device)
    launches = read_launches()
    want = {"raster_pass1": len(poses), "gather_rows": 0,
            "raster_pass1_worklist": 0, "pass2_shade": len(poses)}
    print(f"lost track: {len(poses)} steps, launches {launches} {card}",
          flush=True)
    if launches != want:
        raise AssertionError(f"lost-track launches {launches} != {want}")
    return launches


def f14_witness(dev, card):
    """Phase 14.3, F14: the "sampled" train check's first step (its batch,
    weights and augmentation draws, lr 1e-5) in float64 on the card
    (``tracknet.as_float64``), and the distance from it of the first-step
    gradients in float32 (``train/compare.distances``: per tensor, conv
    biases apart, ||g - g64|| / ||g64||) on the card under cuDNN's default,
    deterministic and off, and on the CPU with and without oneDNN. Fails
    if float64 on the card and on the CPU lie more than F64_BAR apart, or
    the card's default more than F14_BAR from float64 or more than
    F14_RATIO times the CPU's distance."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.data import augment as AUG
    from iros20_6d_pose_tracking_tpu_torch.models import tracknet
    from iros20_6d_pose_tracking_tpu_torch.train import compare
    from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    n = CPU_TRAIN_BATCH
    raw, aug_cfg, mean, std = sampled_check_batch(dev, RES, n)
    base = tracknet.init_params(tracknet.Se3TrackNet(image_size=RES),
                                torch.Generator().manual_seed(SEED + 6))
    lr = TRAIN_CHECKS["sampled"]["runs"][0][0]
    cfg = tr.TrainConfig(resolution=RES, batch_size=n, learning_rate=lr,
                         aug=aug_cfg)
    draws = [AUG.draw_augment(torch.Generator().manual_seed(SEED + 10), n,
                              (RES, RES), cfg.aug, cpu)]

    def first_grads(model, device, onednn=True, cudnn=None):
        ctx = (torch.backends.cudnn.flags(**cudnn, allow_tf32=False)
               if cudnn is not None else contextlib.nullcontext())
        with ctx:
            return train_run(model, raw, draws, mean, std, cfg, 1, device,
                             onednn)[1][0]

    base64 = tracknet.as_float64(base)
    ref = first_grads(base64, dev)
    f64_gap = max(compare.distances(base, first_grads(base64, cpu),
                                    ref).values())
    sides = {
        "card, cuDNN default": (dev, True, None),
        "card, cuDNN deterministic": (dev, True, dict(
            enabled=True, benchmark=False, deterministic=True)),
        "card, cuDNN off": (dev, True, dict(enabled=False)),
        "CPU, oneDNN": (cpu, True, None),
        "CPU without oneDNN": (cpu, False, None),
    }
    worst = {}
    for side, (device, onednn, cudnn) in sides.items():
        d = compare.distances(base, first_grads(base, device, onednn, cudnn),
                              ref)
        worst[side] = max(d.values())
        print(f"F14 {side}: first-step gradients from float64 on the card, "
              f"worst {worst[side]:.3e} ({max(d, key=d.get)}), median "
              f"{float(np.median(list(d.values()))):.3e} over {len(d)} "
              f"tensors {card}", flush=True)
    ratio = worst["card, cuDNN default"] / worst["CPU, oneDNN"]
    print(f"F14: sampled batch of {n} at {RES}^2, lr {lr}: float64 card vs "
          f"CPU {f64_gap:.3e} (bar {F64_BAR}); card (cuDNN default) / CPU "
          f"(oneDNN) worst distance from float64 {ratio:.2f}; "
          f"{time.perf_counter() - t0:.1f} s {card}", flush=True)
    if f64_gap > F64_BAR or worst["card, cuDNN default"] > F14_BAR \
            or ratio > F14_RATIO:
        raise AssertionError(
            f"F14: the card's float32 gradients lie beyond {F14_BAR} of "
            f"float64 or beyond {F14_RATIO}x the CPU's distance, or float64 "
            f"differs between the card and the CPU by more than {F64_BAR}")
    return worst, f64_gap


# ---------------------------------------------------------------------------
# Phase 15: the compiled step (tracking/compiled.py): one CUDA graph a key,
# replayed by track_video, on_track, the dispatcher and the stream.
# ---------------------------------------------------------------------------


def eager_video(tracker, pose, rgb_t, depth_t):
    """The eager step frame by frame over device frames, the pose carried
    on the device: the port's ``track_video`` before its steps were
    compiled. Returns (T, 4, 4) poses on the device."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    t = tracker
    out = torch.empty((rgb_t.shape[0], 4, 4), dtype=torch.float32,
                      device=t.device)
    for i in range(rgb_t.shape[0]):
        pose, _ = trk.track_step(t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
                                 pose, rgb_t[i], depth_t[i])
        out[i] = pose
    return out


def eager_on_track(tracker, pose, rgb, depth):
    """``Tracker.on_track`` at samples 1 as the port ran it before its step
    was compiled: upload, the eager step, the pose to the host."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    t, dev = tracker, tracker.device
    new, _ = trk.track_step(
        t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
        torch.as_tensor(np.asarray(pose), dtype=torch.float32).to(dev),
        trk.upload_rgb(rgb, dev), trk.upload_depth(depth, dev))
    return new.cpu().numpy()


class EagerPrograms:
    """For timing only: stands in for a ``StreamTracker``'s program cache,
    so that every push runs the eager step (the stream before its steps
    were compiled)."""

    def __len__(self):
        return 0

    def step(self, model, cfg, mesh, K, mean, std, prev_pose, rgb, depth,
             object_width_mm=None, frame_offset_vu=None):
        from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

        pose, _ = trk.track_step(model, cfg, mesh, K, mean, std, prev_pose,
                                 rgb, depth, object_width_mm, frame_offset_vu)
        return pose


def program_line(prog):
    """One program's key in brief, its capture time and its counts."""
    frame = tuple(prog.rgb.shape[1:3])
    return (f"frame {frame[0]}x{frame[1]} {str(prog.rgb.dtype)[6:]}/"
            f"{str(prog.depth.dtype)[6:]}, slots {prog.slots}, offset "
            f"{prog.offset is not None}, capture "
            + ("none" if prog.capture_ms is None
               else f"{prog.capture_ms:.3f} ms")
            + f", {prog.eager_calls} eager calls, {prog.replays} replays, "
            f"launches a replay {replay_launches(prog)}")


def replay_launches(prog):
    """The kernel launches a replay of ``prog`` adds, by wrapper."""
    return {n[len("launches."):]: c for n, c in prog.replay_counts.items()
            if n.startswith("launches.")}


def check_replays_sync_free(tracker, pose0, rgb, depth, rgb_t, depth_t):
    """Phase 15.4: COMPILED_SYNC_PUSHES windowed pushes (a warmed stream)
    and a replayed ``track_video`` over the phase's frames under
    ``torch.cuda.set_sync_debug_mode("error")``: a synchronizing call
    raises."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.tracking import compiled
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    t = tracker
    s = live_stream(tracker)
    s.begin(pose0)
    for _ in range(compiled.WARMUP_CALLS + 1):
        s.push(rgb, depth)
    drain(s)
    p0 = torch.as_tensor(pose0).to(t.device)
    sync(t.device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(COMPILED_SYNC_PUSHES):
            s.push(rgb, depth)
        trk.track_video(t.model, t.cfg, t.mesh, t.K, t.mean, t.std, p0,
                        rgb_t, depth_t)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    s.close()
    replays = sum(p.replays for p in s._programs.programs())
    print(f"compiled: {COMPILED_SYNC_PUSHES} replayed pushes ({replays} "
          f"replays in the stream) and a replayed track_video over "
          f"{rgb_t.shape[0]} frames under sync debug mode 'error': none "
          "raised", flush=True)


def run_compiled(net, tracker, pose0, rgb, depth, card):
    """Phase 15, the compiled step on the production configuration (phase
    4's tracker, float32 and bf16): the module's programs captured anew;
    ``track_video`` over COMPILED_FRAMES frames twice (the first warms up,
    captures and replays, the second only replays) bit-equal to the eager
    loop; ``on_track`` over COMPILED_ON_TRACK frames after its warm-up and
    a windowed stream over COMPILED_FRAMES pushes, both bit-equal to the
    eager step; exactly one K1 and one ``pass2_shade`` launch a frame,
    replayed or not; no synchronizing call in the replays; then eager and
    replayed rates in turns, the capture time of each key and the device's
    busy share in a profiler window. Returns the launches by path."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.tracking import compiled
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    dev, n = tracker.device, COMPILED_FRAMES
    rgbs, depths = np.stack([rgb] * n), np.stack([depth] * n)
    rgb_t, depth_t = trk.upload_rgb(rgbs, dev), trk.upload_depth(depths, dev)
    p0 = torch.as_tensor(pose0).to(dev)
    compiled.programs.clear()
    trackers = {"float32": tracker,
                "bf16": make_tracker(net, dev, torch.bfloat16)}
    by_path, eager = {}, {}
    for name, t in trackers.items():
        parts = (t.model, t.cfg, t.mesh, t.K, t.mean, t.std)
        eager[name] = eager_video(t, p0, rgb_t, depth_t).cpu().numpy()
        for run in ("first", "replayed"):
            sync(dev)
            zero_launches()
            got = trk.track_video(*parts, p0, rgb_t, depth_t).cpu().numpy()
            launches = read_launches()
            prog = compiled.programs.programs()[-1]
            n_diff = int((got != eager[name]).sum())
            print(f"compiled track_video {name}, {run} run of {n} frames: "
                  f"pose entries different from the eager loop {n_diff}, "
                  f"launches {launches}; program: {program_line(prog)}",
                  flush=True)
            if n_diff or launches != k_launches(n, 0, n):
                raise AssertionError(f"compiled track_video {name} ({run}) "
                                     "is not the eager loop's bits, or its "
                                     "launches are wrong")
            by_path[f"compiled track_video {name} {run}"] = launches
        if prog.graph is None or prog.replays != 2 * n - \
                compiled.WARMUP_CALLS or replay_launches(prog) != {
                    "render_setup": 1, "pass1_winners": 1, "pass2_shade": 1}:
            raise AssertionError(f"the {name} video program did not replay "
                                 f"as it should: {program_line(prog)}")

    # 15.2: on_track, from a fresh tracker on the phase-4 parts
    m = compiled.WARMUP_CALLS + 1 + COMPILED_ON_TRACK
    t_on, pose, want, got = serving_tracker(tracker), pose0, [], []
    for _ in range(m):
        pose = eager_on_track(tracker, pose, rgb, depth)
        want.append(pose)
    pose = pose0
    sync(dev)
    zero_launches()
    for _ in range(m):
        pose = t_on.on_track(pose, rgb, depth)
        got.append(pose)
    launches = read_launches()
    prog = compiled.programs.programs()[-1]
    n_diff = int((np.stack(got) != np.stack(want)).sum())
    print(f"compiled on_track: {m} frames ({compiled.WARMUP_CALLS} eager, "
          f"the capture, {COMPILED_ON_TRACK} replays after it): pose entries "
          f"different from the eager step {n_diff}, launches {launches}; "
          f"program: {program_line(prog)}", flush=True)
    if n_diff or launches != k_launches(m, 0, m) or \
            prog.replays != m - compiled.WARMUP_CALLS:
        raise AssertionError("compiled on_track is not the eager step's bits")
    by_path["compiled on_track"] = launches

    # 15.3: the windowed stream, against the eager loop over full frames
    s = live_stream(tracker)
    s.begin(pose0)
    sync(dev)
    zero_launches()
    for _ in range(n):
        s.push(rgb, depth)
    got = s.poses()
    launches = read_launches()
    s.close()
    stats = s.stats()
    n_diff = int((got != eager["float32"]).sum())
    print(f"compiled stream: {n} windowed pushes, pose entries different "
          f"from the eager loop {n_diff}, launches {launches}, stats "
          f"{stats}; programs: "
          + "; ".join(program_line(p) for p in s._programs.programs()),
          flush=True)
    progs = s._programs.programs()
    if n_diff or launches != k_launches(n, 0, n) or \
            stats["compiled_programs"] != len(progs) or \
            sum(p.eager_calls + p.replays for p in progs) != n or \
            not any(p.graph is not None for p in progs):
        raise AssertionError("the compiled stream is not the eager bits")
    by_path["compiled stream"] = launches

    check_replays_sync_free(tracker, pose0, rgb, depth, rgb_t, depth_t)
    time_compiled(tracker, trackers["bf16"], pose0, rgb, depth, rgb_t,
                  depth_t, card)
    for p in compiled.programs.programs():
        print(f"compiled program: {program_line(p)} {card}", flush=True)
    return by_path


def time_compiled(tracker, t16, pose0, rgb, depth, rgb_t, depth_t, card):
    """Phase 15.5: eager and replayed in turns (eager, replayed, replayed,
    eager), host clock around work that ends with the poses on the host:
    ``track_video`` float32 and bf16 over the phase's frames, ``on_track``
    over COMPILED_ON_TRACK frames (and its host ms a call), windowed
    stream pushes (host ms a push, from the pushes alone); then the
    device's busy share over COMPILED_PROFILE_FRAMES frames of each."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.tracking import compiled
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    dev, n = tracker.device, rgb_t.shape[0]
    p0 = torch.as_tensor(pose0).to(dev)
    t_on = serving_tracker(tracker)
    s_rep, s_eag = live_stream(tracker), live_stream(tracker)
    s_eag._programs = EagerPrograms()
    for st in (s_rep, s_eag):  # warm: each side's program captured
        st.begin(pose0)
        for _ in range(compiled.WARMUP_CALLS + 2):
            st.push(rgb, depth)
        st.current_pose()

    def video(t, compiled_):
        def run():
            if compiled_:
                return trk.track_video(t.model, t.cfg, t.mesh, t.K, t.mean,
                                       t.std, p0, rgb_t, depth_t)
            return eager_video(t, p0, rgb_t, depth_t)
        return run, n

    def on_track(compiled_):
        def run():
            pose = pose0
            for _ in range(COMPILED_ON_TRACK):
                pose = (t_on.on_track(pose, rgb, depth) if compiled_ else
                        eager_on_track(tracker, pose, rgb, depth))
            return pose
        return run, COMPILED_ON_TRACK

    def stream(s):
        def run():
            s.begin(pose0)
            t0 = time.perf_counter()
            for _ in range(n):
                s.push(rgb, depth)
            push_ms.setdefault(id(s), []).append(
                (time.perf_counter() - t0) * 1e3 / n)
            return s.current_pose()
        return run, n

    push_ms = {}
    runs = {"track_video float32": (video(tracker, False),
                                    video(tracker, True)),
            "track_video bf16": (video(t16, False), video(t16, True)),
            "on_track": (on_track(False), on_track(True)),
            "stream push": (stream(s_eag), stream(s_rep))}
    for what, (eag, rep) in runs.items():
        hz = {"eager": [], "replayed": []}
        for which in ("eager", "replayed", "replayed", "eager"):
            fn, frames = eag if which == "eager" else rep
            sync(dev)
            t0 = time.perf_counter()
            out = fn()
            if torch.is_tensor(out):
                out.cpu()
            hz[which].append(frames / (time.perf_counter() - t0))
        extra = ""
        if what == "stream push":
            extra = (f"; host ms a push eager "
                     f"{[round(v, 4) for v in push_ms[id(s_eag)]]}, "
                     f"replayed {[round(v, 4) for v in push_ms[id(s_rep)]]}")
        elif what == "on_track":
            extra = (f"; host ms a call eager "
                     f"{[round(1e3 / h, 4) for h in hz['eager']]}, replayed "
                     f"{[round(1e3 / h, 4) for h in hz['replayed']]}")
        print(f"timing compiled {what} in turns (eager, replayed, replayed, "
              f"eager): eager {[round(h, 2) for h in hz['eager']]} Hz, "
              f"replayed {[round(h, 2) for h in hz['replayed']]} Hz{extra} "
              f"{card}", flush=True)
    k = COMPILED_PROFILE_FRAMES
    windows = {
        "eager track_video": lambda: eager_video(tracker, p0, rgb_t[:k],
                                                 depth_t[:k]),
        "replayed track_video": lambda: trk.track_video(
            tracker.model, tracker.cfg, tracker.mesh, tracker.K, tracker.mean,
            tracker.std, p0, rgb_t[:k], depth_t[:k]),
        "replayed stream": lambda: ([s_rep.push(rgb, depth)
                                     for _ in range(k)],
                                    s_rep.current_pose())}
    for what, fn in windows.items():
        prof = profile_share(fn)
        if prof is None:
            print(f"profile: compiled {what}: torch.profiler recorded no "
                  "device time; busy share not measured", flush=True)
            continue
        busy_us, wall_us, n_ops, rows = prof
        print(f"profile: compiled {what} over {k} frames: device busy "
              f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
              f"({100 * busy_us / wall_us:.1f}%), {n_ops / k:.0f} device "
              f"operations a frame {card}", flush=True)
        for key, us, count in rows[:4]:
            print(f"profile:   {us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")
    s_rep.close()
    s_eag.close()


def setup_cases(tracker, pose0):
    """Phase 16's render set-up inputs on the tracker's card, each a dict
    of render's arguments (mesh, pose, K, window, hw, cull): the tracking
    step's culled ROI view of the production mesh (and unculled), its
    SETUP_HYPOTHESES culled hypotheses, the sampler's unculled views of one
    train batch (A then B views in A's windows), the textured box culled,
    SETUP_STACKED stacked icospheres culled (one mesh a view), a full frame
    of the production mesh unculled with the window as four numbers, and a
    pose whose corners straddle the near plane, culled."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.core import se3
    from iros20_6d_pose_tracking_tpu_torch.data import dataset as DS
    from iros20_6d_pose_tracking_tpu_torch.ops import roi
    from iros20_6d_pose_tracking_tpu_torch.parallel import spmd
    from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    dev, K = tracker.device, tracker.K
    width = tracker.cfg.object_width_mm

    def roi_window(poses, w=width):
        return rz.window_from_bbox(roi.compute_bbox(
            poses, K, w, (1000.0, 1000.0, 1000.0)))

    def case(mesh, pose, cull, window=None, hw=(RES, RES)):
        return {"mesh": mesh, "pose": pose, "K": K, "cull": cull, "hw": hw,
                "near": tracker.cfg.near,
                "window": roi_window(pose) if window is None else window}

    p0 = torch.as_tensor(pose0).to(dev)
    hyp = serve_poses(pose0, SETUP_HYPOTHESES, SEED + 16)[0].to(dev)
    d = DS.draw_synth(torch.Generator().manual_seed(SEED + 3), TRAIN_BATCH,
                      RES, None, dev)
    A, B = DS.sample_poses(d, TRAIN_XYZ, 0.02, 15.0)
    box = M.make_textured_box()
    box_pose = se3.make_pose(se3.so3_exp(torch.tensor([0.5, 0.3, -0.2])),
                             torch.tensor([0.01, -0.01, 0.55])).to(dev)
    spheres = [M.make_icosphere(subdiv=3, radius=r)
               for r in (0.04, 0.05, 0.06, 0.07)][:SETUP_STACKED]
    st_poses = serve_poses(pose0, SETUP_STACKED, SEED + 17)[0].to(dev)
    near_pose = p0.clone()
    near_pose[2, 3] = 0.12  # radius 0.05 m: corners from 0.07 to 0.17 m
    return {
        "tracking ROI culled": case(tracker.mesh, p0, True),
        "tracking ROI unculled": case(tracker.mesh, p0, False),
        f"{SETUP_HYPOTHESES} hypotheses culled": case(tracker.mesh, hyp,
                                                      True),
        f"{2 * TRAIN_BATCH} sampler views unculled": case(
            tracker.mesh, torch.cat([A, B]), False,
            torch.cat([roi_window(A)] * 2)),
        "textured box culled": case(
            rz.upload(box, dev), box_pose, True,
            roi_window(box_pose, box.diameter * 1000 * 1.1)),
        f"{SETUP_STACKED} stacked icospheres culled": case(
            spmd.stack_meshes(spheres, dev), st_poses, True,
            roi_window(st_poses, 0.14 * 1000 * 1.1)),
        "full frame unculled, window as numbers": case(
            tracker.mesh, p0, False, rz.full_frame_window(*FRAME_HW[::-1]),
            FRAME_HW),
        "near plane crossing culled": case(tracker.mesh, near_pose, True),
    }


def ordered_ints(x):
    """float32 tensor -> int64 in the floats' order (the ulp distance of
    two floats is the difference of theirs)."""
    import torch

    b = x.contiguous().view(torch.int32)
    return torch.where(b >= 0, b, b ^ 0x7FFFFFFF).to(torch.int64)


def setup_call(case, plain=False):
    """``render_setup`` (or its plain version) on one case."""
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk

    fn = rk.render_setup_ref if plain else rk.render_setup
    return fn(case["mesh"], case["pose"], case["K"], case["window"],
              case["hw"], case["near"], case["cull"])


def check_render_setup(name, case):
    """``render_setup`` against ``render_setup_ref`` on the card: one
    launch; the same face block and shapes; per table (coef, block_bbox,
    attr) the entries whose bits differ and the largest gap in ulps; and
    the rows (faces) of coef and attr farther apart than ROW_FAR of the
    row's largest entry, which would be another face at that rank. Raises
    on a far row, a differing bit or a launch count off. Returns {table:
    (differing, max ulp)}."""
    import torch

    n0 = launches_of("render_setup")
    coef, bbox, fb, attr = setup_call(case)
    if launches_of("render_setup") != n0 + 1:
        raise AssertionError(f"render_setup {name}: not one launch")
    r_coef, r_bbox, r_fb, r_attr = setup_call(case, plain=True)
    if fb != r_fb or [t.shape for t in (coef, bbox, attr)] != \
            [t.shape for t in (r_coef, r_bbox, r_attr)]:
        raise AssertionError(f"render_setup {name}: face block or shapes "
                             "differ from the plain version's")
    gaps = {}
    for table, a, b in (("coef", coef, r_coef), ("block_bbox", bbox, r_bbox),
                        ("attr", attr, r_attr)):
        d = (ordered_ints(a) - ordered_ints(b)).abs()
        both_nan = torch.isnan(a) & torch.isnan(b)
        d = torch.where(both_nan, 0, d)
        gaps[table] = (int((d > 0).sum()), int(d.max()) if d.numel() else 0)
    far = 0
    for a, b in ((coef.transpose(-1, -2), r_coef.transpose(-1, -2)),
                 (attr, r_attr)):
        scale = b.abs().nan_to_num(0.0).amax(-1).clamp(min=1e-30)
        diff = (a - b).abs().nan_to_num(0.0).amax(-1)
        far += int((diff > ROW_FAR * scale).sum())
    views = coef.shape[0] if coef.dim() == 3 else 1
    print(f"render_setup {name}: views={views} F={coef.shape[-1]} fb={fb} "
          f"C={attr.shape[-1]} hw={case['hw']} cull={case['cull']}: "
          + ", ".join(f"{t} {n} entries differ (max {u} ulp)"
                      for t, (n, u) in gaps.items())
          + f"; rows farther than {ROW_FAR:g} of their scale: {far}",
          flush=True)
    if far:
        raise AssertionError(f"render_setup {name}: rows of another face "
                             "(compaction order or poisoning differs)")
    if any(n for n, _ in gaps.values()):
        raise AssertionError(f"render_setup {name}: tables not bit-equal to "
                             "the plain version's")
    return gaps


def setup_agreement(tracker, pose0, n=SETUP_AGREEMENT_POSES):
    """K1's winners through ``render_setup`` and through its plain version
    on the culled tracking ROI of ``n`` poses drawn around ``pose0``
    (``serve_poses``): pixels whose winner or iz differ, which must be none.
    Returns (pixels differing, pixels)."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.ops import roi
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    diff = 0
    for p in serve_poses(pose0, n, SEED + 18)[0].to(tracker.device):
        c = {"mesh": tracker.mesh, "pose": p, "K": tracker.K, "cull": True,
             "hw": (RES, RES), "near": tracker.cfg.near,
             "window": rz.window_from_bbox(roi.compute_bbox(
                 p, tracker.K, tracker.cfg.object_width_mm,
                 (1000.0, 1000.0, 1000.0)))}
        outs = []
        for plain in (False, True):
            coef, bbox, fb, _ = setup_call(c, plain)
            outs.append(rk.pass1_winners(coef, bbox, c["hw"], fb))
        (iz, win), (iz_r, win_r) = outs
        diff += int(((win != win_r)
                     | (iz.view(torch.int32) != iz_r.view(torch.int32)))
                    .sum())
    total = n * RES * RES
    print(f"render_setup: K1 through the kernel and through its plain "
          f"version over {n} culled ROI poses: {diff} of {total} pixels "
          f"differ in winner or iz", flush=True)
    if diff:
        raise AssertionError("K1 differs through render_setup")
    return diff, total


def run_setup_paths(tracker, pose0, rgb, depth):
    """Phase 16.3: the render paths launch ``render_setup`` once a render
    call. Over each path (``track_video`` over SETUP_FRAMES frames, its
    warm-up, capture and replays; ``on_track`` over SETUP_FRAMES frames; one
    eager ``track_step``; the samples-4 step; one ``render_pairs`` batch;
    ``render_at_bbox``; a full-frame render through K3) the set-up's
    launches equal the pass-1 launches (K1 and K3), one of each a render.
    Returns the launches by path."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.data import dataset as DS
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    dev, K, n = tracker.device, tracker.K, SETUP_FRAMES
    p0 = torch.as_tensor(pose0).to(dev)
    rgb_t, depth_t = trk.upload_rgb(rgb, dev), trk.upload_depth(depth, dev)
    d = DS.draw_synth(torch.Generator().manual_seed(SEED + 19), 4, RES, None,
                      dev)
    A, B = DS.sample_poses(d, TRAIN_XYZ, 0.02, 15.0)

    def on_track(t, samples=1):
        pose = pose0
        for _ in range(n):
            pose = t.on_track(pose, rgb, depth, samples=samples)

    paths = {
        "track_video": lambda: tracker.track_video(
            pose0, np.stack([rgb] * n), np.stack([depth] * n)),
        "on_track": lambda: on_track(serving_tracker(tracker)),
        "on_track samples=4": lambda: on_track(serving_tracker(tracker), 4),
        "track_step eager": lambda: trk.track_step(
            tracker.model, tracker.cfg, tracker.mesh, K, tracker.mean,
            tracker.std, p0, rgb_t, depth_t),
        "render_pairs": lambda: DS.render_pairs(
            tracker.mesh, K, A, B, RES, tracker.cfg.object_width_mm),
        "render_at_bbox": lambda: rz.render_at_bbox(
            tracker.mesh, p0, K, tracker.cfg.object_width_mm, (RES, RES),
            cull_backfaces=True),
        "full frame through K3": lambda: rz.render(
            tracker.mesh, p0, K, rz.full_frame_window(*FRAME_HW[::-1]),
            FRAME_HW, worklist=True),
    }
    out = {}
    for name, fn in paths.items():
        zero_launches()
        n0 = launches_of("render_setup")
        fn()
        sync(dev)
        got = dict(read_launches(),
                   render_setup=launches_of("render_setup") - n0)
        renders = got["raster_pass1"] + got["raster_pass1_worklist"]
        print(f"render_setup launches, {name}: {got['render_setup']} for "
              f"{renders} renders (K1 {got['raster_pass1']}, K3 "
              f"{got['raster_pass1_worklist']})", flush=True)
        if got["render_setup"] != renders or not renders:
            raise AssertionError(f"render_setup is not one launch a render "
                                 f"({name})")
        out[name] = got
    return out


def setup_step_ops(tracker, pose0, rgb, depth):
    """Device operations of one eager tracking step (the profiler's count)
    with the render set-up through ``render_setup`` and through its plain
    version on the card. Returns (ops with the kernel, ops with the plain
    set-up), None for a window the profiler recorded nothing in."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    dev = tracker.device
    p0 = torch.as_tensor(pose0).to(dev)
    rgb_t, depth_t = trk.upload_rgb(rgb, dev), trk.upload_depth(depth, dev)

    def step():
        trk.track_step(tracker.model, tracker.cfg, tracker.mesh, tracker.K,
                       tracker.mean, tracker.std, p0, rgb_t, depth_t)

    kernel = rk.render_setup
    counts = []
    for fn in (kernel, rk.render_setup_ref):
        rk.render_setup = fn
        try:
            step()
            prof = profile_share(step)
        finally:
            rk.render_setup = kernel
        counts.append(None if prof is None else prof[2])
    print(f"render_setup: device operations of one eager tracking step: "
          f"{counts[0]} with the kernel, {counts[1]} with the plain set-up",
          flush=True)
    return tuple(counts)


def setup_bound(case, out):
    """render_setup's bound on one case: the mesh read once (shared by the
    views, or one a view when stacked), the pose, window and K, and the
    tables written once; SETUP_OPS_PER_FACE a face and view."""
    mesh = case["mesh"]
    n_bytes = nbytes(*[f for f in (mesh.fverts, mesh.fnormals, mesh.fcolors,
                                   mesh.fmask, mesh.fuvs) if f is not None],
                     case["pose"], case["K"], *out[:2], out[3])
    if hasattr(case["window"], "numel"):
        n_bytes += nbytes(case["window"])
    views_faces = out[3].shape[:-1].numel()
    return bound(n_bytes, SETUP_OPS_PER_FACE * views_faces)


def time_render_setup(cases, card):
    """Phase 16.4: ``render_setup`` timed as the other kernels (``run_ms``,
    its profiler device time, the plain version, the bound) on the cases
    of the kernel table. Returns {case: kernels-line numbers}."""
    rows = {}
    for name in ("tracking ROI culled",
                 f"{SETUP_HYPOTHESES} hypotheses culled",
                 f"{2 * TRAIN_BATCH} sampler views unculled",
                 "textured box culled",
                 f"{SETUP_STACKED} stacked icospheres culled"):
        c = cases[name]
        rows[name] = report_kernel(
            "render_setup", f"({name})", lambda c=c: setup_call(c),
            lambda c=c: setup_call(c, plain=True),
            setup_bound(c, setup_call(c)), card,
            runs=10 if c["pose"].dim() == 3 and c["pose"].shape[0] > 100
            else TIMING_RUNS)
    return rows


def run_render_setup(tracker, pose0, rgb, depth, card):
    """Phase 16, the render set-up kernel: ``render_setup`` against its
    plain version on every case of ``setup_cases``, K1's winners through
    both over SETUP_AGREEMENT_POSES poses, one launch a render on every
    render path, a tracking step's device operations with and without it,
    and its times. Returns its kernels-line entry."""
    cases = setup_cases(tracker, pose0)
    gaps = {name: check_render_setup(name, c) for name, c in cases.items()}
    agree = setup_agreement(tracker, pose0)
    by_path = run_setup_paths(tracker, pose0, rgb, depth)
    ops = setup_step_ops(tracker, pose0, rgb, depth)
    rows = time_render_setup(cases, card)
    prod = rows["tracking ROI culled"]
    return {"name": "render_setup", "route": "cuda",
            "source": f"{PORT}/csrc/render_setup.cu",
            "replaces": None, "launches": by_path["track_video"][
                "render_setup"],
            "max_ulp": {name: {t: g[1] for t, g in tables.items()}
                        for name, tables in gaps.items()},
            "k1_pixels_differing": list(agree), "step_device_ops": list(ops),
            **{k: prod[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
            "launches_by_path": {p: c["render_setup"]
                                 for p, c in by_path.items()},
            "shapes": {name: {k: r[k] for k in ("ms", "device_ms",
                                                "plain_ms", "bound_ms")}
                       for name, r in rows.items()}}


# Phase 17: FoundationPose's refiner (models/refinenet.py) through the
# compiled step.
def refiner_net(seed):
    """The refiner at its published widths with seeded random weights,
    BatchNorm statistics randomised and the two Linear(512, 3) heads scaled
    by REFINER_HEAD_SCALE (the benchmark's: at HEAD_SCALE a random refiner
    runs ~5 mm a frame off the object), on the CPU in eval mode."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.models import refinenet

    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = refinenet.RefineNet()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
        for head in (net.trans_head[1], net.rot_head[1]):
            head.weight.mul_(REFINER_HEAD_SCALE)
            head.bias.zero_()
    return net.eval()


def refiner_tracker(net, device, dtype):
    """The refiner's tracker on ``device``: the production mesh, a 160^2
    ROI of 1.2 x its diameter (the published crop_ratio)."""
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    tm, cull = production_mesh()
    cfg = trk.TrackerConfig(
        resolution=REFINER_RES, cull_backfaces=cull, dtype=dtype,
        object_width_mm=float(tm.diameter) * 1000 * net.crop_ratio)
    return trk.Tracker.from_parts(
        copy.deepcopy(net).to(device), cfg, rz.upload(tm, device), K_PROD,
        np.zeros(8, np.float32), np.ones(8, np.float32), dtype=dtype)


def refiner_frames(tracker, n):
    """n 480x640 frames of the production mesh rendered on the card, the
    object 0.6 m away moving 0.4 mm and 0.3 degrees a frame: (poses, rgb
    uint8, depth int32 mm) on the card."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.core import se3
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    dev = tracker.device
    k = torch.arange(n, dtype=torch.float32, device=dev)[:, None]
    t = torch.tensor([0.0, 0.0, 0.6], device=dev) + k * torch.tensor(
        [4e-4, -2e-4, 1e-4], device=dev)
    w = k * torch.tensor([0.004, 0.003, -0.002], device=dev)
    poses = se3.make_pose(se3.so3_exp(w), t)
    rgb, depth = rz.render(tracker.mesh, poses, tracker.K,
                           torch.tensor(rz.full_frame_window(*FRAME_HW[::-1]),
                                        device=dev).expand(n, 4),
                           out_hw=FRAME_HW, cull_backfaces=True)
    return poses, rgb.round().to(torch.uint8), depth.round().to(torch.int32)


def refiner_gaps(a, b, radius):
    """(translation over radius, rotation angle over 20 degrees) of each
    pose pair, the larger of the two, as numpy."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.models import refinenet

    a, b = a.double().cpu(), b.double().cpu()
    dt = (a[:, :3, 3] - b[:, :3, 3]).norm(dim=1) / radius
    m = a[:, :3, :3] @ b[:, :3, :3].transpose(1, 2)
    vee = torch.stack([m[:, 2, 1] - m[:, 1, 2], m[:, 0, 2] - m[:, 2, 0],
                       m[:, 1, 0] - m[:, 0, 1]], 1)
    ang = torch.asin((vee.norm(dim=1) / 2).clamp(max=1.0))
    return torch.maximum(dt, ang / refinenet.ROT_NORMALIZER).numpy()


def run_refiner(card):
    """FoundationPose's refiner on the card, float32 and bf16: the replayed
    ``track_video`` over REFINER_FRAMES frames (one capture of a graph that
    holds both rounds, each replay adding 2 rounds and 1600 attention
    tokens) bit-equal to the eager two-round step, held to the CPU path
    from the card's own priors, and the card's network against the plain
    reference (``models/refinenet_reference.py``); the replayed rate."""
    import torch

    from iros20_6d_pose_tracking_tpu_torch.models import refinenet_reference
    from iros20_6d_pose_tracking_tpu_torch.tracking import compiled
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
    from iros20_6d_pose_tracking_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    net = refiner_net(SEED + 17)
    cpu = refiner_tracker(net, torch.device("cpu"), torch.float32)
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        t = refiner_tracker(net, dev, dtype)
        gt, rgb, depth = refiner_frames(t, REFINER_FRAMES)
        radius = t.model.radius_m(t.cfg.object_width_mm)
        init = gt[0] @ torch.tensor(
            [[1, 0, 0, 0.003], [0, 1, 0, -0.002], [0, 0, 1, 0.004],
             [0, 0, 0, 1.0]], device=dev)
        compiled.programs.clear()
        before = profiling.counters()
        poses = trk.track_video(t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
                                init, rgb, depth)
        torch.cuda.synchronize()
        after = profiling.counters()
        (prog,) = compiled.programs.programs()
        assert prog.graph is not None and \
            after["compiled.captures"] - before["compiled.captures"] == 1
        held = {"weights.bf16_held": 100} if dtype == torch.bfloat16 \
            else {}
        # 15 convolutions a round read held copies in their input's layout
        assert prog.replay_counts == {"weights.layout_held": 30,
                                      "refine.rounds": 2,
                                      "refine.attn_tokens": 1600,
                                      "launches.render_setup": 2,
                                      "launches.pass1_winners": 2,
                                      "launches.pass2_shade": 2,
                                      **held}, prog.replay_counts
        assert after["refine.rounds"] - before["refine.rounds"] == \
            2 * REFINER_FRAMES
        eager = eager_video(t, init, rgb, depth)
        same = bool(torch.equal(eager, poses))
        assert same, "replayed refiner poses differ from the eager step's"
        # the CPU path, float32, from the card's own priors
        priors = torch.cat([init[None], poses[:-1]])
        idx = np.linspace(0, REFINER_FRAMES - 1, REFINER_CPU_FRAMES).astype(
            int)
        ref = torch.stack([trk.track_step(
            cpu.model, cpu.cfg, cpu.mesh, cpu.K, cpu.mean, cpu.std,
            priors[i].cpu(), rgb[i].cpu(), depth[i].cpu())[0] for i in idx])
        step_gap = float(refiner_gaps(poses[idx], ref, radius).max())
        # the network on one frame's inputs against its plain reference
        v = trk.roi_geometry(t.cfg, t.mesh, t.K, init, rgb[0], depth[0])
        A, B = t.model.build_pair(v, init, t.K, t.mean, t.std,
                                  t.cfg.object_width_mm)
        with torch.no_grad():
            out = t.model(A, B)
        want = refinenet_reference.forward(
            {k: x.float() for k, x in t.model.state_dict().items()}, A, B)
        net_gap = max(float((out[k] - want[k]).abs().max())
                      for k in ("trans", "rot"))
        drift = float((poses[-1, :3, 3] - gt[-1, :3, 3]).norm()) * 1e3
        print(f"refiner {name}: replayed track_video over {REFINER_FRAMES} "
              f"frames at {REFINER_RES}^2 bit-equal to the eager 2-round "
              f"step ({same}), 1 capture, 2 rounds and 1600 attention "
              f"tokens a replay; step against the CPU path over "
              f"{REFINER_CPU_FRAMES} frames {step_gap:.3e} (bar "
              f"{REFINER_STEP_BAR[name]:g}), network against its reference "
              f"{net_gap:.3e} (bar {REFINER_NET_BAR[name]:g}); last frame "
              f"{drift:.2f} mm from the rendered pose", flush=True)
        assert step_gap < REFINER_STEP_BAR[name], step_gap
        assert net_gap < REFINER_NET_BAR[name], net_gap
        hz = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trk.track_video(t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
                            init, rgb, depth)
            torch.cuda.synchronize()
            hz.append(REFINER_FRAMES / (time.perf_counter() - t0))
        print(f"refiner {name}: replayed track_video "
              f"{', '.join(f'{h:.1f}' for h in hz)} Hz (2 rounds a frame) "
              f"{card}", flush=True)
        compiled.programs.clear()


def main() -> int:
    t_main = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1

    from iros20_6d_pose_tracking_tpu_torch.core import se3
    from iros20_6d_pose_tracking_tpu_torch.kernels import build as kbuild
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()
    print(smi)
    card = f"[{smi}]"
    dev = torch.device("cuda", 0)
    se3.pin_full_fp32()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}, python {sys.version.split()[0]}")
    print(f"TF32 off: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is still on")

    # 2. Build the kernels from the sources in the checkout: one nvcc per
    # source, all started together.
    def timed_build(name):
        t0 = time.perf_counter()
        path, log = kbuild.build(name)
        return path, log, time.perf_counter() - t0

    t0 = time.perf_counter()
    sources = (*REPLACES, "render_setup")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        builds = dict(zip(sources, pool.map(timed_build, sources)))
    for name, (path, log, secs) in builds.items():
        kbuild.load(name)
        print(f"built csrc/{name}.cu in {secs:.2f} s -> {path}")
        for line in log.splitlines():
            if "registers" in line or "bytes stack" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"all kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
    if "--refiner" in sys.argv[1:]:
        run_refiner(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 3. Each kernel against its plain version, on the card.
    net = build_model(SEED)
    tracker = make_tracker(net, dev)
    pose0, rgb, depth = production_frames()
    errs, prod = check_kernels(tracker, pose0)
    errs["raster_pass1_worklist"], e3, ff_cases = check_worklist_cases(
        tracker, pose0)
    errs["pass2_shade"] = max(errs["pass2_shade"], e3)
    e1, e2, e3, batched_case = check_batched_kernels(tracker)
    errs["raster_pass1"] = max(errs["raster_pass1"], e1)
    errs["gather_rows"] = max(errs["gather_rows"], e2)
    errs["pass2_shade"] = max(errs["pass2_shade"], e3)

    # 4. The slice through the entry points a user calls.
    print(f"slice: Se3TrackNet full width at {RES}^2, "
          f"{int(tracker.mesh.fmask.sum())} faces (padded "
          f"{tracker.mesh.fmask.shape[0]}), cull={tracker.cfg.cull_backfaces}"
          f", heads x{HEAD_SCALE}, {FRAME_HW[0]}x{FRAME_HW[1]} uint8 RGB + "
          f"uint16 depth frames", flush=True)
    n_on, n_video = 50, 100
    launches, on_poses, video, on_s, video_s = run_slice(
        tracker, pose0, rgb, depth, n_on, n_video)
    print(f"launches in the main path ({n_on} on_track + {n_video} "
          f"track_video frames): {launches}", flush=True)
    # ROI renders keep K1; pass 2 runs fused, the K2 row gather not at all.
    want = {"raster_pass1": n_on + n_video, "gather_rows": 0,
            "raster_pass1_worklist": 0, "pass2_shade": n_on + n_video}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    by_path = {"tracking (on_track + track_video)": dict(launches)}
    check_on_object({"on_track": on_poses, "track_video": video}, pose0,
                    tracker.cfg.object_width_mm)
    compare_with_cpu(net, tracker, pose0, rgb, depth, 20)

    # 5. The evaluation path, then the card against the plain CPU path.
    from iros20_6d_pose_tracking_tpu_torch.eval import synthetic_benchmark as SB

    tm, _ = production_mesh()
    obj = make_bench_object(tracker, tm)
    gt = SB.make_gt_trajectory(EVAL_FRAMES)
    print(f"evaluation path: make_gt_trajectory({EVAL_FRAMES}), "
          f"render_test_video hard at {FRAME_HW[0]}x{FRAME_HW[1]}, "
          f"_quantize, evaluate_tracking", flush=True)
    eval_launches, frames, result, render_s, eval_s = run_eval(obj, gt)
    print(f"evaluation path times (first call): render_test_video + "
          f"_quantize {render_s:.3f} s, evaluate_tracking {eval_s:.3f} s")
    check_eval(eval_launches, result, EVAL_FRAMES)
    by_path["evaluation"] = eval_launches
    launches["raster_pass1_worklist"] = eval_launches["raster_pass1_worklist"]
    compare_eval_with_cpu(
        make_bench_object(make_tracker(net, torch.device("cpu")), tm), gt,
        frames, result)

    # 6. Timings: the kernels on the production inputs beside their plain
    # versions, bounds and (K2) library call, then the step and the rates.
    cull = tracker.cfg.cull_backfaces
    c = prod[cull]
    label = f"(production inputs, cull={cull})"
    report = {
        "raster_pass1": report_kernel(
            "raster_pass1", label,
            lambda: rk.pass1_winners(c["coef"], c["bbox"], (RES, RES),
                                     c["fb"]),
            lambda: rk.pass1_winners_ref(c["coef"], c["bbox"], (RES, RES),
                                         c["fb"]),
            pass1_bound(c, (RES, RES)), card),
        "pass2_shade": report_kernel(
            "pass2_shade", label,
            lambda: rk.pass2_shade(c["attr"], c["iz"], c["win"], c["R"],
                                   c["t"], (RES, RES), FAR),
            lambda: rk.pass2_shade_ref(c["attr"], c["iz"], c["win"], c["R"],
                                       c["t"], (RES, RES), FAR),
            pass2_bound(c), card),
        "gather_rows": report_kernel(
            "gather_rows", label,
            lambda: rk.gather_rows(c["attr"], c["winner"], c["covered"]),
            lambda: rk.gather_rows_ref(c["attr"], c["winner"], c["covered"]),
            bound(nbytes(c["winner"], c["covered"])
                  + winner_rows_bytes(c["attr"], c["winner"], c["covered"])
                  + c["winner"].numel() * c["attr"].shape[1] * 4, 0), card,
            library_fn=lambda: torch.index_select(c["attr"], 0,
                                                  c["winner"])),
    }
    nc = prod[False]
    report_kernel("raster_pass1", "(production inputs, cull=False)",
                  lambda: rk.pass1_winners(nc["coef"], nc["bbox"], (RES, RES),
                                           nc["fb"]),
                  lambda: rk.pass1_winners_ref(nc["coef"], nc["bbox"],
                                               (RES, RES), nc["fb"]),
                  pass1_bound(nc, (RES, RES)), card)
    for name, fn in step_parts(tracker, pose0, rgb, depth, c).items():
        print(f"timing step part {name}: {cuda_ms(fn):.4f} ms (median of "
              f"{TIMING_RUNS}) {card}")
    n_prof = 20
    prof = profile_share(lambda: tracker.track_video(
        pose0, np.stack([rgb] * n_prof), np.stack([depth] * n_prof)))
    if prof is None:
        print("profile: torch.profiler recorded no device time; device busy "
              "share not measured")
    else:
        busy_us, wall_us, n_ops, rows = prof
        print(f"profile: Tracker.track_video over {n_prof} frames: device "
              f"busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
              f"({100 * busy_us / wall_us:.1f}%), {n_ops} device operations"
              f" {card}")
        for key, us, count in rows:
            print(f"profile:   {us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")
    print(f"timing on_track: {n_on / on_s:.2f} Hz ({n_on} frames, pose "
          f"fetched to the host every frame) {card}")
    print(f"timing track_video: {n_video / video_s:.2f} Hz ({n_video} "
          f"frames, poses fetched at the end) {card}", flush=True)
    time_video_in_turns(tracker, pose0, rgb, depth, n_video, card)
    report["raster_pass1_worklist"] = time_eval(obj, gt, result["poses"],
                                                ff_cases, card)

    # 7. Synthetic training at full width, the card against the plain CPU
    # path, the trained tracker, and the training timings.
    tm_cube, synth, cfg = train_setup(dev)
    print(f"train: Se3TrackNet full width at {RES}^2, batch {cfg.batch_size}, "
          f"float32, 0.08 m cube with DRComposite(), {TRAIN_STEPS} "
          "train_step_synth steps", flush=True)
    train_case = sampler_views_case(synth.mesh, synth.object_width_mm,
                                    cfg.batch_size, dev, SEED + 3)
    e1, e2, e3 = check_sampler_views(
        f"train batch ({cfg.batch_size} pairs of the cube)", train_case)
    errs["raster_pass1"] = max(errs["raster_pass1"], e1)
    errs["gather_rows"] = max(errs["gather_rows"], e2)
    errs["pass2_shade"] = max(errs["pass2_shade"], e3)
    t0 = time.perf_counter()
    train_launches, model, opt, mean_t, std_t, losses, step_ms = run_train(
        synth, cfg, dev)
    train_s = time.perf_counter() - t0
    n_batches = MEAN_STD_BATCHES + TRAIN_STEPS
    want = {"raster_pass1": n_batches, "gather_rows": 0,
            "raster_pass1_worklist": 0, "pass2_shade": n_batches}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"train: losses {losses}; launches {train_launches} (want {want}, "
          f"one K1 and one pass2_shade launch per sampled batch); "
          f"{train_s:.3f} s; peak device memory so far {peak_gib:.2f} GiB",
          flush=True)
    if train_launches != want:
        raise AssertionError(f"training launch counts {train_launches} != "
                             f"{want}")
    by_path["training"] = train_launches
    if not np.isfinite(losses).all():
        raise AssertionError("training losses are not finite")
    compare_train_with_cpu(dev)
    track_trained(tm_cube, model, mean_t, std_t, dev)
    step_med = float(np.median(step_ms))
    print(f"timing train step (train_step_synth: sampler, augmentation, "
          f"forward, backward, Adam): {step_med:.4f} ms (median of "
          f"{TRAIN_STEPS}, all {np.round(step_ms, 2).tolist()}); train "
          f"{cfg.batch_size / step_med * 1e3:.2f} samples/s at batch "
          f"{cfg.batch_size}, {RES}^2, float32, TF32 off {card}", flush=True)
    time_train(synth, cfg, model, opt, mean_t, std_t,
               {"8 sampler views of the production mesh": batched_case,
                f"{2 * cfg.batch_size} sampler views of the cube (one train "
                "batch)": train_case}, card)

    # 8. The serving path: the culled N-view kernels against their plain
    # versions, multi-hypothesis and chunked tracking, the predict CLI, and
    # their timings.
    t8 = time.perf_counter()
    print(f"serving: multi-hypothesis on_track (samples "
          f"{sorted(MULTI_FRAMES)}), track_video_chunked, apps/predict.py on "
          f"the card; {RES}^2 and {SCORE_RES}^2 scoring, the production mesh "
          f"culled per view", flush=True)
    e1, e3, serve_cases = check_culled_views(tracker, pose0)
    errs["raster_pass1"] = max(errs["raster_pass1"], e1)
    errs["pass2_shade"] = max(errs["pass2_shade"], e3)
    rgb_r, depth_r = rendered_frame(tracker, pose0)
    multi_runs = run_multi(tracker, pose0, rgb_r, depth_r)
    check_multi(multi_runs, tracker, pose0)
    for samples in SERVE_VIEWS:
        by_path[f"serving on_track samples={samples}"] = multi_runs[samples][0]
    compare_multi(net, tracker, pose0, rgb_r, depth_r)
    by_path["serving track_video_chunked"] = run_chunked(tracker, pose0, rgb,
                                                         depth)
    # the tree stays for phase 9's predict runs; removed after them, or at
    # exit when a phase fails
    ycb_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ycb_")
    root = pathlib.Path(ycb_tmp.name)
    gts, ckpt = write_ycb_tree(root, production_mesh()[0], pose0, dev)
    predict_launches = run_predict(root, ckpt, gts, dev, card)
    by_path["serving predict scan"] = predict_launches["scan, timed"]
    by_path["serving predict scan with canvases"] = predict_launches["scan"]
    by_path["serving predict ontrack"] = predict_launches["ontrack"]
    nview = time_serving(tracker, pose0, (rgb, depth), (rgb_r, depth_r),
                         multi_runs, serve_cases, card)
    print(f"serving phase: {time.perf_counter() - t8:.1f} s", flush=True)

    # 9. The live path: the stream bit-equal to track_video, pushes that
    # never wait, its launches, the multi-hypothesis stream, containment and
    # re-init, fill_depth and the ROS core, predict in stream mode, the PNG
    # decoders, and the live timings.
    t9 = time.perf_counter()
    print(f"live: StreamTracker (windowed packed uploads, the pose on the "
          f"device, background fetches), the ROS core with fill_depth, "
          f"predict --track_mode stream; {RES}^2, {FRAME_HW[0]}x"
          f"{FRAME_HW[1]} frames", flush=True)
    live_launches = run_live(tracker, pose0, rgb, depth)
    by_path["live"] = live_launches[True]
    by_path["live full frames"] = live_launches[False]
    check_push_syncs(tracker, pose0, rgb, depth)
    check_push_behind_sleep(tracker, pose0, rgb, depth, card)
    by_path["live samples=4"], multi_s = run_live_multi(tracker, pose0,
                                                        rgb_r, depth_r)
    check_live_failure_paths(tracker, pose0, rgb_r, depth_r)
    check_fill_and_ros(tracker, pose0, rgb_r, depth_r, card)
    stream_launches = run_predict_stream(root, ckpt, dev, card)
    by_path["live predict stream"] = stream_launches["stream"]
    time_live(tracker, pose0, rgb, depth, multi_s, card)
    print(f"live phase: {time.perf_counter() - t9:.1f} s", flush=True)

    # 10. The adaptive dispatcher (bit-equal to track_video, its launches,
    # samples 4, predict adaptive on phase 8's tree, the modes' rates in
    # turns) and the synthetic pair factory (produce_dataset with its
    # launches, read back and trained on; DR scenes card against CPU;
    # complete_blender; the split and the kernels at the new shapes).
    t10 = time.perf_counter()
    print(f"adaptive and datagen: AdaptiveVideoTracker {ADAPTIVE_CANDIDATES} "
          f"at {RES}^2 on {FRAME_HW[0]}x{FRAME_HW[1]} frames; "
          f"produce_dataset of {DATAGEN_TRAIN} + {DATAGEN_VAL} pairs of the "
          f"production mesh at {FRAME_HW[0]}x{FRAME_HW[1]}, {RES}^2",
          flush=True)
    by_path["adaptive"] = run_adaptive(tracker, pose0, rgb, depth, card)
    by_path["adaptive samples=4"] = run_adaptive_multi(tracker, pose0, rgb_r,
                                                       depth_r)
    by_path["adaptive predict"] = run_predict_adaptive(root, ckpt, dev)
    ycb_tmp.cleanup()
    time_adaptive(tracker, pose0, rgb, depth, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_datagen_") as tmp:
        tmp = pathlib.Path(tmp)
        by_path["datagen produce_dataset"] = run_datagen(
            tracker, dev, tmp / "dr", card)
        by_path["datagen complete_blender"] = run_complete_blender(
            dev, tmp / "blender")
    check_dr_scenes_with_cpu(dev)
    datagen_shapes = time_datagen(dev, card)
    print(f"adaptive and datagen phase: {time.perf_counter() - t10:.1f} s",
          flush=True)

    # 11. The accuracy suite and the bf16 CNN: pass2_shade at the suite's
    # lighting on full frames, shift_video card against CPU and its time, a
    # reduced run_suite with its launches predicted, and bf16 tracking and
    # training against float32.
    t11 = time.perf_counter()
    print(f"accuracy suite and bf16: the sensor model at x"
          f"{' and x'.join(f'{s:g}' for s in SUITE_SEVERITIES)}, run_suite "
          f"on the production mesh ({SUITE_STEPS} steps at batch "
          f"{SUITE_BATCH}, {SUITE_FRAMES} frames, a {SUITE_LONG}-frame long "
          f"horizon) at {FRAME_HW[0]}x{FRAME_HW[1]}, the bf16 CNN at "
          f"{RES}^2", flush=True)
    e3, suite_rows = check_suite_lighting(ff_cases["production"], dev, card)
    errs["pass2_shade"] = max(errs["pass2_shade"], e3)
    check_shift_video(frames, gt, dev, card)
    by_path["accuracy suite"] = run_suite_reduced(dev, card)
    check_bf16(net, tracker, pose0, rgb, depth, card)
    print(f"accuracy suite and bf16 phase: {time.perf_counter() - t11:.1f} s",
          flush=True)

    # 12. The scale-out layer: an object ensemble and batched videos on the
    # one card, ensemble training, the suite's ensemble mode, and two ranks
    # sharing the card over gloo (face-sharded render and step, DP).
    t12 = time.perf_counter()
    print(f"scale-out: an ensemble of {ENSEMBLE_O} objects and {VIDEOS_V} "
          f"batched videos ({ENSEMBLE_T} and {VIDEOS_T} frames at {RES}^2 on "
          f"{FRAME_HW[0]}x{FRAME_HW[1]} frames), ensemble training at batch "
          f"{TRAIN_BATCH}, run_suite(ensemble=True), two gloo ranks on the "
          f"card", flush=True)
    ens_case = ensemble_case(dev)
    ens_launches, (ens_views, e1, e3) = run_ensemble_tracking(ens_case, card)
    del ens_case
    by_path["ensemble tracking serial"] = ens_launches[True]
    by_path["ensemble tracking batched"] = ens_launches[False]
    errs["raster_pass1"] = max(errs["raster_pass1"], e1)
    errs["pass2_shade"] = max(errs["pass2_shade"], e3)
    by_path["batched videos"], (video_views, e1, e3) = run_batched_videos(
        tracker, pose0, rgb, depth, card)
    errs["raster_pass1"] = max(errs["raster_pass1"], e1)
    errs["pass2_shade"] = max(errs["pass2_shade"], e3)
    run_ensemble_training(dev, card)
    by_path["accuracy suite ensemble"] = run_suite_ensemble(dev, card)
    ranks = run_two_ranks(card)
    by_path["sharded render (rank 0 of 2)"] = \
        ranks["launches"]["sharded_render"]
    by_path["sp_track_step (rank 0 of 2)"] = ranks["launches"]["sp_track_step"]
    errs["raster_pass1"] = max(errs["raster_pass1"], ranks["k1_err"])
    errs["gather_rows"] = max(errs["gather_rows"], ranks["k2_err"])
    print(f"scale-out phase: {time.perf_counter() - t12:.1f} s", flush=True)

    # 13. The last modules: the TF32 pin in a fresh process (F16) and the
    # TF32 drift (F1), utils/profiling, render_at_bbox, and the demo, the
    # fixture and the dry run through their main().
    t13 = time.perf_counter()
    print(f"last modules: F16 in a fresh process over {F16_FRAMES} frames, "
          f"TF32 drift at batch {TF32_BATCHES}, StepTimer and trace, "
          f"render_at_bbox at {RES}^2, the demo ({DEMO_STEPS} steps at batch "
          f"{DEMO_BATCH}, {DEMO_FRAMES} frames), the fixture and the dry run",
          flush=True)
    check_f16(tracker, pose0, rgb, depth, card)
    tf32_drift(tracker, card)
    check_profiling(tracker, pose0, rgb, depth, card)
    by_path["render_at_bbox"] = check_render_at_bbox(tracker, pose0, net,
                                                     card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_apps_") as tmp:
        by_path.update(run_apps(pathlib.Path(tmp), dev, card))
    print(f"last modules phase: {time.perf_counter() - t13:.1f} s {card}",
          flush=True)

    # 14. Where a track is lost: XLA's int32 conversion on the card, one
    # step in each lost-track regime against the CPU path, and F14's
    # float64 witness.
    t14 = time.perf_counter()
    print(f"lost track and F14: int32 conversion, {len(lost_track_poses(1.0))}"
          f" lost-track steps at {RES}^2 on {FRAME_HW[0]}x{FRAME_HW[1]} "
          f"frames, first-step gradients against float64 at {RES}^2",
          flush=True)
    check_int32_conversion(dev, card)
    by_path["lost track"] = run_lost_track(net, tracker, rgb, depth, card)
    f14_witness(dev, card)
    print(f"lost track and F14 phase: {time.perf_counter() - t14:.1f} s "
          f"{card}", flush=True)

    # 15. The compiled step: captured once per key as a CUDA graph and
    # replayed by track_video, on_track and the stream, bit-equal to the
    # eager step, sync-free, its launches counted per replay; the rates in
    # turns, the capture times and the busy share.
    t15 = time.perf_counter()
    print(f"compiled step: CUDA graphs of track_step on the production "
          f"configuration (float32 and bf16), {COMPILED_FRAMES} track_video "
          f"frames twice, {COMPILED_ON_TRACK} on_track frames, "
          f"{COMPILED_FRAMES} stream pushes at {RES}^2 on {FRAME_HW[0]}x"
          f"{FRAME_HW[1]} frames", flush=True)
    by_path.update(run_compiled(net, tracker, pose0, rgb, depth, card))
    print(f"compiled step phase: {time.perf_counter() - t15:.1f} s {card}",
          flush=True)

    # 16. The render set-up kernel: against its plain version on the
    # render paths' shapes, K1's winners through both, one launch a render
    # on every path, a step's device operations with it and without, and
    # its times.
    t16 = time.perf_counter()
    print(f"render set-up: render_setup against its plain version, K1 over "
          f"{SETUP_AGREEMENT_POSES} poses, the render paths' launches, the "
          f"step's device operations, timings at {RES}^2", flush=True)
    setup_entry = run_render_setup(tracker, pose0, rgb, depth, card)
    print(f"render set-up phase: {time.perf_counter() - t16:.1f} s {card}",
          flush=True)

    # 17. FoundationPose's refiner: both rounds in one graph, bit-equal to
    # the eager step, against the CPU path and the plain reference, float32
    # and bf16.
    t17 = time.perf_counter()
    run_refiner(card)
    print(f"refiner phase: {time.perf_counter() - t17:.1f} s {card}",
          flush=True)

    print(f"chip_smoke: {time.perf_counter() - t_main:.1f} s from start to "
          f"the result lines, kernel builds included {card}", flush=True)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"{PORT}/csrc/{name}.cu", "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name],
         **{k: report[name][k] for k in keys},
         "launches_by_path": {p: c[name] for p, c in by_path.items()},
         **({"serving_views": [
             {k: v for k, v in r.items() if k != "library_ms"}
             for r in nview[name]]} if name in nview else {}),
         **({"datagen_shapes": [
             {k: v for k, v in r.items() if k not in ("kernel", "library_ms")}
             for r in datagen_shapes if r["kernel"] == name]}
            if any(r["kernel"] == name for r in datagen_shapes) else {}),
         **({"suite_lighting": [
             {k: v for k, v in r.items() if k != "library_ms"}
             for r in suite_rows]} if name == "pass2_shade" else {}),
         **({"scale_out_views": [ens_views[name], video_views[name]]}
            if name in ens_views else {}),
         **({"sharded_render": ranks["k2"]} if name == "gather_rows" else {})}
        for name in REPLACES] + [setup_entry]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
