#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the tracking step, the
closed-loop synthetic evaluation and synthetic training.

    python3 chip_smoke.py

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
     on the host), ``track_video`` in turns with the earlier pass 2, and the
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
     bounds at 8 and at 400 views.

Every timing line carries the card's name and power limit. The line before
the last is ``{"kernels": [...]}``: per kernel its route, source, the TPU
kernel it replaces, its launches on the main path (the tracking slice; K3's
from the evaluation path), its largest error against its plain version, and
``ms``, ``plain_ms``, ``bound_ms`` / ``bound_by`` and ``library_ms`` on the
production inputs (K3: the full frame). The last is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Any failure raises, so the exit code is nonzero.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import functools
import json
import subprocess
import sys
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
# held to the same bars beside the card.
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


def make_tracker(net, device):
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    tm, cull = production_mesh()
    cfg = trk.TrackerConfig(
        resolution=RES, object_width_mm=float(tm.diameter) * 1000 * 1.1,
        cull_backfaces=cull)
    return trk.Tracker.from_parts(
        copy.deepcopy(net).to(device), cfg, rz.upload(tm, device), K_PROD,
        np.zeros(8, np.float32), np.full(8, 100.0, np.float32))


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
    fx, fy, fiz, fvalid, R, t = rz._project(
        mesh, torch.as_tensor(pose).to(dev), torch.as_tensor(K).to(dev),
        window, hw, rz.NEAR_M)
    attr = rz._face_attr_coefficients(fx, fy, fiz, fvalid, mesh)
    if cull:
        coef, bbox, fb, attr = rz.culled_pass1_inputs(mesh, fx, fy, fiz,
                                                      fvalid, R, t, attr)
        searched = fvalid & ~rz._backface_mask(mesh, R, t)
    else:
        coef, _ = rk.build_face_coefficients(fx, fy, fiz, fvalid)
        fb = fb or rz.pick_face_block(fx.shape[-2])
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


def pass2_bound(case):
    """pass2_shade's bound on an untextured case: iz, win, R and t read,
    and the distinct attribute rows the hit pixels' winners name; rgb and
    depth written; OPS_PER_HIT_PIXEL for each hit pixel."""
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk

    hit = rk.zmin_from_iz(case["iz"]) < FAR
    return bound(nbytes(case["iz"], case["win"], case["R"], case["t"])
                 + winner_rows_bytes(case["attr"], case["win"], hit)
                 + case["iz"].numel() * 16,
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
    """Device time per call of ``fn`` in the __global__ functions whose
    names hold ``DEVICE_FN[kernel]`` (summed over them), over PROFILE_CALLS
    calls under torch.profiler, or None when the profiler saw none."""
    prof = profile_share(lambda: [fn() for _ in range(PROFILE_CALLS)],
                         top=100)
    if prof is None:
        return None
    rows = [us for key, us, _ in prof[3] if DEVICE_FN[kernel] in key]
    if not rows:
        return None
    return sum(rows) / 1e3 / PROFILE_CALLS


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


def zero_launches():
    """Set every kernel wrapper's launch count to 0."""
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk

    for fn in WRAPPERS.values():
        getattr(rk, fn).launches = 0


def read_launches():
    """Every kernel's launch count, by kernel name."""
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk

    return {k: getattr(rk, fn).launches for k, fn in WRAPPERS.items()}


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
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
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
    bufA, bufB = trk.normalize_pair(aux["rgbA"], aux["depthA"], aux["rgbB"],
                                    aux["depthB"], pose, t.mean, t.std)
    window = rz.window_from_bbox(roi.compute_bbox(
        pose, t.K, cfg.object_width_mm, (1000.0, 1000.0, 1000.0)))

    def crop_normalize():
        bbox = roi.compute_bbox(pose, t.K, cfg.object_width_mm,
                                (1000.0, 1000.0, 1000.0))
        rgbB, depthB = roi.crop_bbox(rgb_t, depth_t, bbox, (RES, RES))
        return trk.normalize_pair(aux["rgbA"], aux["depthA"], rgbB.float(),
                                  depthB.float(), pose, t.mean, t.std)

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

    n0 = rk.pass1_winners.launches
    iz, win = rk.pass1_winners(coef, bbox, hw, fb)
    if coef.is_cuda and rk.pass1_winners.launches != n0 + 1:
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
            _, synth_cpu, _ = train_setup(cpu, res)
            _, synth_dev, _ = train_setup(dev, res)
            raw = sampled_on_both(synth_cpu, synth_dev, n, SEED + 5)
            aug_cfg = AUG.AugmentConfig()
            mean = torch.tensor([80, 80, 80, 0, 80, 80, 80, 0],
                                dtype=torch.float32)
            std = torch.tensor([60, 60, 60, 100, 60, 60, 60, 100],
                               dtype=torch.float32)
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
    """``Tracker.track_video`` over ``n`` frames with pass 2 fused and with
    the earlier unfused pass 2, in turns (fused, unfused, unfused, fused),
    host clock around work that ends with the poses on the host."""
    rgbs, depths = np.stack([rgb] * n), np.stack([depth] * n)
    hz = {}
    for which in ("fused", "unfused", "unfused", "fused"):
        with unfused_pass2() if which == "unfused" else \
                contextlib.nullcontext():
            tracker.track_video(pose0, rgbs[:3], depths[:3])  # warm
            t0 = time.perf_counter()
            tracker.track_video(pose0, rgbs, depths)
            hz.setdefault(which, []).append(n / (time.perf_counter() - t0))
    print(f"timing track_video in turns ({n} frames each): pass 2 fused "
          f"{[round(h, 2) for h in hz['fused']]} Hz, unfused (K2 + "
          f"shade_rows) {[round(h, 2) for h in hz['unfused']]} Hz {card}",
          flush=True)


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
    with concurrent.futures.ThreadPoolExecutor(len(REPLACES)) as pool:
        builds = dict(zip(REPLACES, pool.map(timed_build, REPLACES)))
    for name, (path, log, secs) in builds.items():
        kbuild.load(name)
        print(f"built csrc/{name}.cu in {secs:.2f} s -> {path}")
        for line in log.splitlines():
            if "registers" in line or "bytes stack" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"all kernels built in {time.perf_counter() - t0:.2f} s", flush=True)

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

    print(f"chip_smoke: {time.perf_counter() - t_main:.1f} s from start to "
          f"the result lines, kernel builds included {card}", flush=True)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"{PORT}/csrc/{name}.cu", "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name],
         **{k: report[name][k] for k in keys}}
        for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
