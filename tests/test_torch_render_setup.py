"""The render set-up (``raster_kernels.render_setup``, the front end from a
pose to pass 1's and pass 2's tables) on the CPU, where the wrapper runs its
plain version: the tables the rasterizer composed before the set-up was one
call, bit for bit, for culled and unculled renders of one view, B views,
a textured mesh and a stacked mesh; ``render`` and ``track_step`` through
it unchanged; its argument checks; its launch counter; and its CUDA
kernel's name outside the benchmark trace's kernel classes."""
import pathlib
import re

import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu_torch.core import se3
from iros20_6d_pose_tracking_tpu_torch.data import dataset as DS
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.ops import roi
from iros20_6d_pose_tracking_tpu_torch.parallel import spmd
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as TRz
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
from iros20_6d_pose_tracking_tpu_torch.utils import profiling

torch.set_num_threads(2)

K = torch.tensor([[120.0, 0, 64.0], [0, 120.0, 48.0], [0, 0, 1.0]])
HW = (48, 48)
FRAME_HW = (96, 128)
WIDTH_MM = 110.0
KERNEL_SRC = (pathlib.Path(rk.__file__).parent.parent / "csrc"
              / "render_setup.cu")


def _poses(n, seed, z=(0.45, 0.6)):
    rng = np.random.RandomState(seed)
    w = torch.as_tensor(rng.randn(n, 3) * 0.6, dtype=torch.float32)
    t = torch.as_tensor(rng.uniform([-0.02, -0.02, z[0]], [0.02, 0.02, z[1]],
                                    (n, 3)), dtype=torch.float32)
    return se3.make_pose(se3.so3_exp(w), t)


def _windows(poses):
    return TRz.window_from_bbox(roi.compute_bbox(
        poses, K, WIDTH_MM, (1000.0, 1000.0, 1000.0)))


def _mesh(kind):
    if kind == "stacked":
        return spmd.stack_meshes([M.make_icosphere(subdiv=s, radius=r)
                                  for s, r in ((1, 0.04), (2, 0.05),
                                               (2, 0.03), (1, 0.06))], "cpu")
    tm = (M.make_textured_box() if kind == "textured"
          else M.make_icosphere(subdiv=2, radius=0.05))
    return TRz.upload(tm, "cpu")


def _case(kind, views, cull, seed=0):
    """(mesh, pose, window, hw, cull) of one render: ``views`` poses (one
    unbatched pose for 1), each in its ROI window; "full frame" is one view
    of the whole frame with the window as four numbers, "near" one pose
    whose corners straddle the near plane."""
    mesh = _mesh("stacked" if kind == "stacked" else
                 "textured" if kind == "textured" else "icosphere")
    if kind == "full frame":
        return (mesh, _poses(1, seed)[0], TRz.full_frame_window(128, 96),
                FRAME_HW, cull)
    pose = _poses(views, seed, z=(0.11, 0.13) if kind == "near"
                  else (0.45, 0.6))
    if views == 1 and kind != "stacked":
        pose = pose[0]
    return mesh, pose, _windows(pose), HW, cull


def _composition(mesh, pose, window, hw, cull):
    """The front end as ``render`` composed it before ``render_setup``."""
    fx, fy, fiz, fvalid, R, t = rk.project_faces(mesh, pose, K, window, hw,
                                                 TRz.NEAR_M)
    attr = rk.face_attr_forms(fx, fy, fiz, fvalid, mesh)
    if cull:
        return rk.culled_pass1_inputs(mesh, fx, fy, fiz, fvalid, R, t, attr)
    coef, _ = rk.build_face_coefficients(fx, fy, fiz, fvalid)
    fb = rk.pick_face_block(fx.shape[-2])
    return coef, rk.build_block_bboxes(fx, fy, fvalid, fb), fb, attr


def _old_render(mesh, pose, K_, window, out_hw=(176, 176), near=TRz.NEAR_M,
                far=TRz.FAR_M, cull_backfaces=False, lighting=None,
                worklist=False):
    """``render`` before ``render_setup``: the composition, then pass 1 and
    pass 2 on ``project_faces``'s R and t."""
    fx, fy, fiz, fvalid, R, t = rk.project_faces(mesh, pose, K_, window,
                                                 out_hw, near)
    attr = rk.face_attr_forms(fx, fy, fiz, fvalid, mesh)
    if cull_backfaces:
        coef, bbox, fb, attr = rk.culled_pass1_inputs(mesh, fx, fy, fiz,
                                                      fvalid, R, t, attr)
    else:
        coef, _ = rk.build_face_coefficients(fx, fy, fiz, fvalid)
        fb = rk.pick_face_block(fx.shape[-2])
        bbox = rk.build_block_bboxes(fx, fy, fvalid, fb)
    pass1 = rk.pass1_worklist if worklist else rk.pass1_winners
    iz, winner = pass1(coef, bbox, out_hw, fb)
    return rk.pass2_shade(attr, iz, winner, R, t, out_hw, far,
                          texture=mesh.texture, lighting=lighting)


def _same(a, b):
    """Bit for bit (NaN entries equal when both are NaN)."""
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all()) and bool(
        (torch.signbit(a) == torch.signbit(b))[a == b].all())


CASES = [("icosphere", 1, False), ("icosphere", 1, True),
         ("icosphere", 5, False), ("icosphere", 5, True),
         ("textured", 1, True), ("textured", 3, False),
         ("stacked", 4, True), ("stacked", 4, False),
         ("full frame", 1, False), ("near", 1, True), ("near", 3, False)]


@pytest.mark.parametrize("kind,views,cull", CASES)
def test_render_setup_equals_composition(kind, views, cull):
    """The wrapper on CPU tensors gives the composition's four outputs bit
    for bit: coef, block bboxes, face block, attribute forms."""
    mesh, pose, window, hw, cull = _case(kind, views, cull)
    got = rk.render_setup(mesh, pose, K, window, hw, TRz.NEAR_M, cull)
    want = _composition(mesh, pose, window, hw, cull)
    assert got[2] == want[2]
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert _same(g, w)
    lead = () if pose.dim() == 2 else pose.shape[:1]
    F = mesh.fverts.shape[-3]
    assert got[0].shape == lead + (12, F)
    assert got[3].shape == lead + (F, 36 if kind == "textured" else 30)
    if kind == "near":  # some faces cross the near plane, some do not
        _, _, _, fvalid, _, _ = rk.project_faces(mesh, pose, K, window, hw,
                                                 TRz.NEAR_M)
        assert 0 < int((fvalid & mesh.fmask).sum()) < int(
            mesh.fmask.sum()) * fvalid.numel() // fvalid.shape[-1]


@pytest.mark.parametrize("kind,cull", [("icosphere", False),
                                       ("icosphere", True),
                                       ("stacked", True)])
def test_views_equal_single_views(kind, cull):
    """View b of a batched set-up is the set-up of pose b alone (of mesh b
    alone, for a stacked mesh), bit for bit."""
    mesh, pose, window, hw, cull = _case(kind, 4, cull, seed=3)
    coef, bbox, fb, attr = rk.render_setup(mesh, pose, K, window, hw,
                                           TRz.NEAR_M, cull)
    for b in range(4):
        m = TRz.mesh_of(mesh, b) if kind == "stacked" else mesh
        c1, b1, fb1, a1 = rk.render_setup(m, pose[b], K, window[b], hw,
                                          TRz.NEAR_M, cull)
        assert fb1 == fb
        assert _same(coef[b], c1) and _same(bbox[b], b1)
        assert _same(attr[b], a1)


@pytest.mark.parametrize("kind,views,cull,worklist", [
    ("icosphere", 1, True, False), ("icosphere", 4, False, False),
    ("textured", 2, True, False), ("full frame", 1, False, True)])
def test_render_unchanged(kind, views, cull, worklist):
    """``render`` through the set-up gives the earlier render's rgb and
    depth bit for bit."""
    mesh, pose, window, hw, cull = _case(kind, views, cull, seed=5)
    kw = dict(out_hw=hw, cull_backfaces=cull, worklist=worklist)
    rgb, depth = TRz.render(mesh, pose, K, window, **kw)
    rgb_o, depth_o = _old_render(mesh, pose, K, window, **kw)
    assert _same(rgb, rgb_o) and _same(depth, depth_o)
    assert int((depth > 0).sum()) > 50


def test_track_step_unchanged(monkeypatch):
    """One culled ``track_step`` (the tracker's ROI render through the
    set-up) gives the pose of the same step through the earlier render, bit
    for bit, one pose and three hypotheses."""
    torch.manual_seed(0)
    net = tracknet.create_model(HW[0]).eval()
    cfg = trk.TrackerConfig(resolution=HW[0], object_width_mm=WIDTH_MM,
                            cull_backfaces=True)
    mesh = _mesh("icosphere")
    gt = _poses(1, 7)[0]
    rgb, depth = TRz.render(mesh, gt, K, TRz.full_frame_window(128, 96),
                            FRAME_HW)
    frame = (rgb.to(torch.uint8), depth.to(torch.int32))
    mean, std = torch.zeros(8), torch.full((8,), 100.0)
    prior = gt.clone()
    prior[:3, 3] += torch.tensor([0.004, -0.002, 0.01])
    priors = torch.stack([prior, gt, prior @ _poses(1, 8, z=(0, 0))[0]])
    new = [trk.track_step(net, cfg, mesh, K, mean, std, p, *frame)[0]
           for p in (prior, priors)]
    monkeypatch.setattr(TRz, "render", _old_render)
    old = [trk.track_step(net, cfg, mesh, K, mean, std, p, *frame)[0]
           for p in (prior, priors)]
    for a, b in zip(new, old):
        assert _same(a, b) and bool(torch.isfinite(a).all())


def _meta(t):
    return None if t is None else torch.empty_like(t, device="meta")


@pytest.mark.parametrize("bad,match", [
    ("pose_shape", "pose must be"), ("stacked_one_pose", "pose must be"),
    ("mesh_shape", "mesh fnormals must be"), ("window", "window must be"),
    ("K", "K must be"), ("hw", "bad window size"),
    ("device", "is on meta")])
def test_argument_checks(bad, match):
    """Off the CPU the wrapper checks its arguments before any launch
    (meta tensors reach the checks without a card)."""
    kind = "stacked" if bad == "stacked_one_pose" else "icosphere"
    mesh, pose, window, hw, cull = _case(kind, 2, True)
    mesh = TRz.MeshArrays(*map(_meta, mesh))
    pose, window, K_ = _meta(pose), _meta(window), _meta(K)
    if bad == "pose_shape":
        pose = pose[..., :3, :]
    elif bad == "stacked_one_pose":
        pose = pose[0]
    elif bad == "mesh_shape":
        mesh = mesh._replace(fnormals=mesh.fnormals[..., :2])
    elif bad == "window":
        window = window[:, :3]
    elif bad == "K":
        K_ = K_[:2]
    elif bad == "hw":
        hw = (0, 48)
    with pytest.raises(ValueError, match=match):
        rk.render_setup(mesh, pose, K_, window, hw, TRz.NEAR_M, cull)


def test_window_argument():
    """Four numbers go to the kernel by value, a tensor as one float32
    (B, 4) tensor; any other size raises."""
    assert rk._window_arg((1, 2.5, 3, 4), 1) == (None, [1.0, 2.5, 3.0, 4.0])
    win, _ = rk._window_arg(torch.arange(8.0, dtype=torch.float64)
                            .reshape(2, 4), 2)
    assert win.dtype == torch.float32 and win.shape == (2, 4)
    for bad in (torch.zeros(4), (1, 2, 3)):
        with pytest.raises(ValueError, match="window must be"):
            rk._window_arg(bad, 2)


def test_launch_counter_one_per_render(monkeypatch):
    """``launches.render_setup`` counts the wrapper's launches, and every
    render path calls the wrapper once a render: one pose, B poses,
    ``render_at_bbox``, a full frame through K3, ``track_step``, the
    sampler's ``render_pairs``."""
    calls = []

    def counting(*a, **kw):
        profiling.count("launches.render_setup")
        calls.append(a[1].shape)
        return rk.render_setup_ref(*a, **kw)

    monkeypatch.setattr(rk, "render_setup", counting)
    mesh, pose, window, hw, _ = _case("icosphere", 3, True)

    def read():
        return profiling.counters()["launches.render_setup"]

    net = tracknet.create_model(HW[0]).eval()
    cfg = trk.TrackerConfig(resolution=HW[0], object_width_mm=WIDTH_MM,
                            cull_backfaces=True)
    frame = (torch.zeros(FRAME_HW + (3,), dtype=torch.uint8),
             torch.full(FRAME_HW, 500, dtype=torch.int32))
    paths = [
        lambda: TRz.render(mesh, pose[0], K, window[0], hw),
        lambda: TRz.render(mesh, pose, K, window, hw, cull_backfaces=True),
        lambda: TRz.render_at_bbox(mesh, pose[1], K, WIDTH_MM, hw),
        lambda: TRz.render(mesh, pose[2], K, TRz.full_frame_window(128, 96),
                           FRAME_HW, worklist=True),
        lambda: trk.track_step(net, cfg, mesh, K, torch.zeros(8),
                               torch.full((8,), 100.0), pose[0], *frame),
        lambda: DS.render_pairs(mesh, K, pose[:2], pose[1:], HW[0],
                                WIDTH_MM),
    ]
    for fn in paths:
        before = read()
        fn()
        assert read() == before + 1
    assert calls == [(4, 4), (3, 4, 4), (4, 4), (4, 4), (4, 4), (4, 4, 4)]


def test_kernel_name_outside_trace_classes():
    """The kernel's __global__ function is named outside the benchmark
    trace's CNN, K1 and pass-2 classes, so its device time counts with the
    small kernels it replaces."""
    from portbench import trace

    src = KERNEL_SRC.read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                       r"(\w+)\s*\(", src)
    assert names == ["render_setup_kernel"]
    profiled = "void (anonymous namespace)::render_setup_kernel(" \
        "(anonymous namespace)::Args)"
    for pattern in (trace.CNN_KERNEL, trace.K1_KERNEL, trace.PASS2_KERNEL):
        for name in names + [profiled]:
            assert not pattern.search(name), (pattern.pattern, name)
