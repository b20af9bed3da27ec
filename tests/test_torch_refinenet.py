"""FoundationPose's refiner in the port (``models/refinenet.py``) on the
CPU: the module against its plain reference (``models/refinenet_
reference.py``) at a small width (tokens 8x8, the published layer
pattern), its encoder layer against torch's ``nn.TransformerEncoderLayer``,
the published widths built on the meta device, the XYZ map of a crop and of
a render window against a direct back-projection, the two-round tracking
step against the benchmark's plain reference step, the refiner through the
tracker's entry points (the compiled step, ``on_track``, the stream) with
its spans and counters, and Se3TrackNet's step unchanged, bit for bit,
against a stored run of the path before the refiner came."""
import os

import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu_torch.models import refinenet as R
from iros20_6d_pose_tracking_tpu_torch.models import refinenet_reference as ref
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.ops import pointcloud as pc
from iros20_6d_pose_tracking_tpu_torch.ops import roi
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
from iros20_6d_pose_tracking_tpu_torch.tracking import compiled
from iros20_6d_pose_tracking_tpu_torch.tracking import stream as st
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
from iros20_6d_pose_tracking_tpu_torch.utils import profiling

torch.set_num_threads(2)
CPU = torch.device("cpu")
DATA = os.path.join(os.path.dirname(__file__), "data")
H, W = 96, 128
K = np.array([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1.0]], np.float32)


def seeded(net: torch.nn.Module, seed: int, head_scale: float = 1.0):
    """Random BatchNorm statistics and affine parameters, LayerNorm
    parameters and biases (all 0 or 1 by default), the heads scaled."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, tracknet.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
        for name, p in net.named_parameters():
            if name.endswith("bias") or "norm" in name or ".net.1." in name \
                    or ".bn" in name:
                p.add_(torch.rand(p.shape, generator=g) * 0.2 - 0.1)
        for head in (net.trans_head[1], net.rot_head[1]):
            head.weight.mul_(head_scale)
    return net.eval()


def small_blocks(b):
    return ((("cbr", 6, b, 7, 2), ("cbr", b, 2 * b, 3, 2),
             ("res", 2 * b, 2 * b, 3, 1), ("res", 2 * b, 2 * b, 3, 1)),
            (("res", 4 * b, 4 * b, 3, 1), ("res", 4 * b, 4 * b, 3, 1),
             ("cbr", 4 * b, 8 * b, 3, 2), ("res", 8 * b, 8 * b, 3, 1),
             ("res", 8 * b, 8 * b, 3, 1)))


@pytest.mark.parametrize("batch", [1, 3])
def test_module_matches_reference_at_a_small_width(batch):
    torch.manual_seed(0)
    net = seeded(R.RefineNet(base=8), 1)
    g = torch.Generator().manual_seed(2)
    A = torch.rand(batch, 64, 64, 6, generator=g)
    B = torch.rand(batch, 64, 64, 6, generator=g)
    tokens = []
    net.encodeAB.register_forward_hook(
        lambda m, i, o: tokens.append(o.shape[-2:]))
    with torch.no_grad():
        out = net(A, B)
    assert tuple(tokens[0]) == (8, 8)
    want = ref.forward(net.state_dict(), A, B, *small_blocks(8))
    for k in ("trans", "rot"):
        assert out[k].dtype == torch.float32
        torch.testing.assert_close(out[k], want[k], rtol=1e-4, atol=2e-6)


def test_bf16_follows_float32():
    torch.manual_seed(0)
    net = seeded(R.RefineNet(base=8), 1)
    net16 = R.RefineNet(torch.bfloat16, base=8).eval()
    net16.load_state_dict(net.state_dict())
    g = torch.Generator().manual_seed(3)
    A, B = (torch.rand(2, 64, 64, 6, generator=g) for _ in range(2))
    with torch.no_grad():
        o32, o16 = net(A, B), net16(A, B)
    for k in ("trans", "rot"):
        assert o16[k].dtype == torch.float32
        gap = float((o16[k] - o32[k]).abs().max())
        assert 0 < gap < 0.05, (k, gap)
    assert all(p.dtype == torch.float32 for p in net16.parameters())


def test_encoder_layer_is_torchs():
    torch.manual_seed(4)
    theirs = torch.nn.TransformerEncoderLayer(
        64, 4, 64, dropout=0.0, batch_first=True).eval()
    ours = R.EncoderLayer(64, 4, 64).eval()
    assert list(ours.state_dict()) == list(theirs.state_dict())
    ours.load_state_dict(theirs.state_dict())
    x = torch.randn(2, 10, 64, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        torch.testing.assert_close(ours(x), theirs(x), rtol=1e-5, atol=1e-5)


def test_published_widths_on_meta():
    with torch.device("meta"):
        net = R.RefineNet()
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert shapes["encodeA.0.net.0.weight"] == (64, 6, 7, 7)
    assert shapes["encodeA.1.net.0.weight"] == (128, 64, 3, 3)
    assert shapes["encodeA.3.conv2.weight"] == (128, 128, 3, 3)
    assert shapes["encodeAB.0.conv1.weight"] == (256, 256, 3, 3)
    assert shapes["encodeAB.2.net.0.weight"] == (512, 256, 3, 3)
    assert shapes["encodeAB.2.net.1.running_var"] == (512,)
    assert shapes["encodeAB.4.bn2.weight"] == (512,)
    assert shapes["pos_embed.pe"] == (1, 400, 512)
    for h in ("trans_head", "rot_head"):
        assert shapes[f"{h}.0.self_attn.in_proj_weight"] == (1536, 512)
        assert shapes[f"{h}.0.self_attn.out_proj.weight"] == (512, 512)
        assert shapes[f"{h}.0.linear1.weight"] == (512, 512)
        assert shapes[f"{h}.0.norm2.bias"] == (512,)
        assert shapes[f"{h}.1.weight"] == (3, 512)
    n = sum(p.numel() for p in net.parameters())
    assert n == 16_830_406 and round(n / 1e6, 1) == 16.8
    seen = []
    net.encodeAB.register_forward_hook(lambda m, i, o: seen.append(o.shape))
    x = torch.empty(1, 160, 160, 6, device="meta")
    out = net(x, x)
    assert tuple(seen[0]) == (1, 512, 20, 20)       # 400 tokens
    assert tuple(out["trans"].shape) == (1, 3)


def test_positional_table_is_published():
    pe = R.sinusoid(400, 512)[0].double()
    p, i = 123, 37
    w = 10000.0 ** (-2 * i / 512)
    assert abs(float(pe[p, 2 * i]) - np.sin(p * w)) < 1e-5
    assert abs(float(pe[p, 2 * i + 1]) - np.cos(p * w)) < 1e-5
    # the published float32 table: its phase p w rounds by up to 400 ulp(1)
    torch.testing.assert_close(R.sinusoid(400, 512)[0],
                               ref.sinusoid(400, 512), rtol=0, atol=5e-5)


def _frame():
    mesh = rz.upload(M.make_cube(0.08), CPU)
    gt = torch.eye(4)
    gt[:3, :3] = torch.tensor([[0.96, -0.28, 0.0], [0.28, 0.96, 0.0],
                               [0.0, 0.0, 1.0]])
    gt[:3, 3] = torch.tensor([0.01, -0.005, 0.55])
    rgb, depth = rz.render(mesh, gt, torch.as_tensor(K),
                           rz.full_frame_window(W, H), out_hw=(H, W),
                           cull_backfaces=True)
    return mesh, gt, rgb.to(torch.uint8), depth.to(torch.int32)


def _direct(depth_mm, us, vs):
    """Back-projection pixel by pixel in float64."""
    Kd = K.astype(np.float64)
    z = depth_mm.astype(np.float64) / 1000.0
    out = np.zeros(z.shape + (3,))
    for i in range(z.shape[0]):
        for j in range(z.shape[1]):
            out[i, j] = ((us[j] - Kd[0, 2]) * z[i, j] / Kd[0, 0],
                         (vs[i] - Kd[1, 2]) * z[i, j] / Kd[1, 1], z[i, j])
    return out


@pytest.mark.parametrize("shift", [(0, 0), (-40, 60)])
def test_xyz_of_a_crop_is_the_frames_at_its_source_pixels(shift):
    """(-40, 60): the ROI moved past the frame's top and right edges."""
    mesh, gt, rgb, depth = _frame()
    bbox = roi.compute_bbox(gt, torch.as_tensor(K), 110.0,
                            (1000.0, 1000.0, 1000.0))
    bbox = bbox + torch.tensor(shift, dtype=torch.int32)
    _, crop = roi.crop_bbox(rgb, depth, bbox, (32, 32))
    rows, cols = roi.source_pixels(bbox, (32, 32))
    xyz = pc.roi_xyz(crop, cols.float(), rows.float(), torch.as_tensor(K))
    full = _direct(depth.numpy(), np.arange(W), np.arange(H))
    r, c = rows.numpy(), cols.numpy()
    inside = ((r >= 0) & (r < H))[:, None] & ((c >= 0) & (c < W))[None]
    want = full[r.clip(0, H - 1)][:, c.clip(0, W - 1)]
    want[~inside] = 0.0
    assert inside.any() and (~inside).any() == (shift != (0, 0))
    np.testing.assert_allclose(xyz.numpy(), want, rtol=1e-6, atol=1e-7)


def test_xyz_of_a_render_is_its_pixel_centres():
    mesh, gt, _, _ = _frame()
    window = torch.tensor([50.3, 84.1, 30.7, 63.9])
    rgb, depth = rz.render(mesh, gt, torch.as_tensor(K), window,
                           out_hw=(24, 24), cull_backfaces=True)
    us, vs = pc.window_pixel_centres(window, (24, 24))
    left, right, top, bottom = window.double().numpy()
    j = np.arange(24) + 0.5
    np.testing.assert_allclose(us.numpy(), left + j * (right - left) / 24,
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(vs.numpy(), top + j * (bottom - top) / 24,
                               rtol=0, atol=2e-5)
    xyz = pc.roi_xyz(depth, us, vs, torch.as_tensor(K))
    want = _direct(depth.numpy(), left + j * (right - left) / 24,
                   top + j * (bottom - top) / 24)
    assert (depth > 0).float().mean() > 0.25
    np.testing.assert_allclose(xyz.numpy(), want, rtol=1e-5, atol=1e-6)
    # the hit pixels' points lie on the cube's surface: |p - t| <= r sqrt 3
    hit = depth.numpy() > 0
    d = np.linalg.norm(want[hit] - gt[:3, 3].numpy(), axis=-1)
    assert d.max() <= 0.04 * np.sqrt(3) + 1e-3


def test_normalized_xyz_masks_far_and_empty_points():
    xyz = torch.tensor([[[[0.0, 0.0, 0.5], [0.05, 0.0, 0.5],
                          [0.0, 0.0, 0.0005], [0.0, 0.0, 0.61]]]])
    n = pc.normalize_xyz(xyz, torch.tensor([[0.0, 0.0, 0.5]]), 0.05)
    torch.testing.assert_close(n[0, 0], torch.tensor(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0],
         [0.0, 0.0, 0.0]]))


def _refiner_tracker(base=8, res=48, dtype=torch.float32):
    mesh, gt, rgb, depth = _frame()
    torch.manual_seed(6)
    net = seeded(R.RefineNet(dtype, base=base), 7, head_scale=0.05)
    cfg = trk.TrackerConfig(resolution=res, object_width_mm=96.0,
                            cull_backfaces=True, dtype=dtype)
    t = trk.Tracker.from_parts(net, cfg, mesh, K, np.zeros(8, np.float32),
                               np.ones(8, np.float32))
    rgbs = torch.stack([torch.roll(rgb, i, 1) for i in range(4)])
    depths = torch.stack([torch.roll(depth, i, 1) for i in range(4)])
    init = gt.clone()
    init[:3, 3] += torch.tensor([0.004, -0.003, 0.01])
    return t, init, rgbs, depths


def test_two_round_step_matches_the_reference_step():
    from portbench.reference import refiner as pref

    t, init, rgbs, depths = _refiner_tracker(base=64)
    priors = torch.stack([init, init @ torch.tensor(
        [[1.0, 0, 0, 0.002], [0, 1, 0, 0], [0, 0, 1, -0.004], [0, 0, 0, 1]])])
    poses, aux = trk.track_step(t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
                                priors, rgbs[1], depths[1])
    assert aux["round_poses"].shape == (2, 2, 4, 4)
    sd = t.model.state_dict()
    cube = M.make_cube(0.08)
    mesh = {"verts": torch.as_tensor(cube.verts),
            "faces": torch.as_tensor(cube.faces[:cube.num_faces]).long(),
            "colors": torch.as_tensor(cube.colors),
            "normals": torch.as_tensor(cube.normals)}
    params = {k: sd[k] for k in pref.param_shapes()}
    buffers = {k: sd[k] for k in sd if "running" in k}
    cfg = {"object_width_mm": 96.0, "resolution": 48, "near_m": rz.NEAR_M,
           "far_m": rz.FAR_M}
    frames = (rgbs[1][None].expand(2, -1, -1, -1),
              depths[1][None].expand(2, -1, -1).float())
    for rounds in (1, 2):
        want = pref.step(params, buffers, mesh, torch.as_tensor(K), priors,
                         *frames, cfg, rounds=rounds)
        got = aux["round_poses"][rounds - 1].double()
        dt = (got[:, :3, 3] - want[:, :3, 3]).norm(dim=1)
        m = got[:, :3, :3] @ want[:, :3, :3].transpose(1, 2)
        vee = torch.stack([m[:, 2, 1] - m[:, 1, 2], m[:, 0, 2] - m[:, 2, 0],
                           m[:, 1, 0] - m[:, 0, 1]], 1)
        ang = torch.asin((vee.norm(dim=1) / 2).clamp(max=1.0))
        assert float(dt.max()) < 2e-6 and float(ang.max()) < 2e-5, (
            rounds, dt, ang)
    moved = (poses[:, :3, 3] - priors[:, :3, 3]).norm(dim=1)
    assert float(moved.min()) > 1e-5           # the rounds do something


def test_refiner_runs_through_the_tracker():
    t, init, rgbs, depths = _refiner_tracker()
    compiled.programs.clear()
    eager, p = [], init
    for i in range(4):
        p, aux = trk.track_step(t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
                                p, rgbs[i], depths[i])
        assert aux["round_poses"].shape == (2, 4, 4)
        assert torch.equal(aux["round_poses"][1], p)
        eager.append(p)
    eager = torch.stack(eager)
    before = profiling.counters()
    video = trk.track_video(t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
                            init, rgbs, depths)
    after = profiling.counters()
    assert torch.equal(video, eager)
    assert after["refine.rounds"] - before["refine.rounds"] == 8
    assert after["refine.attn_tokens"] - before["refine.attn_tokens"] == \
        4 * 2 * 2 * 36
    pose = init.numpy()
    for i in range(4):
        pose = t.on_track(pose, rgbs[i].numpy(),
                          depths[i].numpy().astype(np.uint16))
        np.testing.assert_array_equal(pose, eager[i].numpy())
    compiled.programs.clear()


def test_refiner_spans_in_an_eager_recorded_run():
    t, init, rgbs, depths = _refiner_tracker()
    profiling.reset()
    with profiling.recording():
        trk.track_step(t.model, t.cfg, t.mesh, t.K, t.mean, t.std, init,
                       rgbs[0], depths[0])
    rec = profiling.spans()
    profiling.reset()
    names = [s["name"] for s in rec]
    assert names.count("refiner.round") == 2
    assert names.count("refiner.encode") == 2
    assert names.count("refiner.heads") == 2
    rounds = [i for i, s in enumerate(rec) if s["name"] == "refiner.round"]
    assert all(rec[i]["parent"] in rounds for i, s in enumerate(rec)
               if s["name"] in ("refiner.encode", "refiner.heads"))
    assert sum(s["counts"].get("attn_tokens", 0) for s in rec) == 2 * 2 * 36


def test_windowed_stream_takes_the_refiner():
    t, init, rgbs, depths = _refiner_tracker()
    want = trk.track_video(t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
                           init, rgbs, depths)
    s = st.StreamTracker(t, window=True, refetch_every=2)
    s.begin(init.numpy())
    for i in range(4):
        s.push(rgbs[i].numpy(), depths[i].numpy().astype(np.uint16))
    got = s.poses()
    s.close()
    assert s.stats()["containment_violations"] == 0
    np.testing.assert_array_equal(got, want.numpy())


def test_se3tracknet_step_keeps_its_bits():
    """Se3TrackNet's eager step, batched step and compiled video on a
    seeded scene: the poses stored from the path before the refiner
    came, bit for bit."""
    stored = np.load(os.path.join(DATA, "se3tracknet_step_parent.npz"))
    np.testing.assert_array_equal(_se3tracknet_run(), stored["poses"])


def _se3tracknet_run():
    res, h, w = 48, 96, 128
    k = np.array([[150.0, 0, w / 2], [0, 150.0, h / 2], [0, 0, 1.0]],
                 np.float32)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        net = tracknet.Se3TrackNet(res)
        g = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, tracknet.BatchNorm2d):
                    m.running_mean.uniform_(-0.5, 0.5, generator=g)
                    m.running_var.uniform_(0.5, 2.0, generator=g)
            for head in (net.trans_out[0], net.rot_out[0]):
                head.weight.mul_(0.05)
    net = net.eval()
    mesh = rz.upload(M.make_cube(0.08), CPU)
    Kt = torch.as_tensor(k)
    gt = torch.eye(4)
    gt[:3, 3] = torch.tensor([0.01, -0.005, 0.55])
    rgb, depth = rz.render(mesh, gt, Kt, rz.full_frame_window(w, h),
                           out_hw=(h, w), cull_backfaces=True)
    rgb = rgb.to(torch.uint8)
    depth = depth.to(torch.int32)
    rgbs = torch.stack([torch.roll(rgb, i, 1) for i in range(4)])
    depths = torch.stack([torch.roll(depth, i, 1) for i in range(4)])
    cfg = trk.TrackerConfig(resolution=res, object_width_mm=110.0,
                            cull_backfaces=True)
    mean = torch.linspace(0.0, 7.0, 8)
    std = torch.linspace(90.0, 100.0, 8)
    init = torch.eye(4)
    init[:3, 3] = torch.tensor([0.0, 0.0, 0.5])
    one, _ = trk.track_step(net, cfg, mesh, Kt, mean, std, init, rgbs[1],
                            depths[1])
    hypo = torch.stack([init, gt, one])
    batch, _ = trk.track_step(net, cfg, mesh, Kt, mean, std, hypo, rgbs[2],
                              depths[2])
    video = trk.track_video(net, cfg, mesh, Kt, mean, std, init, rgbs, depths)
    return torch.cat([one[None], batch, video]).numpy()
