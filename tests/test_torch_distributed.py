"""The port's scale-out layer across ranks: ``torch.distributed`` with gloo
on the CPU, 2 and 4 ranks, each a process spawned with a ``file://``
rendezvous in the test's temporary directory (``tests/torch_dist_workers.py``;
the process group and the join each have a timeout, so a hang fails the
test in about a minute).

  - ``dp_train_step`` on 2 ranks against ``trainer.train_step`` on the
    whole batch, both fed the same augmentation draws (every rank applies
    its rows of the whole batch's draws): the losses, the first step's
    gradients and the state after two steps under ``train/compare.py``'s
    bars (those of ``tests/test_torch_train_parity.py``), and the two
    ranks' states bit-equal (replicated);
  - ``ensemble_train_step`` on 4 ranks as (obj 2, dp 2), serial and
    batched, against one ``train_step`` an object on its whole batch,
    under the same bars;
  - ``multi_object_track_videos`` (serial and batched) and
    ``batched_track_videos`` on 2 ranks against the one-rank calls;
  - ``sharded_render`` and ``sp_track_step`` on 2 and 4 ranks against the
    JAX package's ``parallel/latency.py`` on a 2- and 4-device CPU mesh
    (Pallas in interpret mode, the same tie rule across shards; jitted, so
    at the bars of tests/test_torch_raster.py's jitted render), and
    against the single render at the bars of JAX's own test
    (``tests/test_parallel.py``: depth within 0.02 mm, under 2e-3 of
    pixels more than 2 levels apart in rgb).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from iros20_6d_pose_tracking_tpu.models import tracknet as jnet
from iros20_6d_pose_tracking_tpu.ops import roi as jroi
from iros20_6d_pose_tracking_tpu.parallel import latency as jlat
from iros20_6d_pose_tracking_tpu.render import mesh as JM
from iros20_6d_pose_tracking_tpu.render import rasterizer as JRz
from iros20_6d_pose_tracking_tpu.tracking import tracker as jtrk
from iros20_6d_pose_tracking_tpu_torch.core import se3
from iros20_6d_pose_tracking_tpu_torch.data import augment as A
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.models.convert import (
    state_dict_from_jax)
from iros20_6d_pose_tracking_tpu_torch.ops import roi
from iros20_6d_pose_tracking_tpu_torch.parallel import spmd
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
from iros20_6d_pose_tracking_tpu_torch.train import compare
from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

torch.set_num_threads(2)

RES = 32
LR = 1e-5
STEPS = 2
MEAN = torch.tensor([120, 110, 100, 0, 120, 110, 100, 0], dtype=torch.float32)
STD = torch.tensor([70, 70, 70, 300, 70, 70, 70, 300], dtype=torch.float32)


def _cfg_kw(n):
    return dict(resolution=RES, batch_size=n, learning_rate=LR,
                aug=A.AugmentConfig(black_cover_prob=0.5))


def _raw(seed, *lead):
    """A raw pair batch (numpy): RGB in [0, 255], depth with holes, B within
    the normalizers of A."""
    rng = np.random.RandomState(seed)
    n = int(np.prod(lead))
    A_in_cam = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    A_in_cam[:, :3, :3] = se3.so3_exp(torch.from_numpy(
        rng.randn(n, 3).astype(np.float32))).numpy()
    A_in_cam[:, :3, 3] = rng.uniform([-0.05, -0.05, 0.45], [0.05, 0.05, 0.7],
                                     (n, 3))
    dB = se3.apply_gaussian_magnitude(se3.draw_gaussian_magnitude(
        torch.Generator().manual_seed(seed), (n,), "cpu"), 0.02, 15.0).numpy()
    B_in_cam = np.einsum("nij,njk->nik", A_in_cam, dB).astype(np.float32)
    depth = rng.uniform(300, 900, (2, n, RES, RES)).astype(np.float32)
    depth[rng.rand(*depth.shape) < 0.3] = 0.0
    raw = {"rgbA": rng.uniform(0, 255, (n, RES, RES, 3)).astype(np.float32),
           "depthA": depth[0],
           "rgbB": rng.uniform(0, 255, (n, RES, RES, 3)).astype(np.float32),
           "depthB": depth[1], "maskB": depth[1] > 100,
           "A_in_cam": A_in_cam, "B_in_cam": B_in_cam}
    return {k: torch.from_numpy(np.ascontiguousarray(v.reshape(
        lead + v.shape[1:]))) for k, v in raw.items()}


def _state(seed):
    return tracknet.init_params(tracknet.create_model(RES),
                                torch.Generator().manual_seed(seed)
                                ).state_dict()


def _reference(state, cfg, raw, draws):
    """``train_step`` on the whole batch for each step's draws: the port's
    network, the losses, the first step's gradients (as a one-step list
    for ``compare.noisy``) and the final state."""
    net = tracknet.create_model(RES)
    net.load_state_dict(state)
    opt, _ = tr.make_optimizer(net, cfg, 1000)
    losses, grads = [], None
    for i, d in enumerate(draws):
        m = tr.train_step(net, opt, LR, cfg, None, raw, MEAN, STD,
                          aug_draws=d)
        losses.append(float(m["loss"]))
        if i == 0:
            grads = compare.grads_of(net)
    return net, losses, grads, net.state_dict()


def _check(net, ref_losses, ref_grads, ref_state, losses, grads, state):
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    report = compare.compare_grads(net, grads, ref_grads)
    assert {k: n for k, (n, _, _) in report.items()} == {
        "grad": 55, "conv_bias_grad": 17}, report
    assert not compare.failed(report), report
    noise = compare.noisy([grads], [ref_grads])
    report = compare.compare_states(net, state, ref_state, noise, LR, STEPS)
    assert not compare.failed(report), report


def test_dp_train_step_on_two_ranks_equals_train_step(tmp_path):
    N = 4
    cfg = tr.TrainConfig(**_cfg_kw(N))
    raw = _raw(1, N)
    draws = [A.draw_augment(torch.Generator().manual_seed(10 + i), N,
                            (RES, RES), cfg.aug, "cpu") for i in range(STEPS)]
    state = _state(0)
    net, *ref = _reference(state, cfg, raw, draws)
    outs = W.run_ranks(2, "dp_train", {
        "cfg": _cfg_kw(N), "state": state, "raw": raw, "draws": draws,
        "lr": LR, "mean": MEAN, "std": STD}, tmp_path)
    for k, v in outs[0]["state"].items():  # replicated, bit for bit
        assert torch.equal(v, outs[1]["state"][k]), k
    assert outs[0]["losses"] == outs[1]["losses"]
    _check(net, *ref, outs[0]["losses"], outs[0]["grads"], outs[0]["state"])


def test_ensemble_train_step_on_obj2_dp2(tmp_path):
    """4 ranks as (obj 2, dp 2): each object's batch of 4 split over its
    row, object o on row o, in the serial and the batched step."""
    O, N = 2, 4
    cfg = tr.TrainConfig(**_cfg_kw(N))
    raw = _raw(2, O, N)
    draws = [[A.draw_augment(torch.Generator().manual_seed(20 + 2 * i + o), N,
                             (RES, RES), cfg.aug, "cpu") for o in range(O)]
             for i in range(STEPS)]
    states = [_state(o) for o in range(O)]
    refs = [_reference(states[o], cfg, {k: v[o] for k, v in raw.items()},
                       [d[o] for d in draws]) for o in range(O)]
    outs = W.run_ranks(4, "ensemble_train", {
        "cfg": _cfg_kw(N), "obj": 2, "states": states, "raw": raw,
        "draws": draws, "lr": LR, "mean": MEAN, "std": STD}, tmp_path,
        timeout_s=180)
    assert [o["objs"] for o in outs] == [[0], [0], [1], [1]]
    for serial in (True, False):
        losses = outs[0][serial]["losses"]
        assert all(o[serial]["losses"] == losses for o in outs)
        for r in (0, 2):  # each row's first rank
            o = outs[r]["objs"][0]
            res = outs[r][serial]
            p = {k: v[0] for k, v in res["params"].items()}
            b = {k: v[0] for k, v in res["buffers"].items()}
            net, ref_losses, ref_grads, ref_state = refs[o]
            _check(net, ref_losses, ref_grads, ref_state,
                   [step[o] for step in losses],
                   {k: v[0] for k, v in res["grads"].items()}, {**p, **b})
            mate = outs[r + 1][serial]  # the row's other rank: replicated
            for k, v in res["params"].items():
                assert torch.equal(v, mate["params"][k]), (serial, k)


def _tracking_nets(n):
    nets = []
    for i in range(n):
        net = tracknet.init_params(tracknet.create_model(48),
                                   torch.Generator().manual_seed(i))
        with torch.no_grad():
            for head in (net.trans_out, net.rot_out):
                head[0].weight.mul_(0.05)
                head[0].bias.zero_()
        nets.append(net.eval())
    return nets


def test_tracking_on_two_ranks_equals_one(tmp_path):
    """Two objects split over 2 ranks ("obj"), and 4 videos over 2 ranks:
    the poses the one-rank calls give, serial bit for bit."""
    K = torch.tensor([[200.0, 0, 24.0], [0, 200.0, 24.0], [0, 0, 1.0]])
    pose = torch.eye(4)
    pose[2, 3] = 0.5
    tms = [M.make_icosphere(subdiv=2, radius=0.05), M.make_cube(0.08)]
    frames = [rz.render(rz.upload(tm, "cpu"), pose, K,
                        rz.full_frame_window(48, 48), out_hw=(48, 48))
              for tm in tms]
    rgb = torch.stack([torch.stack([f[0]] * 3) for f in frames]).round()
    depth = torch.stack([torch.stack([f[1]] * 3) for f in frames]).round()
    rgb, depth = rgb.to(torch.uint8), depth.to(torch.int32)
    v_init = torch.stack([pose] * 4)
    v_init[:, 0, 3] = torch.tensor([-0.004, 0.0, 0.002, 0.004])
    nets = _tracking_nets(2)
    inp = {"cfg": dict(resolution=48, object_width_mm=150.0),
           "obj": 2, "states": [n.state_dict() for n in nets], "tms": tms,
           "K": K, "mean": torch.zeros(8), "std": torch.full((8,), 100.0),
           "init": torch.stack([pose, pose]), "rgb": rgb, "depth": depth,
           "widths": [110.0, 150.0], "v_init": v_init,
           "v_rgb": torch.stack([rgb[1]] * 4),
           "v_depth": torch.stack([depth[1]] * 4)}
    outs = W.run_ranks(2, "track", inp, tmp_path / "two")
    # the one-rank run in a rank process too: the same thread count, so the
    # serial poses can be held bit for bit
    one = W.run_ranks(1, "track", dict(inp, obj=1), tmp_path / "one")[0]
    for out in outs:
        for serial in (True, False):
            got = out[serial]
            assert got.shape == (2, 3, 4, 4)
            if serial:
                assert torch.equal(got, one[serial])
            else:
                np.testing.assert_allclose(got.numpy(), one[serial].numpy(),
                                           atol=1e-5)
        np.testing.assert_allclose(out["videos"].numpy(),
                                   one["videos"].numpy(), atol=1e-5)
    moved = (one["videos"][:, -1, :3, 3] - v_init[:, :3, 3]).norm(dim=-1)
    assert moved.min() > 1e-3


@pytest.fixture(scope="module")
def sp_scene():
    """A 1,280-face icosphere in a 48^2 ROI, a Flax network and its port
    copy, and the frame the single render gives."""
    res = 48
    K = np.array([[200.0, 0, 24.0], [0, 200.0, 24.0], [0, 0, 1.0]],
                 np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.002, -0.001, 0.5]
    tm = JM.make_icosphere(subdiv=3, radius=0.05)
    model = jnet.Se3TrackNet(image_size=res)
    variables = jax.tree.map(np.asarray, jnet.init_variables(
        model, jax.random.PRNGKey(0)))
    jcfg = jtrk.TrackerConfig(resolution=res, object_width_mm=150.0,
                              render_impl="pallas_interpret",
                              fuse_pass2=True)
    frame = JRz.render(JRz.upload(tm), jnp.asarray(pose), jnp.asarray(K),
                       JRz.full_frame_window(48, 48), out_hw=(48, 48),
                       impl="pallas_interpret")
    return dict(res=res, K=K, pose=pose, tm=tm, model=model,
                variables=variables, jcfg=jcfg,
                frame=tuple(np.array(f) for f in frame))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_render_and_step_match_jax(sp_scene, n, tmp_path):
    s = sp_scene
    K, pose = jnp.asarray(s["K"]), jnp.asarray(s["pose"])
    mean, std = np.zeros(8, np.float32), np.full(8, 100.0, np.float32)
    spm = jlat.sp_mesh(n)
    smesh = jlat.shard_mesh_faces(JRz.upload(s["tm"]), spm)
    bbox = jroi.compute_bbox(pose, K, 150.0, (1000.0, 1000.0, 1000.0))
    with spm:
        j_rgb, j_depth = jax.jit(jlat.sharded_render(s["jcfg"], spm))(
            smesh.fverts, smesh.fcolors, smesh.fnormals, smesh.fmask, pose,
            K, bbox)
        j_pose = jlat.sp_track_step(s["model"], s["jcfg"], spm)(
            s["variables"], smesh, K, jnp.asarray(mean), jnp.asarray(std),
            pose, jnp.asarray(s["frame"][0]), jnp.asarray(s["frame"][1]))
    tm = M.make_icosphere(subdiv=3, radius=0.05)
    outs = W.run_ranks(n, "sharded", {
        "cfg": dict(resolution=s["res"], object_width_mm=150.0), "tm": tm,
        "K": torch.from_numpy(s["K"]), "pose": torch.from_numpy(s["pose"]),
        "state": state_dict_from_jax(s["variables"]),
        "mean": torch.from_numpy(mean), "std": torch.from_numpy(std),
        "frame_rgb": torch.from_numpy(s["frame"][0]),
        "frame_depth": torch.from_numpy(s["frame"][1])}, tmp_path)
    assert {o["faces"] for o in outs} == {1024}
    for o in outs[1:]:  # every rank holds the whole result
        assert torch.equal(o["rgb"], outs[0]["rgb"])
        assert torch.equal(o["depth"], outs[0]["depth"])
        assert torch.equal(o["pose"], outs[0]["pose"])
    rgb, depth = outs[0]["rgb"].numpy(), outs[0]["depth"].numpy()
    assert (depth > 0).sum() > 500
    # against JAX's sharded render, jitted: the bars of
    # tests/test_torch_raster.py's jitted render (XLA's FMA contraction
    # moves shared-edge ties, ROADMAP F9)
    j_depth, j_rgb = np.asarray(j_depth), np.asarray(j_rgb)
    assert ((depth > 0) != (j_depth > 0)).mean() < 1e-3
    both = (depth > 0) & (j_depth > 0)
    np.testing.assert_allclose(depth[both], j_depth[both], rtol=2e-3)
    assert (np.abs(rgb - j_rgb).max(-1) > 2.0).mean() < 1e-3
    np.testing.assert_allclose(outs[0]["pose"].numpy(), np.asarray(j_pose),
                               atol=1e-5)
    # against the single render, at the bars of JAX's test
    tpose, tK = torch.from_numpy(s["pose"]), torch.from_numpy(s["K"])
    tbbox = roi.compute_bbox(tpose, tK, 150.0, (1000.0, 1000.0, 1000.0))
    ref_rgb, ref_depth = rz.render(rz.upload(tm, "cpu"), tpose, tK,
                                   rz.window_from_bbox(tbbox),
                                   out_hw=(s["res"], s["res"]))
    np.testing.assert_allclose(depth, ref_depth.numpy(), atol=0.02)
    bad = np.abs(rgb - ref_rgb.numpy()).max(-1) > 2.0
    assert bad.mean() < 2e-3
