"""The port's object ensembles and batched videos on one device
(``parallel/spmd.py``, ``data/dataset.ensemble_synth_batch``) against the
JAX package's, and against the port's own single-object paths.

JAX against the port (the JAX functions on the CPU, jitted, with the Pallas
kernels in interpret mode; weights carried across by
``models/convert.state_dict_from_jax``; ROADMAP F7: the random draws are
JAX's, rebuilt from its keys and injected):

  - ``multi_object_track_videos`` over an icosphere and a cube (widths 110
    and 150 mm, as ``tests/test_parallel.py``), regression heads x0.05 so
    the poses move: the port's serial and batched runs against JAX's, per
    frame within 5e-4 m and 5e-3 rad (the ``track_video`` bars of
    ``tests/test_torch_tracker.py``);
  - ``batched_track_videos`` over 3 videos, the same bars;
  - ``ensemble_train_step`` on the one-device layout (serial) at O = 2
    with black covers drawn from JAX's keys: losses within 1e-5 relative,
    the first step's gradients per tensor and the states after 2 steps
    under ``train/compare.py``'s bars (``tests/test_torch_train_parity.py``);
  - ``ensemble_synth_batch`` with JAX's pose draws: the poses within 1e-6,
    the quantized images within one level (or one mm) on all but 0.2% of
    pixels (JAX renders its batch under ``vmap``, which rounds apart from
    a single view, ROADMAP F13).

The port against itself: the serial ensemble is per-object ``track_video``
and ``train_step`` bit for bit; one Adam over the stacked leaves is the
per-object Adams bit for bit; ``stack_meshes`` padding leaves each object's
render as it was, and bakes textures as JAX bakes them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.core import se3 as jse3
from iros20_6d_pose_tracking_tpu.data import augment as JA
from iros20_6d_pose_tracking_tpu.data import dataset as JD
from iros20_6d_pose_tracking_tpu.models import tracknet as jnet
from iros20_6d_pose_tracking_tpu.parallel import spmd as jspmd
from iros20_6d_pose_tracking_tpu.render import mesh as JM
from iros20_6d_pose_tracking_tpu.render import rasterizer as JRz
from iros20_6d_pose_tracking_tpu.tracking import tracker as jtrk
from iros20_6d_pose_tracking_tpu.train import trainer as jtr
from iros20_6d_pose_tracking_tpu_torch.data import augment as A
from iros20_6d_pose_tracking_tpu_torch.data import dataset as D
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.models.convert import (
    state_dict_from_jax)
from iros20_6d_pose_tracking_tpu_torch.parallel import spmd
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
from iros20_6d_pose_tracking_tpu_torch.train import compare
from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

torch.set_num_threads(2)

RES = 48
K = np.array([[200.0, 0, 24.0], [0, 200.0, 24.0], [0, 0, 1.0]], np.float32)
WIDTHS = [110.0, 150.0]
T = 4


def _rot_angle(Ra, Rb):
    R = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arcsin(min(np.linalg.norm(w) / 2.0, 1.0)))


def _close_track(ours, ref):
    """Per frame within 5e-4 m and 5e-3 rad; the poses moved."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    for idx in np.ndindex(ours.shape[:-2]):
        np.testing.assert_allclose(ours[idx][:3, 3], ref[idx][:3, 3],
                                   atol=5e-4, err_msg=str(idx))
        assert _rot_angle(ours[idx][:3, :3], ref[idx][:3, :3]) < 5e-3, idx


@pytest.fixture(scope="module")
def scene():
    """Two objects' Flax variables (heads x0.05), their port networks, the
    meshes, 4-frame videos of each object at a pose off the start, and the
    JAX tracking config."""
    model = jnet.create_model(RES)
    variables, nets = [], []
    for i in range(2):
        v = jax.tree.map(np.asarray, jnet.init_variables(
            model, jax.random.PRNGKey(i)))
        for head in ("trans_out", "rot_out"):
            v["params"][head]["kernel"] = v["params"][head]["kernel"] * 0.05
            v["params"][head]["bias"] = v["params"][head]["bias"] * 0.0
        variables.append(v)
        net = tracknet.create_model(RES)
        net.load_state_dict(state_dict_from_jax(v), strict=True)
        nets.append(net.eval())
    jtms = [JM.make_icosphere(subdiv=2, radius=0.05), JM.make_cube(0.08)]
    tms = [M.make_icosphere(subdiv=2, radius=0.05), M.make_cube(0.08)]
    init = np.eye(4, dtype=np.float32)
    init[2, 3] = 0.5
    seen = init.copy()
    seen[:3, 3] = [0.004, -0.003, 0.51]
    videos = []
    for jtm in jtms:
        rgb, depth = JRz.render(JRz.upload(jtm), jnp.asarray(seen),
                                jnp.asarray(K), JRz.full_frame_window(48, 48),
                                out_hw=(48, 48), impl="pallas_interpret")
        videos.append((np.stack([np.asarray(rgb).round().astype(np.uint8)]
                                * T),
                       np.stack([np.asarray(depth).round().astype(np.uint16)]
                                * T)))
    jcfg = jtrk.TrackerConfig(resolution=RES, render_impl="pallas_interpret",
                              fuse_pass2=True)
    return dict(model=model, variables=variables, nets=nets, jtms=jtms,
                tms=tms, init=init, videos=videos, jcfg=jcfg,
                cfg=trk.TrackerConfig(resolution=RES))


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


@pytest.fixture(scope="module")
def jax_multi(scene):
    s = scene
    mesh1 = jspmd.make_mesh(1, obj=1)
    run = jspmd.multi_object_track_videos(s["model"], s["jcfg"], mesh1)
    with mesh1:
        poses = run(_stack(s["variables"]), jspmd.stack_meshes(s["jtms"]),
                    jnp.asarray(K), jnp.zeros(8), jnp.full(8, 100.0),
                    jnp.asarray(np.stack([s["init"]] * 2)),
                    jnp.asarray(np.stack([v[0] for v in s["videos"]])),
                    jnp.asarray(np.stack([v[1] for v in s["videos"]])),
                    jnp.asarray(WIDTHS))
    return np.asarray(poses)


def _port_multi(s, serial):
    ens = spmd.stack_states(s["nets"])
    run = spmd.multi_object_track_videos(ens.model, s["cfg"],
                                         spmd.make_mesh(1), serial=serial)
    return run(ens, spmd.stack_meshes(s["tms"], "cpu"), torch.from_numpy(K),
               torch.zeros(8), torch.full((8,), 100.0),
               torch.from_numpy(np.stack([s["init"]] * 2)),
               trk.upload_rgb(np.stack([v[0] for v in s["videos"]]), "cpu"),
               trk.upload_depth(np.stack([v[1] for v in s["videos"]]), "cpu"),
               WIDTHS)


@pytest.mark.parametrize("serial", [True, False], ids=["serial", "batched"])
def test_multi_object_track_videos_matches_jax(scene, jax_multi, serial):
    poses = _port_multi(scene, serial)
    assert poses.shape == (2, T, 4, 4)
    moved = np.linalg.norm(jax_multi[:, -1, :3, 3] - scene["init"][:3, 3],
                           axis=-1)
    assert moved.min() > 1e-3
    _close_track(poses.numpy(), jax_multi)


def test_serial_multi_object_is_per_object_track_video(scene, monkeypatch):
    """Serial is a loop of ``track_video``: bit for bit, object by object,
    on each object's slice of the stacked meshes. Batched, a frame is one
    launch of K1 and one of ``pass2_shade`` over the objects' views."""
    from iros20_6d_pose_tracking_tpu_torch.render import raster_kernels as rk

    s = scene
    meshes = spmd.stack_meshes(s["tms"], "cpu")
    poses = _port_multi(s, True)
    for o in range(2):
        ref = trk.track_video(
            s["nets"][o], s["cfg"], rz.mesh_of(meshes, o),
            torch.from_numpy(K), torch.zeros(8), torch.full((8,), 100.0),
            torch.from_numpy(s["init"]),
            trk.upload_rgb(s["videos"][o][0], "cpu"),
            trk.upload_depth(s["videos"][o][1], "cpu"), WIDTHS[o])
        assert torch.equal(poses[o], ref)
    calls = []
    for name in ("pass1_winners", "pass2_shade"):
        def counted(*a, _fn=getattr(rk, name), _name=name, **kw):
            calls.append((_name, a[0].shape[0]))
            return _fn(*a, **kw)

        monkeypatch.setattr(rk, name, counted)
    _port_multi(s, False)
    assert calls == [("pass1_winners", 2), ("pass2_shade", 2)] * T


def test_batched_track_videos_matches_jax(scene):
    s = scene
    inits = np.stack([s["init"]] * 3)
    inits[:, 0, 3] = [-0.004, 0.0, 0.004]
    rgb = np.stack([s["videos"][1][0]] * 3)
    depth = np.stack([s["videos"][1][1]] * 3)
    mesh1 = jspmd.make_mesh(1, obj=1)
    jcfg = jtrk.TrackerConfig(resolution=RES, object_width_mm=150.0,
                              render_impl="pallas_interpret", fuse_pass2=True)
    with mesh1:
        ref = jspmd.batched_track_videos(s["model"], jcfg, mesh1)(
            s["variables"][1], JRz.upload(s["jtms"][1]), jnp.asarray(K),
            jnp.zeros(8), jnp.full(8, 100.0), jnp.asarray(inits),
            jnp.asarray(rgb), jnp.asarray(depth))
    run = spmd.batched_track_videos(
        s["nets"][1], trk.TrackerConfig(resolution=RES, object_width_mm=150.0),
        spmd.make_mesh(1))
    poses = run(rz.upload(s["tms"][1], "cpu"), torch.from_numpy(K),
                torch.zeros(8), torch.full((8,), 100.0),
                torch.from_numpy(inits), trk.upload_rgb(rgb, "cpu"),
                trk.upload_depth(depth, "cpu"))
    assert poses.shape == (3, T, 4, 4)
    _close_track(poses.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

TRAIN_RES = 32
N = 4
LR = 1e-5
STEPS = 2
COVER = dict(hsv_prob=0.0, noise_prob=0.0, blur_prob=0.0,
             black_cover_prob=1.0, bright_mag=(1.0, 1.0))
MEAN = np.array([120, 110, 100, 0, 120, 110, 100, 0], np.float32)
STD = np.array([70, 70, 70, 300, 70, 70, 70, 300], np.float32)


def _jax_cover_draws(key, n, cfg, hw):
    """JAX's black-cover draws of ``augment_batch(key, ...)`` (one key a
    sample, as JAX splits it) as the port's draw dict for n samples; the
    other transforms are off (their draws are placeholders)."""
    H, W = hw
    per = []
    for k in jax.random.split(key, n):
        _, _, _, _, k5, _ = jax.random.split(k, 6)
        kg, kc = jax.random.split(k5)
        cand = [jax.random.split(c, 3)
                for c in jax.random.split(kc, cfg.black_cover_tries)]
        per.append({
            "apply": bool(jax.random.uniform(kg) < cfg.black_cover_prob),
            "cu": [int(jax.random.randint(c[0], (), 0, W)) for c in cand],
            "cv": [int(jax.random.randint(c[1], (), 0, H)) for c in cand],
            "quad": [int(jax.random.randint(c[2], (), 0, 4)) for c in cand]})
    d = A.draw_augment(torch.Generator().manual_seed(0), n, hw,
                       A.AugmentConfig(**COVER), "cpu")
    d["black_cover"] = {k: torch.tensor([p[k] for p in per])
                        for k in per[0]}
    return d


def _raw(seed, *lead):
    rng = np.random.RandomState(seed)
    n = int(np.prod(lead))
    A_in = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    A_in[:, :3, 3] = rng.uniform([-0.05, -0.05, 0.45], [0.05, 0.05, 0.7],
                                 (n, 3))
    dB = np.asarray(jse3.random_gaussian_magnitude(
        jax.random.PRNGKey(seed), 0.02, 15.0, (n,)))
    B_in = np.einsum("nij,njk->nik", A_in, dB).astype(np.float32)
    depth = rng.uniform(300, 900, (2, n, TRAIN_RES, TRAIN_RES))
    depth[rng.rand(*depth.shape) < 0.3] = 0.0
    raw = {"rgbA": rng.uniform(0, 255, (n, TRAIN_RES, TRAIN_RES, 3)),
           "depthA": depth[0],
           "rgbB": rng.uniform(0, 255, (n, TRAIN_RES, TRAIN_RES, 3)),
           "depthB": depth[1], "maskB": depth[1] > 100,
           "A_in_cam": A_in, "B_in_cam": B_in}
    return {k: (v.astype(np.float32) if v.dtype == np.float64 else v
                ).reshape(lead + v.shape[1:]) for k, v in raw.items()}


def _jax_grads(model, jcfg):
    """``(variables, key, raw) ->`` JAX's first-step gradients of the train
    loss, as a state_dict of the port's names (one compile)."""
    @jax.jit
    def grads(params, batch_stats, key, raw):
        bufA, bufB, t_label, r_label = jtr.preprocess_batch(
            key, raw, jnp.asarray(MEAN), jnp.asarray(STD), jcfg, train=True)

        def loss(p):
            out, _ = model.apply({"params": p, "batch_stats": batch_stats},
                                 bufA, bufB, train=True,
                                 mutable=["batch_stats"])
            return jnet.loss_fn(out["trans"], out["rot"], t_label,
                                r_label)[0]

        return jax.grad(loss)(params)

    names = [n for n, _ in tracknet.create_model(TRAIN_RES).named_parameters()]

    def fn(variables, key, raw):
        g = jax.tree.map(np.asarray, grads(variables["params"],
                                           variables["batch_stats"], key,
                                           raw))
        sd = state_dict_from_jax({"params": g,
                                  "batch_stats": variables["batch_stats"]})
        return {k: sd[k] for k in names}

    return fn


def test_ensemble_train_step_matches_jax():
    O = 2
    jcfg = jtr.TrainConfig(resolution=TRAIN_RES, batch_size=N,
                           learning_rate=LR, aug=JA.AugmentConfig(**COVER))
    cfg = tr.TrainConfig(resolution=TRAIN_RES, batch_size=N, learning_rate=LR,
                         aug=A.AugmentConfig(**COVER))
    model = jnet.create_model(TRAIN_RES)
    tx, _ = jtr.make_optimizer(jcfg, steps_per_epoch=1000)
    states = [jtr.create_train_state(model, jcfg, tx, jax.random.PRNGKey(i))
              for i in range(O)]
    variables = [jax.tree.map(np.asarray, {"params": st.params,
                                           "batch_stats": st.batch_stats})
                 for st in states]
    raw = _raw(3, O, N)
    keys = [jax.random.split(jax.random.PRNGKey(40 + i), O)
            for i in range(STEPS)]
    jax_grads = _jax_grads(model, jcfg)
    jgrads = [jax_grads(variables[o], keys[0][o],
                        {k: v[o] for k, v in raw.items()}) for o in range(O)]
    mesh1 = jspmd.make_mesh(1, obj=1)
    jstep = jspmd.ensemble_train_step(model, tx, jcfg, mesh1)
    ens_j = jspmd.stack_states(states)
    jlosses = []
    with mesh1:
        for i in range(STEPS):
            ens_j, m = jstep(ens_j, keys[i], raw, jnp.asarray(MEAN),
                             jnp.asarray(STD))
            jlosses.append(np.asarray(m["loss"]))

    pairs = []
    for v in variables:
        net = tracknet.create_model(TRAIN_RES)
        net.load_state_dict(state_dict_from_jax(v), strict=True)
        pairs.append((net, tr.make_optimizer(net, cfg, 1000)[0]))
    ens = spmd.stack_states(pairs)
    step = spmd.ensemble_train_step(ens.model, ens.opt, cfg,
                                    spmd.make_mesh(1))
    grads = None
    for i in range(STEPS):
        draws = [_jax_cover_draws(keys[i][o], N, jcfg.aug,
                                  (TRAIN_RES, TRAIN_RES)) for o in range(O)]
        m = step(ens, LR, None, raw, torch.from_numpy(MEAN),
                 torch.from_numpy(STD), aug_draws=draws)
        np.testing.assert_allclose(m["loss"].numpy(), jlosses[i], rtol=1e-5)
        if i == 0:
            grads = {k: v.grad.clone() for k, v in ens.params.items()}
    net = pairs[0][0]
    for o in range(O):
        g = {k: v[o] for k, v in grads.items()}
        report = compare.compare_grads(net, g, jgrads[o])
        assert {k: n for k, (n, _, _) in report.items()} == {
            "grad": 55, "conv_bias_grad": 17}, report
        assert not compare.failed(report), report
        theirs = state_dict_from_jax({
            "params": jax.tree.map(lambda x: np.asarray(x)[o], ens_j.params),
            "batch_stats": jax.tree.map(lambda x: np.asarray(x)[o],
                                        ens_j.batch_stats)})
        p, b = ens.tensors(o)
        report = compare.compare_states(
            net, {k: v.detach() for k, v in {**p, **b}.items()}, theirs,
            compare.noisy([g], [jgrads[o]]), LR, STEPS)
        assert not compare.failed(report), report


def _train_pairs(n_obj):
    cfg = tr.TrainConfig(resolution=TRAIN_RES, batch_size=N,
                         aug=A.AugmentConfig(black_cover_prob=0.5))
    pairs = []
    for o in range(n_obj):
        net = tracknet.init_params(tracknet.create_model(TRAIN_RES),
                                   torch.Generator().manual_seed(o))
        pairs.append((net, tr.make_optimizer(net, cfg, 1000)[0]))
    return cfg, pairs


def test_serial_ensemble_step_is_per_object_train_step():
    """Two steps of the serial ensemble (on the one-device layout) give
    the bits of two ``train_step`` calls an object; the batched step stays
    within Adam's noise of them (F12: compare.py's bars)."""
    O = 2
    raw = {k: torch.from_numpy(v) for k, v in _raw(5, O, N).items()}
    cfg, per = _train_pairs(O)
    mean, std = torch.from_numpy(MEAN), torch.from_numpy(STD)
    for i in range(STEPS):
        for o, (net, opt) in enumerate(per):
            tr.train_step(net, opt, 1e-3, cfg, tr.step_generator("cpu", i, o),
                          {k: v[o] for k, v in raw.items()}, mean, std)
    for serial in (True, False):
        _, pairs = _train_pairs(O)
        ens = spmd.stack_states(pairs)
        step = spmd.ensemble_train_step(ens.model, ens.opt, cfg,
                                        spmd.make_mesh(1), serial=serial)
        for i in range(STEPS):
            m = step(ens, 1e-3, [tr.step_generator("cpu", i, o)
                                 for o in range(O)], raw, mean, std)
            assert m["loss"].shape == (O,) and torch.isfinite(m["loss"]).all()
        for o, (net, _) in enumerate(per):
            p, b = ens.tensors(o)
            mine = {k: v.detach() for k, v in {**p, **b}.items()}
            if serial:
                for k, v in net.state_dict().items():
                    assert torch.equal(v, mine[k]), k
            else:
                for k, v in net.state_dict().items():
                    if v.dtype.is_floating_point:
                        np.testing.assert_allclose(
                            mine[k].numpy(), v.numpy(), atol=2 * 1e-3 * STEPS,
                            err_msg=k)


def test_stacked_adam_is_per_object_adam():
    """One Adam over the stacked leaves, fed the per-object gradients,
    steps each object exactly as that object's own Adam (3 steps, weight
    decay on)."""
    cfg, pairs = _train_pairs(2)
    ens = spmd.stack_states(pairs)
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        for name, p in ens.params.items():
            g = torch.randn(p.shape, generator=gen) * 1e-3
            p.grad = g.clone()
            for o, (net, _) in enumerate(pairs):
                dict(net.named_parameters())[name].grad = g[o].clone()
        ens.opt.step()
        for _, opt in pairs:
            opt.step()
    for o, (net, _) in enumerate(pairs):
        for name, p in net.named_parameters():
            assert torch.equal(p.detach(), ens.params[name][o].detach()), name


# ---------------------------------------------------------------------------
# Meshes and the synthetic batches.
# ---------------------------------------------------------------------------

def test_stack_meshes_pads_and_bakes_as_jax():
    """Faces padded to the largest object (``fmask`` False on the padding),
    the textured box baked to vertex colours: the stacked arrays equal
    JAX's ``stack_meshes``; and each object's render from the stack (its
    padded slice) is its own mesh's render, bit for bit, at a pose where
    the face-block choice differs."""
    names = ("make_icosphere", "make_cube", "make_textured_box")
    kwargs = ({"subdiv": 2, "radius": 0.05}, {"size": 0.08}, {})
    tms = [getattr(M, n)(**kw) for n, kw in zip(names, kwargs)]
    jtms = [getattr(JM, n)(**kw) for n, kw in zip(names, kwargs)]
    ours = spmd.stack_meshes(tms, "cpu")
    theirs = jspmd.stack_meshes(jtms)
    assert ours.fverts.shape == (3, 512, 3, 3)
    assert ours.fuvs is None and ours.texture is None
    for f in ("fverts", "fcolors", "fnormals", "fmask"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(theirs, f)), f)
    assert int(ours.fmask[1].sum()) == 12
    pose = torch.eye(4)
    pose[:3, 3] = torch.tensor([0.003, -0.002, 0.45])
    pose[:3, :3] = torch.linalg.matrix_exp(torch.tensor(
        [[0.0, -0.3, 0.2], [0.3, 0.0, -0.4], [-0.2, 0.4, 0.0]]))
    Kt = torch.from_numpy(K)
    win = rz.full_frame_window(48, 48)
    for o in range(2):
        own = rz.render(rz.upload(tms[o], "cpu"), pose, Kt, win,
                        out_hw=(48, 48))
        stacked = rz.render(rz.mesh_of(ours, o), pose, Kt, win,
                            out_hw=(48, 48))
        assert (own[1] > 0).sum() > 200
        for a, b in zip(own, stacked):
            assert torch.equal(a, b)
    views = rz.render(ours, torch.stack([pose] * 3), Kt,
                      torch.tensor([win] * 3), out_hw=(48, 48))
    for o in range(3):
        one = rz.render(rz.mesh_of(ours, o), pose, Kt, win, out_hw=(48, 48))
        for a, b in zip(one, views):
            assert torch.equal(a, b[o])


def _jax_synth_draws(key, n):
    """The draws of JAX's ``_synth_batch_impl(key, ...)`` as the port's
    ``draw_synth`` dict (F7)."""
    kr, kt, kp = jax.random.split(key, 3)

    def direction(k):
        k1, k2 = jax.random.split(k)
        return {"u_theta": jax.random.uniform(k1, (n,)),
                "u_phi": jax.random.uniform(k2, (n,))}

    k1, k2, k3, k4 = jax.random.split(kp, 4)
    d = {"dir_B": direction(kr),
         "angle_B": jax.random.uniform(jax.random.fold_in(kr, 1), (n, 1),
                                       minval=0.0, maxval=np.pi),
         "t_B": jax.random.uniform(kt, (n, 3)),
         "pert": {"dir_t": direction(k1),
                  "mag_t": jax.random.truncated_normal(k2, -1.0, 1.0, (n,)),
                  "dir_r": direction(k3),
                  "mag_r": jax.random.truncated_normal(k4, -1.0, 1.0, (n,))}}
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), d)


def test_ensemble_synth_batch_matches_jax():
    n, res = 2, 32
    xyz = ((-0.05, 0.05), (-0.05, 0.05), (0.45, 0.65))
    jtms = [JM.make_icosphere(subdiv=1, radius=0.05), JM.make_cube(0.08)]
    tms = [M.make_icosphere(subdiv=1, radius=0.05), M.make_cube(0.08)]
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    ref = JD.ensemble_synth_batch(
        jspmd.stack_meshes(jtms), jnp.asarray(K), keys, jnp.asarray(WIDTHS),
        n, res, 0.02, 15.0, xyz, None, "pallas_interpret")
    ref = {k: np.asarray(v) for k, v in ref.items()}
    ours = D.ensemble_synth_batch(
        spmd.stack_meshes(tms, "cpu"), torch.from_numpy(K), None, WIDTHS, n,
        res, 0.02, 15.0, xyz, draws=[_jax_synth_draws(k, n) for k in keys])
    assert ours["rgbA"].shape == (2, n, res, res, 3)
    assert ours["rgbA"].dtype == torch.uint8
    assert ours["depthB"].dtype == torch.int32
    for k in ("A_in_cam", "B_in_cam"):
        np.testing.assert_allclose(ours[k].numpy(), ref[k], atol=1e-6)
    for k in ("rgbA", "rgbB", "depthA", "depthB"):
        a = ours[k].numpy().astype(np.int64)
        b = ref[k].astype(np.int64)
        assert ((a > 0) != (b > 0)).mean() < 2e-3, k
        assert (np.abs(a - b) > 1).mean() < 2e-3, k
        assert (b > 0).mean() > 0.05, k
    assert (ours["maskB"].numpy() != ref["maskB"]).mean() < 2e-3
