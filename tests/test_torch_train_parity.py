"""The port's training pieces against the JAX package: BatchNorm's train-mode
statistics (ROADMAP F11), Flax's initialisers, the label codec, the
preprocessing, losses, the learning-rate schedule, the mean/std pass and
train steps from the same weights on the same batch.

Train steps cannot match bit for bit: the convolutions sum in another
order than XLA's, and Adam's first steps move each weight by about
lr * sign(g), so an element whose gradient is within rounding noise of 0
steps by +lr in one package and -lr in the other (ROADMAP F12). The bars
are ``train/compare.py``'s defaults, with the count of tensors under each
(the full network: 17 convolutions, 2 dense heads, 17 BatchNorms):

  - per-step loss within 1e-5 relative (measured 2.9e-6);
  - the first step's gradients, before Adam, tensor by tensor (55): the L2
    norm of the difference within 1e-4 of the tensor's (measured 7.6e-6);
  - conv biases (17): each feeds a train-mode BatchNorm, so its gradient is
    0 in exact arithmetic; on both sides within 1e-5 of the max |gradient|
    of the conv's kernel (measured 7.4e-7); after Adam within 2 lr per step;
  - every other parameter tensor (55): elements whose gradients lay within
    1% of JAX's at every step, all but 0.1% within 2e-5 relative after the
    steps (measured 0 after 3 steps at lr 1e-5, 2.7e-5 after one at 1e-3);
  - BatchNorm running variances (17) within 1e-5 relative (measured
    2.7e-6), running means (17) within 1e-5 relative + 2e-5 (measured
    3.6e-6 absolute).

``chip_smoke.py`` holds the card against the CPU path with the same
functions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.core import se3 as jse3
from iros20_6d_pose_tracking_tpu.data import augment as JA
from iros20_6d_pose_tracking_tpu.models import tracknet as jnet
from iros20_6d_pose_tracking_tpu.train import trainer as jtr
from iros20_6d_pose_tracking_tpu_torch.core import se3
from iros20_6d_pose_tracking_tpu_torch.data import augment as A
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.models.convert import (
    state_dict_from_jax)
from iros20_6d_pose_tracking_tpu_torch.train import compare
from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

torch.set_num_threads(2)

RES = 48
N = 4
STEPS = 3
IDENTITY = dict(hsv_prob=0.0, noise_prob=0.0, blur_prob=0.0,
                black_cover_prob=0.0, bright_mag=(1.0, 1.0))


def _cfgs(**kw):
    kw.setdefault("resolution", RES)
    kw.setdefault("batch_size", N)
    return (jtr.TrainConfig(aug=JA.AugmentConfig(**IDENTITY), **kw),
            tr.TrainConfig(aug=A.AugmentConfig(**IDENTITY), **kw))


def _raw_batch(seed, n=N):
    """A raw pair batch in numpy: RGB in [0, 255], depth with invalid
    pixels, B within the normalizers of A."""
    rng = np.random.RandomState(seed)
    rot = np.stack([np.asarray(jse3.so3_exp(jnp.asarray(w)))
                    for w in rng.randn(n, 3).astype(np.float32)])
    A_in_cam = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    A_in_cam[:, :3, :3] = rot
    A_in_cam[:, :3, 3] = rng.uniform([-0.05, -0.05, 0.45], [0.05, 0.05, 0.7],
                                     (n, 3))
    dB = np.asarray(jse3.random_gaussian_magnitude(
        jax.random.PRNGKey(seed), 0.02, 15.0, (n,)))
    B_in_cam = np.einsum("nij,njk->nik", A_in_cam, dB).astype(np.float32)
    depth = rng.uniform(300, 900, (2, n, RES, RES)).astype(np.float32)
    depth[rng.rand(*depth.shape) < 0.3] = 0.0
    return {"rgbA": rng.uniform(0, 255, (n, RES, RES, 3)).astype(np.float32),
            "depthA": depth[0],
            "rgbB": rng.uniform(0, 255, (n, RES, RES, 3)).astype(np.float32),
            "depthB": depth[1], "maskB": depth[1] > 100,
            "A_in_cam": A_in_cam, "B_in_cam": B_in_cam}


@pytest.fixture(scope="module")
def flax_vars():
    """The Flax model at RES and its initial variables, BatchNorm
    statistics randomised (numpy)."""
    model = jnet.create_model(RES)
    variables = jnet.init_variables(model, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    for blk in stats.values():
        for bn in blk.values():
            bn["mean"] = rng.uniform(-0.5, 0.5, bn["mean"].shape).astype(
                np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(
                np.float32)
    return model, {"params": jax.tree.map(np.asarray, variables["params"]),
                   "batch_stats": stats}


def _net(variables):
    net = tracknet.create_model(RES)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return net


def _stats_sd(variables, stats):
    """The port's state_dict keys for a Flax batch_stats tree."""
    return state_dict_from_jax({"params": variables["params"],
                                "batch_stats": jax.tree.map(np.asarray,
                                                            stats)})


def test_batchnorm_train_statistics_match_flax(flax_vars):
    """F11: one train-mode forward of the full network. Flax updates the
    running variance with the biased batch variance, torch's
    nn.BatchNorm2d with the unbiased one (x n/(n-1): 1 + 1/767 at the 24^2
    stem of this batch of 3, 1 + 1/11 at the deepest 2^2 layer). Running
    variances within 5e-6 relative, means within 1e-6 absolute (they sit
    near 0): the 1e-6 relative bar holds at the stems, and the deeper
    layers carry the convolutions' other summation order (up to 1.8e-6)."""
    model, variables = flax_vars
    rng = np.random.RandomState(1)
    a = rng.randn(3, RES, RES, 4).astype(np.float32)
    b = rng.randn(3, RES, RES, 4).astype(np.float32)
    _, mutated = model.apply(variables, jnp.asarray(a), jnp.asarray(b),
                             train=True, mutable=["batch_stats"])
    ref = _stats_sd(variables, mutated["batch_stats"])
    net = _net(variables).train()
    net(torch.from_numpy(a), torch.from_numpy(b))
    got = net.state_dict()
    n_var = 0
    for k, v in ref.items():
        if k.endswith("running_var"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=5e-6,
                                       atol=0, err_msg=k)
            n_var += 1
        elif k.endswith("running_mean"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)
    assert n_var == 17
    for k in ("convA1.1.running_var", "convB1.1.running_var"):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-6)
    # The reference's checkpoint keys are unchanged (strict load).
    assert set(got) == set(state_dict_from_jax(variables))


def test_init_params_match_flax_initialisers(flax_vars):
    """Conv and dense kernels: lecun-normal (truncated to 2 std), sample
    std within 5% of the Flax kernel's; biases exactly 0; BatchNorm scale
    1, bias 0, running mean 0, variance 1."""
    _, variables = flax_vars
    flax_sd = state_dict_from_jax(variables)
    net = tracknet.Se3TrackNet(RES)
    tracknet.init_params(net, torch.Generator().manual_seed(3))
    n_kernels = 0
    for name, p in net.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith(".weight") and p.dim() > 1:
            fan_in = p[0].numel()
            std_flax = float(flax_sd[name].std())
            assert abs(float(p.std()) / std_flax - 1) < 0.05, name
            assert float(p.abs().max()) <= 2.0 * np.sqrt(1 / fan_in) \
                / 0.87962566103423978 + 1e-6, name
            n_kernels += 1
        elif name.endswith("running_var") or (name.endswith(".weight")
                                              and p.dim() == 1):
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            assert torch.equal(p, torch.zeros_like(p)), name
    assert n_kernels == 19


def test_encode_delta_matches_jax():
    """Labels of random pairs within 1e-6 of JAX's."""
    rng = np.random.RandomState(4)
    A_in_cam = np.asarray(jse3.make_pose(
        jse3.so3_exp(jnp.asarray(rng.randn(64, 3).astype(np.float32))),
        jnp.asarray(rng.randn(64, 3).astype(np.float32) * 0.1)))
    dB = np.asarray(jse3.random_gaussian_magnitude(
        jax.random.PRNGKey(4), 0.02, 15.0, (64,)))
    B_in_cam = np.einsum("nij,njk->nik", A_in_cam, dB).astype(np.float32)
    t_j, r_j = jse3.encode_delta(jnp.asarray(A_in_cam), jnp.asarray(B_in_cam),
                                 0.02, 15 * np.pi / 180)
    t, r = se3.encode_delta(torch.from_numpy(A_in_cam),
                            torch.from_numpy(B_in_cam), 0.02,
                            15 * np.pi / 180)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j), atol=1e-6, rtol=0)


def test_so3_log_matches_jax_near_pi():
    """so3_log of the same matrices within 1e-6 rad of JAX's: generic
    angles, angles within 2e-3 of pi (both sides of the near-pi branch's
    1e-3 switch) and pi itself. (Fed the same matrix: near pi the log is
    ill-conditioned, so encode_delta's own product R_B R_A^T, rounded
    differently by the two packages, would move the result by more.)"""
    rng = np.random.RandomState(5)
    axes = rng.randn(64, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([rng.uniform(0, 3.0, 32),
                             np.pi - rng.uniform(0, 2e-3, 30), [np.pi] * 2])
    R = np.asarray(jse3.so3_exp(jnp.asarray(
        (axes * angles[:, None]).astype(np.float32))))
    ref = np.asarray(jse3.so3_log(jnp.asarray(R)))
    got = se3.so3_log(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    theta = np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1))
    assert (theta > np.pi - 1e-3).sum() >= 10  # the near-pi branch runs


def test_preprocess_eval_matches_jax():
    """preprocess_batch(train=False): buffers and labels within 1e-5."""
    jcfg, cfg = _cfgs()
    raw = _raw_batch(5)
    mean = np.linspace(10, 120, 8).astype(np.float32)
    std = np.linspace(30, 90, 8).astype(np.float32)
    ref = jtr.preprocess_batch(jax.random.PRNGKey(0), raw, jnp.asarray(mean),
                               jnp.asarray(std), jcfg, train=False)
    got = tr.preprocess_batch(None, raw, torch.from_numpy(mean),
                              torch.from_numpy(std), cfg, train=False)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5)


def test_loss_and_eval_step_match_jax(flax_vars):
    """eval_step against JAX within 1e-5 relative, and a batch padded to 4
    with n_valid=3 gives the loss of the 3 real samples (1e-6 relative)."""
    model, variables = flax_vars
    jcfg, cfg = _cfgs()
    raw = _raw_batch(6)
    mean = np.zeros(8, np.float32)
    std = np.full(8, 100.0, np.float32)
    state = jtr.TrainState(params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=None, step=0, epoch=0)
    ref = jtr.eval_step(model, jcfg, state, raw, jnp.asarray(mean),
                        jnp.asarray(std))
    net = _net(variables)
    mean_t, std_t = torch.from_numpy(mean), torch.from_numpy(std)
    got = tr.eval_step(net, cfg, raw, mean_t, std_t)
    for k in ("loss", "trans", "rot"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5)
    small = {k: v[:3] for k, v in raw.items()}
    padded = {k: np.concatenate([v[:3], v[:1]]) for k, v in raw.items()}
    a = tr.eval_step(net, cfg, small, mean_t, std_t)
    b = tr.eval_step(net, cfg, padded, mean_t, std_t, n_valid=3)
    np.testing.assert_allclose(float(b["loss"]), float(a["loss"]), rtol=1e-6)
    full = tr.eval_step(net, cfg, raw, mean_t, std_t, n_valid=N)
    np.testing.assert_allclose(float(full["loss"]), float(got["loss"]),
                               rtol=1e-6)


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_learning_rate_matches_optax(offset):
    """The scale applies at the boundary count: milestone * spe - 1, + 0,
    + 1 for each milestone, against optax's schedule."""
    spe = 7
    jcfg, cfg = _cfgs(milestones=(2, 4, 5), gamma=0.1)
    _, sched = jtr.make_optimizer(jcfg, spe)
    _, lr_at = tr.make_optimizer(torch.nn.Linear(1, 1), cfg, spe)
    for m in cfg.milestones:
        step = m * spe + offset
        np.testing.assert_allclose(lr_at(step), float(sched(step)), rtol=1e-6)


def test_compute_mean_std_matches_jax():
    """Identity augmentation: the reference statistic over 3 batches, and
    the per-sample fallback of a single batch. Means within 1e-5 relative;
    stds within 1e-5 relative plus 1e-6 of the channel's mean: the batch
    means agree to about 1e-7 relative (float32 sums in another order), and
    the std of three nearly equal batch means loses the digits they
    share."""
    jcfg, cfg = _cfgs()
    raws = [_raw_batch(10 + i) for i in range(3)]
    for k in (3, 1):
        m_j, s_j = jtr.compute_mean_std(iter(raws[:k]), jcfg,
                                        max_samples=k * N)
        m, s = tr.compute_mean_std(iter(raws[:k]), cfg, "cpu",
                                   max_samples=k * N)
        np.testing.assert_allclose(m, m_j, rtol=1e-5)
        assert (np.abs(s - s_j) <= 1e-5 * np.abs(s_j)
                + 1e-6 * np.abs(m_j)).all(), (s, s_j)
        assert (s > 0).all()


def _jax_grad_fn(model, variables, jcfg, raw, mean, std):
    """params -> JAX's gradients of the train loss on ``raw`` (identity
    augmentation), as a state_dict of the port's names."""
    bufA, bufB, t_label, r_label = jtr.preprocess_batch(
        jax.random.PRNGKey(0), raw, jnp.asarray(mean), jnp.asarray(std),
        jcfg, train=True)

    def loss(params):
        out, _ = model.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             bufA, bufB, train=True, mutable=["batch_stats"])
        return jnet.loss_fn(out["trans"], out["rot"], t_label, r_label)[0]

    grad = jax.jit(jax.grad(loss))
    names = [n for n, _ in tracknet.Se3TrackNet(RES).named_parameters()]

    def fn(params):
        sd = state_dict_from_jax({
            "params": jax.tree.map(np.asarray, grad(params)),
            "batch_stats": variables["batch_stats"]})
        return {k: sd[k] for k in names}

    return fn


def _train_both(flax_vars, lr, steps):
    """``steps`` train steps of both packages from the converted Flax
    variables on one raw batch (identity augmentation). Returns the port's
    network, the losses (port, JAX), each step's gradients (port, JAX) and
    the states after each step (port, JAX) as state_dicts."""
    model, variables = flax_vars
    jcfg, cfg = _cfgs(learning_rate=lr)
    raw = _raw_batch(7)
    mean = np.array([120, 110, 100, 0, 120, 110, 100, 0], np.float32)
    std = np.array([70, 70, 70, 300, 70, 70, 70, 300], np.float32)
    tx, _ = jtr.make_optimizer(jcfg, steps_per_epoch=1000)
    state = jtr.TrainState(params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]),
                           step=jnp.zeros((), jnp.int32),
                           epoch=jnp.zeros((), jnp.int32))
    jax_grads = _jax_grad_fn(model, variables, jcfg, raw, mean, std)
    net = _net(variables)
    opt, lr_at = tr.make_optimizer(net, cfg, steps_per_epoch=1000)
    mean_t, std_t = torch.from_numpy(mean), torch.from_numpy(std)
    losses, grads, states = [], ([], []), []
    for i in range(steps):
        grads[1].append(jax_grads(state.params))
        state, m_j = jtr.train_step(model, tx, jcfg, state,
                                    jax.random.PRNGKey(i), raw,
                                    jnp.asarray(mean), jnp.asarray(std))
        m = tr.train_step(net, opt, lr_at(i), cfg,
                          torch.Generator().manual_seed(i), raw, mean_t,
                          std_t)
        grads[0].append(compare.grads_of(net))
        losses.append((float(m["loss"]), float(m_j["loss"])))
        states.append(({k: v.clone() for k, v in net.state_dict().items()},
                       state_dict_from_jax({
                           "params": jax.tree.map(np.asarray, state.params),
                           "batch_stats": jax.tree.map(np.asarray,
                                                       state.batch_stats)})))
    return net, losses, grads, states


def _check_grads(net, grads):
    report = compare.compare_grads(net, grads[0][0], grads[1][0])
    assert {k: n for k, (n, _, _) in report.items()} == {
        "grad": 55, "conv_bias_grad": 17}, report
    assert not compare.failed(report), report


def test_train_steps_match_jax(flax_vars):
    """3 train steps against JAX train_step at lr 1e-5: losses, the first
    step's gradients and the state after 3 steps under the bars of the
    module docstring."""
    lr = 1e-5
    net, losses, grads, states = _train_both(flax_vars, lr, STEPS)
    for i, (ours, theirs) in enumerate(losses):
        np.testing.assert_allclose(ours, theirs, rtol=1e-5,
                                   err_msg=f"step {i}")
    _check_grads(net, grads)
    report = compare.compare_states(net, *states[-1],
                                    compare.noisy(*grads), lr, STEPS)
    assert {k: n for k, (n, _, _) in report.items()} == {
        "bn_mean": 17, "bn_var": 17, "conv_bias": 17,
        "param_off_share": 55, "noisy": 55}, report
    assert not compare.failed(report), report


def test_one_step_at_reference_lr_matches_jax(flax_vars):
    """Two Adam steps at the reference lr 1e-3: both losses within 1e-5
    relative (the second sees the first update), the first step's
    gradients, and the state after the first update: under 10% of each
    parameter tensor's elements noisy (measured at most 1 of 64), and under
    0.1% of the others off 2e-5 relative (measured 2.7e-5). The first Adam
    step moves every weight by about lr * sign(g); where g is within
    rounding noise of 0 the two packages step by +lr and -lr (F12)."""
    lr = 1e-3
    net, losses, grads, states = _train_both(flax_vars, lr, 2)
    for i, (ours, theirs) in enumerate(losses):
        np.testing.assert_allclose(ours, theirs, rtol=1e-5,
                                   err_msg=f"step {i}")
    _check_grads(net, grads)
    report = compare.compare_states(
        net, *states[0], compare.noisy(grads[0][:1], grads[1][:1]), lr, 1,
        noisy_share=0.1)
    assert not compare.failed(report), report


def test_float32_gradients_against_float64(flax_vars):
    """The first step's gradients of the float32 network, with the CPU's
    convolutions in oneDNN and out of it (two summation orders), against
    the same step in float64 (``tracknet.as_float64``) on the parity
    batch: every tensor but the conv biases within 1e-4 relative (L2) of
    float64's (``compare.GRAD_RTOL``; measured 4.9e-6 and 3.5e-6 at 48^2).
    ``chip_smoke.py`` holds the card's float32 gradients against float64
    at 176^2 the same way (ROADMAP F14)."""
    _, variables = flax_vars
    _, cfg = _cfgs()
    raw = _raw_batch(0)
    mean = torch.tensor([120, 110, 100, 0, 120, 110, 100, 0],
                        dtype=torch.float32)
    std = torch.tensor([70, 70, 70, 300, 70, 70, 70, 300],
                       dtype=torch.float32)

    def first_grads(net, onednn=True):
        with torch.backends.mkldnn.flags(enabled=onednn):
            opt, lr_at = tr.make_optimizer(net, cfg, steps_per_epoch=1000)
            m = tr.train_step(net, opt, lr_at(0), cfg,
                              torch.Generator().manual_seed(0), raw, mean,
                              std)
        assert m["loss"].dtype == next(net.parameters()).dtype
        return compare.grads_of(net)

    net = _net(variables)
    ref = first_grads(tracknet.as_float64(net))
    for onednn in (True, False):
        d = compare.distances(net, first_grads(_net(variables), onednn), ref)
        assert len(d) == 55
        assert max(d.values()) < compare.GRAD_RTOL, (onednn, d)
