"""Se3TrackNet of the PyTorch port against the Flax model, with the Flax
variables carried across by ``models.convert.state_dict_from_jax``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.models import torch_import
from iros20_6d_pose_tracking_tpu.models import tracknet as jnet
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.models.convert import (
    state_dict_from_jax)

from test_model import _build_torch_model

torch.set_num_threads(2)

RES = 176


def _randomize_batch_stats(variables, rng):
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    for blk in stats.values():
        for bn in blk.values():
            bn["mean"] = rng.uniform(-0.5, 0.5, bn["mean"].shape).astype(
                np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(
                np.float32)
    return {"params": jax.tree.map(np.asarray, variables["params"]),
            "batch_stats": stats}


@pytest.fixture(scope="module")
def flax_model_and_vars():
    model = jnet.create_model(RES)
    variables = jnet.init_variables(model, jax.random.PRNGKey(0))
    return model, _randomize_batch_stats(variables, np.random.RandomState(0))


def test_forward_matches_flax(flax_model_and_vars):
    """trans/rot within 2e-5 and the NHWC feature within 1e-4 at 176^2 and
    batch 2 (the bar of tests/test_model.py): the convolutions sum in
    another order than XLA's."""
    model, variables = flax_model_and_vars
    net = tracknet.create_model(RES)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    net.eval()
    rng = np.random.RandomState(1)
    A = rng.randn(2, RES, RES, 4).astype(np.float32)
    B = rng.randn(2, RES, RES, 4).astype(np.float32)
    ref = model.apply(variables, jnp.asarray(A), jnp.asarray(B), train=False)
    with torch.no_grad():
        out = net(torch.from_numpy(A), torch.from_numpy(B))
    assert out["feature"].shape == (2, 22, 22, 256)
    np.testing.assert_allclose(out["trans"].numpy(), np.asarray(ref["trans"]),
                               atol=2e-5)
    np.testing.assert_allclose(out["rot"].numpy(), np.asarray(ref["rot"]),
                               atol=2e-5)
    np.testing.assert_allclose(out["feature"].numpy(),
                               np.asarray(ref["feature"]), atol=1e-4)


def test_reference_state_dict_loads_strict():
    """The reference architecture's own state_dict (the oracle of
    tests/test_model.py) loads with strict=True and gives the same
    outputs."""
    torch.manual_seed(0)
    oracle = _build_torch_model().eval()
    net = tracknet.Se3TrackNet().eval()
    assert set(net.state_dict()) == set(oracle.state_dict())
    net.load_state_dict(oracle.state_dict(), strict=True)
    rng = np.random.RandomState(2)
    A = rng.randn(1, 64, 64, 4).astype(np.float32)
    B = rng.randn(1, 64, 64, 4).astype(np.float32)
    with torch.no_grad():
        t_o, r_o = oracle(torch.from_numpy(A.transpose(0, 3, 1, 2)),
                          torch.from_numpy(B.transpose(0, 3, 1, 2)))
        out = net(torch.from_numpy(A), torch.from_numpy(B))
    torch.testing.assert_close(out["trans"], t_o, rtol=0, atol=1e-6)
    torch.testing.assert_close(out["rot"], r_o, rtol=0, atol=1e-6)


def test_state_dict_from_jax_round_trip(flax_model_and_vars):
    _, variables = flax_model_and_vars
    sd = state_dict_from_jax(variables)
    back = torch_import.state_dict_to_variables(sd)
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, leaf)
    assert all(v.dtype == torch.float32 for k, v in sd.items()
               if not k.endswith("num_batches_tracked"))


def test_loss_fn_matches_jax():
    rng = np.random.RandomState(3)
    pt, pr, tt, tr = rng.randn(4, 5, 3).astype(np.float32)
    w = (rng.rand(5) > 0.3).astype(np.float32)
    for sw in (None, w):
        ref_total, ref_parts = jnet.loss_fn(
            *map(jnp.asarray, (pt, pr, tt, tr)), 1.0, 2.0,
            None if sw is None else jnp.asarray(sw))
        total, parts = tracknet.loss_fn(
            *map(torch.from_numpy, (pt, pr, tt, tr)), 1.0, 2.0,
            None if sw is None else torch.from_numpy(sw))
        np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-6)
        for k in ("trans", "rot"):
            np.testing.assert_allclose(parts[k].item(), float(ref_parts[k]),
                                       rtol=1e-6)
