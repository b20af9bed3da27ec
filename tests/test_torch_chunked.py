"""The port's chunked video tracking (``Tracker.track_video_chunked``) and its
Flax msgpack checkpoints (``train/checkpoint.py``), against the port's whole
video run and the JAX package: a 0.08 m cube in a 48^2 ROI of 160x120
frames, small regression heads."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from iros20_6d_pose_tracking_tpu.models import tracknet as jnet
from iros20_6d_pose_tracking_tpu.render import mesh as JM
from iros20_6d_pose_tracking_tpu.render import rasterizer as JRz
from iros20_6d_pose_tracking_tpu.tracking import tracker as jtrk
from iros20_6d_pose_tracking_tpu.train import checkpoint as jck
from iros20_6d_pose_tracking_tpu.train import trainer as jtrainer
from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.models.convert import (
    state_dict_from_jax)
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as TRz
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
from iros20_6d_pose_tracking_tpu_torch.train import checkpoint as ck

torch.set_num_threads(2)

RES = 48
H, W = 120, 160
K = np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1.0]], np.float32)
WIDTH_MM = 150.0
T = 5
INFO = {"resolution": RES, "object_width": WIDTH_MM,
        "camera": {"focalX": 300.0, "focalY": 300.0, "centerX": 80.0,
                   "centerY": 60.0}}


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(1)
    model = jnet.create_model(RES)
    variables = jnet.init_variables(model, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    for head in ("trans_out", "rot_out"):
        params[head]["kernel"] = params[head]["kernel"] * 0.05
        params[head]["bias"] = params[head]["bias"] * 0.0
    variables = {"params": params, "batch_stats": stats}
    mean = (rng.rand(8) * 10).astype(np.float32)
    std = (rng.rand(8) * 20 + 80).astype(np.float32)
    tm = M.make_cube(0.08)
    frames_rgb, frames_depth = [], []
    for i in range(T):  # the cube drifts a few mm a frame
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.003 * i, -0.002 * i, 0.52 + 0.002 * i]
        rgb, depth = TRz.render(TRz.upload(tm, "cpu"), torch.as_tensor(pose),
                                torch.as_tensor(K),
                                TRz.full_frame_window(W, H), out_hw=(H, W))
        frames_rgb.append(rgb.numpy().astype(np.uint8))
        frames_depth.append(depth.numpy().astype(np.uint16))
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.0, 0.0, 0.51]
    tracker = trk.Tracker(INFO, mean, std, mesh=tm, variables=variables,
                          device="cpu")
    assert tracker.cfg.cull_backfaces
    return dict(variables=variables, jmodel=model, mean=mean, std=std,
                tracker=tracker, init=init, rgb=np.stack(frames_rgb),
                depth=np.stack(frames_depth))


@pytest.mark.parametrize("chunk_size", [1, 2, 3, 5, 64])
def test_chunked_equals_whole_video(scene, chunk_size):
    """Array sources in chunks (ragged last chunk at 2 and 3, one chunk at
    5 and 64) are bit-equal to one whole-video run."""
    s, t = scene, scene["tracker"]
    whole = t.track_video(s["init"], s["rgb"], s["depth"])
    chunked = t.track_video_chunked(s["init"], s["rgb"], s["depth"],
                                    chunk_size=chunk_size)
    assert chunked.dtype == np.float32 and chunked.shape == (T, 4, 4)
    np.testing.assert_array_equal(chunked, whole)
    assert np.linalg.norm(whole[-1, :3, 3] - s["init"][:3, 3]) > 1e-3


def test_chunked_callable_sources(scene):
    """Callables ``f(a, b)`` are asked for each chunk once, in order, with
    the last chunk ragged; ``n_frames`` is required with them; an empty
    video gives (0, 4, 4)."""
    s, t = scene, scene["tracker"]
    asked = []

    def rgb_src(a, b):
        asked.append((a, b))
        return s["rgb"][a:b]

    poses = t.track_video_chunked(s["init"], rgb_src,
                                  lambda a, b: s["depth"][a:b],
                                  chunk_size=2, n_frames=T)
    assert asked == [(0, 2), (2, 4), (4, 5)]
    np.testing.assert_array_equal(
        poses, t.track_video(s["init"], s["rgb"], s["depth"]))
    with pytest.raises(ValueError, match="n_frames"):
        t.track_video_chunked(s["init"], rgb_src, s["depth"])
    empty = t.track_video_chunked(s["init"], s["rgb"][:0], s["depth"][:0])
    assert empty.shape == (0, 4, 4) and empty.dtype == np.float32
    assert t.track_video_chunked(s["init"], rgb_src, rgb_src,
                                 n_frames=0).shape == (0, 4, 4)


def test_chunked_follows_jax_chunked(scene):
    """Within 5e-4 m of JAX's ``track_video_chunked`` at chunk 2 (which pads
    its last chunk; the port does not)."""
    s = scene
    jt = jtrk.Tracker(INFO, s["mean"], s["std"], mesh=JM.make_cube(0.08),
                      variables=s["variables"], render_impl="pallas_interpret",
                      persistent_cache=False)
    ref = jt.track_video_chunked(s["init"], s["rgb"], s["depth"],
                                 chunk_size=2)
    ours = s["tracker"].track_video_chunked(s["init"], s["rgb"], s["depth"],
                                            chunk_size=2)
    np.testing.assert_allclose(ours[:, :3, 3], ref[:, :3, 3], atol=5e-4)
    np.testing.assert_allclose(ours[:, :3, :3], ref[:, :3, :3], atol=5e-3)


def _jax_train_state():
    """A JAX trainer checkpoint's state (``Trainer._state_dict``): params,
    batch_stats, the optax Adam state, counters, mean/std, best losses."""
    cfg = jtrainer.TrainConfig(resolution=RES)
    tx, _ = jtrainer.make_optimizer(cfg, steps_per_epoch=10)
    model = jnet.create_model(RES)
    state = jtrainer.create_train_state(model, cfg, tx, jax.random.PRNGKey(5))
    rng = np.random.RandomState(3)
    stats = jax.tree.map(
        lambda x: rng.uniform(0.5, 2.0, x.shape).astype(np.float32),
        state.batch_stats)
    return {"params": state.params, "batch_stats": stats,
            "opt_state": state.opt_state, "step": state.step,
            "epoch": state.epoch, "mean": np.zeros(8, np.float32),
            "std": np.full(8, 100.0, np.float32),
            "best_train": np.float32(0.25), "best_val": np.float32(np.inf)}


def test_flax_checkpoint_loads_into_tracker(tmp_path):
    """A checkpoint_last-style msgpack written by the JAX trainer's
    ``save_checkpoint`` reads back as flax reads it, and loads into the
    port's Tracker with the state_dict of ``state_dict_from_jax``."""
    state = _jax_train_state()
    path = str(tmp_path / "checkpoint_last.msgpack")
    jck.save_checkpoint(path, state, {"epoch": 0})
    ours = ck.load_flax_checkpoint(path)
    with open(path, "rb") as f:
        ref = serialization.msgpack_restore(f.read())

    def same(a, b, where):
        if isinstance(b, dict):
            assert isinstance(a, dict) and a.keys() == b.keys(), where
            for k in b:
                same(a[k], b[k], f"{where}/{k}")
        else:
            assert type(a) is type(b), where
            np.testing.assert_array_equal(a, b, err_msg=where)
            assert np.asarray(a).dtype == np.asarray(b).dtype, where

    same(ours, ref, "")
    assert ours["step"].shape == () and ours["best_val"] == np.inf
    t = trk.Tracker(INFO, np.zeros(8), np.full(8, 100.0),
                    mesh=M.make_cube(0.08), ckpt_dir=path, device="cpu")
    want = state_dict_from_jax({"params": state["params"],
                                "batch_stats": state["batch_stats"]})
    got = t.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_flax_checkpoint_writer_matches_flax(tmp_path):
    """``save_flax_checkpoint`` writes flax's own bytes for the Flax-layout
    weights of the port's network (``state_dict_to_variables``), and they
    load back into a Tracker equal to the network's state."""
    from iros20_6d_pose_tracking_tpu_torch.models import convert

    net = tracknet.init_params(tracknet.create_model(RES),
                               torch.Generator().manual_seed(4))
    variables = convert.state_dict_to_variables(net.state_dict())
    tree = {**variables, "step": np.int32(7), "scale": np.float32(0.5)}
    path = str(tmp_path / "zero_head.msgpack")
    ck.save_flax_checkpoint(path, tree)
    with open(path, "rb") as f:
        assert f.read() == serialization.msgpack_serialize(tree)
    t = trk.Tracker(INFO, np.zeros(8), np.full(8, 100.0),
                    mesh=M.make_cube(0.08), ckpt_dir=path, device="cpu")
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(t.model.state_dict()[k], v), k
