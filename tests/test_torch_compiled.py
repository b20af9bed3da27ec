"""The port's compiled tracking step (``tracking/compiled.py``) on the CPU,
where its bookkeeping runs the eager step: the static frame slots, the
device-side frame index and the carried pose give the eager loop's poses bit
for bit, and follow the JAX ``track_video`` (``jit`` + ``frame_scan``, Pallas
kernels in interpret mode) within 5e-4 m and 5e-3 rad; ``on_track``, the
chunked video and a stream over two window sides give the eager bits; the
cache makes one program per key, and a program refuses another key. The
scene is tests/test_torch_tracker.py's (a 0.08 m cube, a 64^2 ROI, 192x256
frames, small regression heads), the frames shifted a pixel a frame. With a
stand-in for the card's graph, a bf16 model's replays read held weight
copies and cast none."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iros20_6d_pose_tracking_tpu.models import tracknet as jnet
from iros20_6d_pose_tracking_tpu.render import mesh as JM
from iros20_6d_pose_tracking_tpu.render import rasterizer as JRz
from iros20_6d_pose_tracking_tpu.tracking import tracker as jtrk
from iros20_6d_pose_tracking_tpu_torch.models import refinenet, tracknet
from iros20_6d_pose_tracking_tpu_torch.models.convert import (
    state_dict_from_jax)
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as TRz
from iros20_6d_pose_tracking_tpu_torch.tracking import compiled
from iros20_6d_pose_tracking_tpu_torch.tracking import stream as st
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
from iros20_6d_pose_tracking_tpu_torch.utils import profiling

torch.set_num_threads(2)

RES = 64
H, W = 192, 256
K = np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1.0]], np.float32)
WIDTH_MM = 110.0
T_FRAMES = 20
CPU = torch.device("cpu")


def _rot_angle(Ra, Rb):
    R = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arcsin(min(np.linalg.norm(w) / 2.0, 1.0)))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(0)
    mean = (rng.rand(8) * 10).astype(np.float32)
    std = (rng.rand(8) * 20 + 80).astype(np.float32)
    model = jnet.create_model(RES)
    variables = jnet.init_variables(model, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    for blk in stats.values():
        for bn in blk.values():
            bn["mean"] = rng.uniform(-0.5, 0.5, bn["mean"].shape).astype(
                np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(
                np.float32)
    for head in ("trans_out", "rot_out"):
        params[head]["kernel"] = params[head]["kernel"] * 0.05
        params[head]["bias"] = params[head]["bias"] * 0.0
    variables = {"params": params, "batch_stats": stats}

    tm = M.make_cube(0.08)
    gt = np.eye(4, dtype=np.float32)
    gt[:3, 3] = [0.01, -0.005, 0.55]
    rgb, depth = TRz.render(TRz.upload(tm, CPU), torch.as_tensor(gt),
                            torch.as_tensor(K), TRz.full_frame_window(W, H),
                            out_hw=(H, W), cull_backfaces=True)
    rgb = rgb.numpy().astype(np.uint8)
    depth = depth.numpy().astype(np.uint16)
    # the object moves a pixel a frame: every frame differs
    rgbs = np.stack([np.roll(rgb, i, axis=1) for i in range(T_FRAMES)])
    depths = np.stack([np.roll(depth, i, axis=1) for i in range(T_FRAMES)])
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.0, 0.0, 0.5]

    net = tracknet.create_model(RES)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    cfg = trk.TrackerConfig(resolution=RES, object_width_mm=WIDTH_MM,
                            cull_backfaces=True)
    jcfg = jtrk.TrackerConfig(resolution=RES, object_width_mm=WIDTH_MM,
                              render_impl="pallas_interpret",
                              cull_backfaces=True, fuse_pass2=True)
    return dict(net=net.eval(), cfg=cfg, tm=tm, mean=mean, std=std,
                jmodel=model, jcfg=jcfg, variables=variables,
                jmesh=JRz.upload(JM.make_cube(0.08)), init=init, rgbs=rgbs,
                depths=depths)


def _tracker(scene, net=None):
    return trk.Tracker.from_parts(net or scene["net"], scene["cfg"],
                                  TRz.upload(scene["tm"], CPU), K,
                                  scene["mean"], scene["std"])


def _eager_loop(t, init, rgbs, depths):
    """The eager step frame by frame, the pose carried as a tensor."""
    pose, out = torch.as_tensor(init), []
    for rgb, depth in zip(rgbs, depths):
        pose, _ = trk.track_step(t.model, t.cfg, t.mesh, t.K, t.mean, t.std,
                                 pose, trk.upload_rgb(rgb, CPU),
                                 trk.upload_depth(depth, CPU))
        out.append(pose)
    return torch.stack(out).numpy()


@pytest.fixture(scope="module")
def eager(scene):
    return _eager_loop(_tracker(scene), scene["init"], scene["rgbs"],
                       scene["depths"])


def _parts(t):
    return (t.model, t.cfg, t.mesh, t.K, t.mean, t.std)


@pytest.mark.parametrize("slots", [1, 8, compiled.VIDEO_SLOTS])
def test_program_video_equals_eager_loop(scene, eager, slots):
    """20 frames through one program, ``slots`` frames copied in at a time:
    the frame read at the device index, the pose carried in the program's
    buffer and each pose written to its slot give the eager loop's bits;
    the index ends at 20 mod ``slots``."""
    t = _tracker(scene)
    rgb = trk.upload_rgb(scene["rgbs"], CPU)
    depth = trk.upload_depth(scene["depths"], CPU)
    init = torch.as_tensor(scene["init"])
    prog = compiled.StepProgram(*_parts(t), init, rgb[0], depth[0],
                                slots=slots)
    poses = prog.video(*_parts(t), init, rgb, depth)
    np.testing.assert_array_equal(poses.numpy(), eager)
    assert int(prog.idx) == T_FRAMES % slots == prog._slot
    np.testing.assert_array_equal(prog.pose.numpy(), eager[-1])
    assert prog.eager_calls == T_FRAMES and prog.replays == 0
    assert prog.graph is None
    # a second video starts from its own init pose at slot 0
    again = prog.video(*_parts(t), init, rgb[:3], depth[:3])
    np.testing.assert_array_equal(again.numpy(), eager[:3])


def test_track_video_equals_eager_loop(scene, eager):
    """The module-level ``track_video`` (through ``Tracker.track_video``)
    gives the eager loop's bits, and its poses are not written by a later
    call."""
    t = _tracker(scene)
    init = torch.as_tensor(scene["init"])
    rgb = trk.upload_rgb(scene["rgbs"], CPU)
    depth = trk.upload_depth(scene["depths"], CPU)
    first = trk.track_video(*_parts(t), init, rgb, depth)
    kept = first.clone()
    trk.track_video(*_parts(t), torch.as_tensor(eager[5]), rgb[6:], depth[6:])
    np.testing.assert_array_equal(first.numpy(), kept.numpy())
    np.testing.assert_array_equal(first.numpy(), eager)
    np.testing.assert_array_equal(
        t.track_video(scene["init"], scene["rgbs"], scene["depths"]), eager)
    assert trk.track_video(*_parts(t), init, rgb[:0], depth[:0]).shape == (
        0, 4, 4)


def test_compiled_video_follows_jax_trajectory(scene):
    """Per frame within 5e-4 m and 5e-3 rad of the JAX scan (``jit`` and
    the nested ``frame_scan``; Pallas in interpret mode, cull and fused
    pass 2), while the pose moves."""
    s = scene
    ref = np.asarray(jtrk.track_video(
        s["jmodel"], s["jcfg"], s["variables"], s["jmesh"], jnp.asarray(K),
        jnp.asarray(s["mean"]), jnp.asarray(s["std"]),
        jnp.asarray(s["init"]), jnp.asarray(s["rgbs"]),
        jnp.asarray(s["depths"])))
    poses = _tracker(s).track_video(s["init"], s["rgbs"], s["depths"])
    assert poses.shape == (T_FRAMES, 4, 4) and np.isfinite(poses).all()
    assert np.linalg.norm(poses[-1, :3, 3] - s["init"][:3, 3]) > 1e-3
    for i in range(T_FRAMES):
        np.testing.assert_allclose(poses[i, :3, 3], ref[i, :3, 3], atol=5e-4,
                                   err_msg=f"translation, frame {i}")
        assert _rot_angle(poses[i, :3, :3], ref[i, :3, :3]) < 5e-3, i


def test_on_track_equals_eager_loop(scene, eager):
    """``on_track`` at samples 1, its upload copied into the program's
    static buffers, frame by frame from the pose it returned."""
    t = _tracker(scene)
    pose = scene["init"]
    for i in range(T_FRAMES):
        pose = t.on_track(pose, scene["rgbs"][i], scene["depths"][i])
        np.testing.assert_array_equal(pose, eager[i], err_msg=f"frame {i}")
    assert t.frame_cnt == T_FRAMES


def test_chunked_equals_eager_loop(scene, eager):
    """Chunks of 7 frames (7, 7, 6), the pose carried from chunk to
    chunk."""
    t = _tracker(scene)
    got = t.track_video_chunked(scene["init"], scene["rgbs"],
                                scene["depths"], chunk_size=7)
    np.testing.assert_array_equal(got, eager)


@pytest.mark.parametrize("window", [True, False])
def test_stream_equals_eager_loop(scene, window):
    """Ten pushes, a re-init nearer the camera, ten more: the windowed
    stream moves to larger window sides and keeps one program per side;
    both streams give the eager loop's bits over the full frames, and
    ``compiled_programs`` counts the distinct keys."""
    near = np.eye(4, dtype=np.float32)
    near[:3, 3] = [0.0, 0.0, 0.3]
    rgbs, depths = scene["rgbs"], scene["depths"]
    t = _tracker(scene)
    want = np.concatenate([_eager_loop(t, scene["init"], rgbs[:10],
                                       depths[:10]),
                           _eager_loop(t, near, rgbs[10:], depths[10:])])
    s = st.StreamTracker(_tracker(scene), window=window, refetch_every=2)
    s.begin(scene["init"], image_hw=(H, W))
    sides = set()
    for i in range(T_FRAMES):
        if i == 10:
            s.set_pose(near)
        s.push(rgbs[i], depths[i])
        sides.add(s._cur_bucket)
        s.wait_fetch()
    got = s.poses()
    s.close()
    np.testing.assert_array_equal(got, want)
    stats = s.stats()
    assert stats["containment_violations"] == 0
    if window:
        assert len(sides) >= 2, sides
        assert stats["compiled_programs"] == len(sides)
    else:
        assert stats["compiled_programs"] == 1


def _moved(net):
    """The same weights in new storage: a round trip through float64."""
    return net.to(torch.float64).to(torch.float32)


def _updated_in_place(net):
    with torch.no_grad():
        net.trans_out[0].weight.mul_(1.5)
    return net


@pytest.mark.parametrize("change", ["sliced mesh", "moved model",
                                    "updated in place"])
def test_cache_makes_a_program_per_key(scene, change):
    """A sliced mesh, a model moved with ``.to()`` and a model updated in
    place each make a program of their own (their graph would read other
    addresses, or other weights), each with the eager bits; the same
    arguments again reuse it."""
    net = tracknet.create_model(RES)
    net.load_state_dict(scene["net"].state_dict())
    t = _tracker(scene, net.eval())
    cache = compiled.ProgramCache()
    rgb = trk.upload_rgb(scene["rgbs"][0], CPU)
    depth = trk.upload_depth(scene["depths"][0], CPU)
    init = torch.as_tensor(scene["init"])
    parts = list(_parts(t))
    cache.step(*parts, init, rgb, depth)
    assert len(cache) == 1
    if change == "sliced mesh":
        stack = TRz.MeshArrays(*(None if f is None else torch.stack([f, f])
                                 for f in t.mesh))
        parts[2] = TRz.mesh_of(stack, 1)
    elif change == "moved model":
        parts[0] = _moved(t.model)
    else:
        parts[0] = _updated_in_place(t.model)
    got = cache.step(*parts, init, rgb, depth)
    want, _ = trk.track_step(*parts, init, rgb, depth)
    assert len(cache) == 2
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    cache.step(*parts, init, rgb, depth)
    assert len(cache) == 2


def test_program_refuses_another_key(scene):
    """A program asked for a key it was not built for raises: another frame
    shape, a frame offset it was built without, another model, another
    object width."""
    t = _tracker(scene)
    rgb = trk.upload_rgb(scene["rgbs"][0], CPU)
    depth = trk.upload_depth(scene["depths"][0], CPU)
    init = torch.as_tensor(scene["init"])
    prog = compiled.StepProgram(*_parts(t), init, rgb, depth)
    prog.step(*_parts(t), init, rgb, depth)
    with pytest.raises(ValueError, match="another key"):
        prog.step(*_parts(t), init, rgb[:96], depth[:96])
    with pytest.raises(ValueError, match="another key"):
        prog.step(*_parts(t), init, rgb, depth,
                  frame_offset_vu=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="another key"):
        prog.step(*_parts(t), init, rgb, depth, object_width_mm=90.0)
    other = tracknet.create_model(RES).eval()
    with pytest.raises(ValueError, match="another key"):
        prog.video(other, *_parts(t)[1:], init, rgb[None], depth[None])
    assert prog.eager_calls == 1


def test_cache_drops_the_least_recently_used(scene):
    """Past its size the cache drops the program used longest ago."""
    t = _tracker(scene)
    cache = compiled.ProgramCache(size=2)
    init = torch.as_tensor(scene["init"])
    rgb = trk.upload_rgb(scene["rgbs"][0], CPU)
    depth = trk.upload_depth(scene["depths"][0], CPU)
    for width in (100.0, 110.0, 100.0, 120.0):
        cache.step(*_parts(t), init, rgb, depth, object_width_mm=width)
    assert len(cache) == 2
    assert sorted(p.object_width_mm for p in cache.programs()) == [100.0,
                                                                   120.0]


class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    """``torch.cuda.CUDAGraph`` as the CPU can stand in for it: the capture
    records the program's body without running it (the body's writes to
    the program's buffers are undone), and a replay runs the recorded body
    with every counter left as it was, since a replay runs no Python."""

    capturing = None

    def __init__(self):
        self.body = None

    def capture_begin(self, **kwargs):
        _Graph.capturing = self

    def capture_end(self):
        _Graph.capturing = None

    def replay(self):
        kept = dict(profiling._counts)
        self.body()
        profiling._counts.clear()
        profiling._counts.update(kept)


@pytest.fixture
def card_standin(monkeypatch):
    """Programs on the CPU go through the card's warm-up, capture and
    replay bookkeeping, with :class:`_Graph` for the graph."""
    body = compiled.StepProgram._body

    def recorded(self, model, cfg, mesh):
        g = _Graph.capturing
        if g is None:
            return body(self, model, cfg, mesh)
        g.body = lambda: body(self, model, cfg, mesh)
        kept = [t.clone() for t in (self.pose, self.poses, self.idx)]
        body(self, model, cfg, mesh)
        for t, k in zip((self.pose, self.poses, self.idx), kept):
            t.copy_(k)

    monkeypatch.setattr(compiled.StepProgram, "captures", True)
    monkeypatch.setattr(compiled.StepProgram, "_body", recorded)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())


def _bf16_model(scene, kind):
    """A bf16 Se3TrackNet on the scene's weights (38 weight casts a frame,
    19 layers), or a small bf16 refiner (2 rounds of 25 layers: 100)."""
    if kind == "se3tracknet":
        net = tracknet.create_model(RES, dtype=torch.bfloat16)
        net.load_state_dict(scene["net"].state_dict())
        return net.eval(), 38
    torch.manual_seed(11)
    net = refinenet.RefineNet(torch.bfloat16, base=8)
    with torch.no_grad():
        for head in (net.trans_head[1], net.rot_head[1]):
            head.weight.mul_(0.05)
    return net.eval(), 100


def _weight_counts():
    c = profiling.counters()
    return c["weights.bf16_casts"], c["weights.bf16_held"]


@pytest.mark.parametrize("kind", ["se3tracknet", "refiner"])
def test_replays_read_held_bf16_weights(scene, card_standin, kind):
    """A bf16 model's program casts its weights in the first round of its
    first warm-up call only: the capture records none, and every replayed frame advances
    ``weights.bf16_casts`` by 0 and ``weights.bf16_held`` by the model's
    casts a frame; the program keeps the copies its graph reads. After an
    in-place update of one weight the cache makes a new program, whose
    poses, eager and replayed, are the updated model's eager step's, while
    the first program's copy keeps the old weight."""
    net, per_frame = _bf16_model(scene, kind)
    cfg = dataclasses.replace(scene["cfg"], dtype=torch.bfloat16)
    mesh = TRz.upload(scene["tm"], CPU)
    Kt = torch.as_tensor(K)
    mean, std = torch.as_tensor(scene["mean"]), torch.as_tensor(scene["std"])
    rgbs = trk.upload_rgb(scene["rgbs"], CPU)
    depths = trk.upload_depth(scene["depths"], CPU)
    parts = (net, cfg, mesh, Kt, mean, std)
    cache = compiled.ProgramCache()

    def run(frames, pose):
        got, want, counts = [], [], []
        for i in frames:
            before = _weight_counts()
            got.append(cache.step(*parts, pose, rgbs[i], depths[i]))
            after = _weight_counts()
            counts.append((after[0] - before[0], after[1] - before[1]))
            want.append(trk.track_step(*parts, pose, rgbs[i], depths[i])[0])
            pose = want[-1]
        assert torch.equal(torch.stack(got), torch.stack(want))
        return pose, counts

    per_round = per_frame // net.refine_iterations
    pose, counts = run(range(6), torch.as_tensor(scene["init"]))
    assert counts == [(per_round, per_frame - per_round)] + \
        [(0, per_frame)] * 5
    (prog,) = cache.programs()
    assert prog.graph is not None and prog.replays == 6 - \
        compiled.WARMUP_CALLS
    assert prog.replay_counts["weights.bf16_held"] == per_frame
    assert "weights.bf16_casts" not in prog.replay_counts
    assert len(prog._weights) == per_round
    w = net.rot_head[1].weight if kind == "refiner" \
        else net.rot_out[0].weight
    kept = next(c for s, c in prog._weights
                if s.data_ptr() == w.untyped_storage().data_ptr())
    old = kept.clone()
    with torch.no_grad():
        w.mul_(1.5)
    pose, counts = run(range(6, 12), pose)
    assert len(cache) == 2
    assert counts == [(1, per_frame - 1)] + [(0, per_frame)] * 5
    assert torch.equal(kept, old)
    assert not torch.equal(kept, w.to(torch.bfloat16))


def test_replays_advance_counters_the_program_never_names(scene,
                                                          card_standin):
    """A counter the compiled step does not name, counted inside the
    model's forward, advances on every replayed frame by what it advances
    on an eager frame: the capture takes back what its body counted and
    each replay adds it, and nothing else (the program's own ``compiled.*``
    counters stay out)."""
    name = "tests.forward_calls"
    net = tracknet.create_model(RES)
    net.load_state_dict(scene["net"].state_dict())
    net.eval().register_forward_hook(
        lambda *a: profiling.count(name, 3))
    t = _tracker(scene, net)
    rgbs = trk.upload_rgb(scene["rgbs"], CPU)
    depths = trk.upload_depth(scene["depths"], CPU)
    cache = compiled.ProgramCache()

    def counted(fn):
        before = profiling.counters().get(name, 0)
        out = fn()
        return out, profiling.counters()[name] - before

    pose, frames = torch.as_tensor(scene["init"]), compiled.WARMUP_CALLS + 4
    for i in range(frames):
        got, n_program = counted(lambda: cache.step(
            *_parts(t), pose, rgbs[i], depths[i]))
        pose, n_eager = counted(lambda: trk.track_step(
            *_parts(t), pose, rgbs[i], depths[i])[0])
        assert torch.equal(got, pose)
        assert n_program == n_eager == 3, i
    (prog,) = cache.programs()
    assert prog.replays == frames - compiled.WARMUP_CALLS
    assert prog.replay_counts == {name: 3}
