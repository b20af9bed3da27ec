"""Every module-level entry point of the port that runs the CNN runs its
convolutions with TF32 off (ROADMAP F16).

The JAX reference is full float32 (HIGHEST precision, held at 2e-5 in
tests/test_model.py); torch's default lets cuDNN convolutions run in TF32.
The pin sits in ``Se3TrackNet.forward``, so it holds for every caller, not
only for those that build a ``Tracker`` or a ``Trainer`` first.

The check runs in a fresh interpreter that turns both TF32 flags on, as a
user's process may, and then calls each entry point on a tiny CPU case with
no ``Tracker`` or ``Trainer`` built. Hooks record
``torch.backends.cudnn.allow_tf32`` at every convolution's forward and, for
the train steps, at every convolution weight's gradient (its backward). The
flag is a process-wide torch setting, read the same way on the CPU as on
the card.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json
import numpy as np
import torch
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.allow_tf32 = True

from iros20_6d_pose_tracking_tpu_torch.models import tracknet
from iros20_6d_pose_tracking_tpu_torch.parallel import latency, spmd
from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
from iros20_6d_pose_tracking_tpu_torch.tracking import hypotheses as hyp
from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk
from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

RES, T, H, W = 32, 2, 96, 128
seen = {}
current = [None]


def record(kind):
    seen.setdefault(current[0], []).append(
        [kind, bool(torch.backends.cudnn.allow_tf32)])


def hook_convs(module):
    for m in module.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_pre_hook(lambda *_: record("forward"))


def hook_grads(params):
    for p in params:
        if p.dim() >= 4:  # convolution weights (stacked: one more axis)
            p.register_hook(lambda g: record("backward"))


def net(seed):
    m = tracknet.init_params(tracknet.create_model(RES),
                             torch.Generator().manual_seed(seed))
    hook_convs(m)
    return m


def run(name, fn):
    current[0] = name
    fn()


K = torch.tensor([[150.0, 0, 64.0], [0, 150.0, 48.0], [0, 0, 1]])
pose = torch.eye(4)
pose[2, 3] = 0.5
rng = np.random.RandomState(0)
rgb = torch.from_numpy(rng.randint(0, 256, (T, H, W, 3)).astype(np.uint8))
depth = torch.from_numpy(rng.randint(400, 600, (T, H, W)).astype(np.int32))
mean, std = torch.zeros(8), torch.full((8,), 100.0)
cfg = trk.TrackerConfig(resolution=RES, object_width_mm=110.0,
                        cull_backfaces=True)
mesh = rz.upload(M.make_cube(0.08), "cpu")
model = net(0).eval()

run("tracker.track_step", lambda: trk.track_step(
    model, cfg, mesh, K, mean, std, pose, rgb[0], depth[0]))
run("tracker.track_video", lambda: trk.track_video(
    model, cfg, mesh, K, mean, std, pose, rgb, depth))
run("hypotheses.track_step_multi", lambda: hyp.track_step_multi(
    model, cfg, mesh, K, mean, std, pose, rgb[0], depth[0],
    torch.Generator().manual_seed(0), samples=2))
run("hypotheses.track_video_multi", lambda: hyp.track_video_multi(
    model, cfg, mesh, K, mean, std, pose, rgb, depth, samples=2))
run("hypotheses.track_video_with_health", lambda: hyp.track_video_with_health(
    model, cfg, mesh, K, mean, std, pose, rgb, depth))


def cnn(A, B):
    out = model(A, B)
    return out["trans"], out["rot"]


two_poses = torch.stack([pose, pose])
two_rgb, two_depth = torch.stack([rgb, rgb]), torch.stack([depth, depth])
run("spmd.track_views", lambda: spmd.track_views(
    cnn, cfg, mesh, K, mean, std, two_poses, two_rgb, two_depth))
run("spmd.batched_track_videos", lambda: spmd.batched_track_videos(
    model, cfg, spmd.make_mesh(1))(mesh, K, mean, std, two_poses, two_rgb,
                                   two_depth))
ens = spmd.stack_states([net(1).eval(), net(2).eval()])
hook_convs(ens.model)
cubes = spmd.stack_meshes([M.make_cube(0.08), M.make_cube(0.06)], "cpu")
for serial in (True, False):
    run(f"spmd.multi_object_track_videos serial={serial}",
        lambda: spmd.multi_object_track_videos(
            ens.model, cfg, spmd.make_mesh(1), serial=serial)(
                ens, cubes, K, mean, std, two_poses, two_rgb, two_depth,
                [110.0, 90.0]))
sp = latency.sp_mesh(1)
run("latency.sp_track_step", lambda: latency.sp_track_step(model, cfg, sp)(
    latency.shard_mesh_faces(mesh, sp), K, mean, std, pose, rgb[0],
    depth[0]))


def raw_batch(*lead):
    n = int(np.prod(lead))
    A_in = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    A_in[:, 2, 3] = 0.5
    B_in = A_in.copy()
    B_in[:, 0, 3] += 0.005
    d = rng.uniform(300, 900, (2, n, RES, RES)).astype(np.float32)
    raw = {"rgbA": rng.uniform(0, 255, (n, RES, RES, 3)), "depthA": d[0],
           "rgbB": rng.uniform(0, 255, (n, RES, RES, 3)), "depthB": d[1],
           "maskB": d[1] > 100, "A_in_cam": A_in, "B_in_cam": B_in}
    return {k: torch.from_numpy(np.asarray(v, np.float32) if v.dtype ==
                                np.float64 else v).reshape(lead + v.shape[1:])
            for k, v in raw.items()}


tcfg = tr.TrainConfig(resolution=RES, batch_size=2)
train_net = net(3)
hook_grads(train_net.parameters())
opt, _ = tr.make_optimizer(train_net, tcfg, steps_per_epoch=10)
run("spmd.dp_train_step", lambda: spmd.dp_train_step(
    train_net, opt, tcfg, spmd.make_mesh(1))(
        1e-3, torch.Generator().manual_seed(0), raw_batch(2), mean, std))
for serial in (True, False):
    pairs = []
    for o in range(2):
        m = net(4 + o)
        pairs.append((m, tr.make_optimizer(m, tcfg, steps_per_epoch=10)[0]))
    ens_t = spmd.stack_states(pairs)
    hook_convs(ens_t.model)
    hook_grads(ens_t.params.values())
    run(f"spmd.ensemble_train_step serial={serial}",
        lambda: spmd.ensemble_train_step(
            ens_t.model, ens_t.opt, tcfg, spmd.make_mesh(1), serial=serial)(
                ens_t, 1e-3, [torch.Generator().manual_seed(o)
                              for o in range(2)], raw_batch(2, 2), mean, std))
print("SEEN " + json.dumps(seen))
"""

ENTRY_POINTS = [
    "tracker.track_step", "tracker.track_video",
    "hypotheses.track_step_multi", "hypotheses.track_video_multi",
    "hypotheses.track_video_with_health", "spmd.track_views",
    "spmd.batched_track_videos",
    "spmd.multi_object_track_videos serial=True",
    "spmd.multi_object_track_videos serial=False", "latency.sp_track_step",
    "spmd.dp_train_step", "spmd.ensemble_train_step serial=True",
    "spmd.ensemble_train_step serial=False"]


def test_entry_points_run_convolutions_without_tf32():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = next(s for s in proc.stdout.splitlines() if s.startswith("SEEN "))
    seen = json.loads(line[len("SEEN "):])
    assert sorted(seen) == sorted(ENTRY_POINTS)
    for name, calls in seen.items():
        kinds = {k for k, _ in calls}
        want = {"forward", "backward"} if "train_step" in name else {
            "forward"}
        assert kinds == want, (name, kinds)
        tf32 = [c for c in calls if c[1]]
        assert not tf32, (name, f"{len(tf32)} of {len(calls)} convolution "
                          "calls ran with cudnn.allow_tf32 on")
