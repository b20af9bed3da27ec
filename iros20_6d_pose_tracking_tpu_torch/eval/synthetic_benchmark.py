"""Closed-loop synthetic evaluation: the evaluation half, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/eval/synthetic_benchmark.py``.
The chain is the JAX module's: a ground-truth trajectory
(:func:`make_gt_trajectory`) -> the observed RGB-D video rendered at it
(:func:`render_test_video`, clean or "hard": textured background at valid
depth, a sweeping occluder, depth dropout) -> sensor precision
(:func:`_quantize`) -> tracking from gt[0] (:func:`evaluate_tracking`, on
``tracking/tracker.track_video``) -> ADD / ADD-S per frame and their VOCap
AUC (:func:`_score_poses`, ``eval/metrics.py``).

Every full-frame render goes through the work-list pass 1 (K3,
``render(..., worklist=True)``): a small object in a 480x640 frame is the
sparse case the work list exists for. The tracker's ROI renders keep K1.

:func:`train_object` trains a tracker for one object on the synthetic
pair sampler (``data/dataset.py``) with ``train/trainer.py``, checkpointing
and resuming by recipe fingerprint; :func:`hard_aug` is the augmentation
stack of DR training.

The accuracy suite: :func:`shift_severity_sweep` (the tracker under the
sensor model of ``eval/domain_shift.py`` scaled to each severity, plus a
texture-hostile row for textured objects), :func:`shift_axis_ablation`
(one shift axis at a time) and :func:`run_suite` (train, track and score
each object, with the domain-shifted table, the sweep, the ablation, the
long-horizon protocol and its forced-failure recovery offline and live).
The suite always renders full frames through K3; the JAX module's ``impl``
has no counterpart.

The object ensemble: :func:`train_objects_ensemble` trains every object at
once (``parallel/spmd.ensemble_train_step`` over
``data/dataset.ensemble_synth_batch``), :func:`ensemble_evaluate_tracking`
tracks every object's video in one call
(``parallel/spmd.multi_object_track_videos``), and ``run_suite(ensemble=
True)`` uses both for the untextured objects.

Everything runs on the device of the object's mesh.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import se3
from ..data import augment as A
from ..data.dataset import DRComposite, SyntheticPairs
from ..datagen.pair_producer import _procedural_texture
from ..models import tracknet
from ..render import mesh as M
from ..render import rasterizer as rz
from ..tracking import tracker as trk
from ..train import checkpoint as ck
from ..train import trainer as tr
from . import domain_shift as DS
from . import metrics as ME

# YCB-Video camera intrinsics (reference dataset_info.yml camera block).
YCB_K = np.array(
    [[1066.778, 0, 312.9869], [0, 1067.487, 241.3109], [0, 0, 1]],
    np.float32,
)

OBJECTS = {
    # face-colored cube: rotation observable in RGB and depth
    "cube": lambda: M.make_cube(0.08),
    # anisotropic box: distinct extents break rotational ambiguity
    "box": lambda: M.make_box((0.10, 0.06, 0.035)),
    # asymmetric L-bracket: thin arms, self-occlusion at grazing views
    "lshape": lambda: M.make_lshape(),
    # faceted icosahedron: near-round geometry, rotation mostly RGB-borne
    "icosahedron": lambda: M.make_icosphere(subdiv=1, radius=0.05),
    # uniform cylinder: axial rotation unobservable -> ADD ill-posed,
    # ADD-S meaningful (reference eval_ycb.py:102-118 ADD vs ADI split)
    "cylinder": lambda: M.make_cylinder(),
    # uniform sphere: every rotation unobservable; translation only
    "sphere": lambda: M.make_plain_sphere(),
    # thin plate: near-degenerate depth extent + 180-degree flip
    # ambiguity face-on
    "plate": lambda: M.make_plate(),
    # UV-textured box: sub-face texture detail through the full loop
    "textured_box": lambda: M.make_textured_box(),
}

# objects whose geometry leaves rotations unobservable: score them by
# ADD-S; their ADD column is reported for honesty, not as a target
SYMMETRIC_OBJECTS = frozenset({"cylinder", "sphere", "plate"})

# Depth dropout of the hard video: share of pixels zeroed per frame, and
# the seed of frame i's draw (1000 + i, as the JAX module's PRNGKey).
DROPOUT_P = 0.03
DROPOUT_SEED = 1000

@dataclass
class BenchObject:
    """One tracker and its assets: the port's network (in eval mode, on the
    mesh's device) where the JAX module holds Flax variables."""

    name: str
    tm: M.TriMesh
    mesh: rz.MeshArrays
    model: tracknet.Se3TrackNet
    mean: torch.Tensor
    std: torch.Tensor
    width_mm: float
    tcfg: trk.TrackerConfig
    train_secs: float = 0.0
    losses: list = field(default_factory=list)


def _print_flush(*a):
    print(*a, flush=True)


def _recipe_fingerprint(dr, aug, device) -> str:
    """Identifies a training recipe: a checkpoint of another recipe is not
    resumed."""
    desc = repr((repr(dr) if dr is not None else None, repr(aug),
                 torch.device(device).type))
    return hashlib.sha1(desc.encode()).hexdigest()[:12]


def train_object(
    tm: M.TriMesh,
    K=YCB_K,
    *,
    name: str = "object",
    steps: int = 10_000,
    batch: int = 32,
    res: int = 176,
    dr: DRComposite | None = None,
    aug: A.AugmentConfig | None = None,
    seed_offset: int = 0,
    log=_print_flush,
    ckpt_dir: str | None = None,
    ckpt_every: int = 1000,
    device="cuda",
) -> BenchObject:
    """Train Se3TrackNet on synthetic pairs for one object, on ``device``.

    The reference recipe (train.py:85-165): pose-perturbation pairs,
    photometric augmentation, the mean/std pass, Adam; ``dr`` adds the
    randomized scenes (``data/dataset.py::DRComposite``).

    ``ckpt_dir``: the full training state is saved every ``ckpt_every``
    steps and at the end to ``<ckpt_dir>/<name>_last.pt``, and a run of the
    same name, steps, batch, resolution and recipe resumes from it. Step i
    samples from ``step_generator(device, 7 + seed_offset, i)`` and augments
    from ``(7 + seed_offset, 10**6 + i)``, so a resumed run consumes the
    uninterrupted run's batches."""
    dev = torch.device(device)
    mesh = rz.upload(tm, dev)
    width = tm.diameter * 1000 * 1.1
    cfg = tr.TrainConfig(
        resolution=res, batch_size=batch, learning_rate=1e-3,
        trans_normalizer=0.02, rot_normalizer=15 * np.pi / 180,
        aug=aug if aug is not None else A.AugmentConfig())
    recipe = _recipe_fingerprint(dr, cfg.aug, dev)
    synth = SyntheticPairs(
        mesh, K, resolution=res, object_width_mm=width, max_trans=0.02,
        max_rot_deg=15.0,
        xyz_range=((-0.12, 0.12), (-0.09, 0.09), (0.45, 0.85)), dr=dr)
    ckpt_path = restored = None
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
        ckpt_path = os.path.join(ckpt_dir, f"{name}_last.pt")
        if os.path.exists(ckpt_path):
            meta = ck.load_metadata(ckpt_path)
            if (meta.get("name") == name
                    and int(meta.get("total_steps", -1)) == steps
                    and int(meta.get("batch", -1)) == batch
                    and int(meta.get("res", -1)) == res
                    and meta.get("recipe") == recipe):
                restored = ck.load_checkpoint(ckpt_path, map_location=dev)
            else:
                log(f"[{name}] ignoring {ckpt_path}: different "
                    "name/steps/batch/res/recipe")

    if restored is not None:
        mean, std = restored["mean"].to(dev), restored["std"].to(dev)
    else:
        mean, std = tr.compute_mean_std(
            (synth.sample_batch(tr.step_generator(dev, 900 + seed_offset, i),
                                batch) for i in range(4)),
            cfg, dev, max_samples=4 * batch)
        mean = torch.as_tensor(mean, dtype=torch.float32).to(dev)
        std = torch.as_tensor(std, dtype=torch.float32).to(dev)
    model = tracknet.Se3TrackNet(image_size=res).to(dev)
    tracknet.init_params(model, torch.Generator().manual_seed(seed_offset))
    opt, lr_at = tr.make_optimizer(model, cfg, steps_per_epoch=10_000)
    start_step = 0
    if restored is not None:
        model.load_state_dict(restored["model"], strict=True)
        opt.load_state_dict(restored["optimizer"])
        start_step = int(restored["step"]) + 1
        log(f"[{name}] resumed from {ckpt_path} at step {start_step}")

    def save_ckpt(i):
        ck.save_checkpoint(
            ckpt_path, {"model": model.state_dict(),
                        "optimizer": opt.state_dict(), "step": int(i),
                        "mean": mean.cpu(), "std": std.cpu()},
            metadata={"name": name, "step": int(i),
                      "total_steps": int(steps), "batch": int(batch),
                      "res": int(res), "recipe": recipe})

    key = 7 + seed_offset
    losses = []
    t0 = time.time()
    for i in range(start_step, steps):
        m = tr.train_step_synth(
            model, opt, lr_at(i), cfg, synth, tr.step_generator(dev, key, i),
            tr.step_generator(dev, key, 10**6 + i), mean, std)
        if i % 100 == 0 or i == steps - 1:
            loss = float(m["loss"])
            losses.append(loss)
            log(f"[{name}] step {i}: loss={loss:.5f} "
                f"trans={float(m['trans']):.5f} rot={float(m['rot']):.5f} "
                f"({time.time() - t0:.0f}s)")
        if ckpt_path and i and (i % ckpt_every == 0 or i == steps - 1):
            save_ckpt(i)
    tcfg = trk.TrackerConfig(
        resolution=res, trans_normalizer=0.02,
        rot_normalizer=15 * np.pi / 180, object_width_mm=width)
    return BenchObject(
        name=name, tm=tm, mesh=mesh, model=model.eval(), mean=mean, std=std,
        width_mm=width, tcfg=tcfg, train_secs=time.time() - t0,
        losses=losses)


def _ensemble_ckpt(path: str, ens, mean, std, metadata: dict):
    """The ensemble's whole training state (stacked parameters, BatchNorm
    statistics, Adam's moments and step, per-object statistics) as a
    msgpack file of numpy arrays, written to a temporary file and renamed,
    with its metadata beside it in ``path + ".json"``."""
    import json

    def np_(t):
        return t.detach().cpu().numpy()

    names = list(ens.params)
    adam = [ens.opt.state.get(p, {}) for p in ens.params.values()]
    tree = {"params": {k: np_(v) for k, v in ens.params.items()},
            "buffers": {k: np_(v) for k, v in ens.buffers.items()},
            "adam": {k: {f: np_(v) for f, v in st.items()}
                     for k, st in zip(names, adam) if st},
            "mean": np.asarray(mean, np.float32),
            "std": np.asarray(std, np.float32)}
    tmp = path + ".tmp"
    ck.save_flax_checkpoint(tmp, tree)
    os.replace(tmp, path)
    with open(path + ".json", "w") as f:
        json.dump(metadata, f, indent=2)


def _restore_ensemble(ens, tree: dict):
    """Load :func:`_ensemble_ckpt`'s tree into ``ens`` in place."""
    with torch.no_grad():
        for k, v in ens.params.items():
            v.copy_(torch.from_numpy(np.array(tree["params"][k])))
        for k, v in ens.buffers.items():
            v.copy_(torch.from_numpy(np.array(tree["buffers"][k])))
    for k, p in ens.params.items():
        st = tree["adam"].get(k)
        if st:
            ens.opt.state[p] = {f: torch.as_tensor(np.array(v)).to(
                p.device if f != "step" else "cpu") for f, v in st.items()}


def train_objects_ensemble(
    names,
    K=YCB_K,
    *,
    steps: int = 5_000,
    batch: int = 200,
    res: int = 176,
    dr: DRComposite | None = None,
    aug: A.AugmentConfig | None = None,
    log=_print_flush,
    ckpt_dir: str | None = None,
    ckpt_every: int = 1000,
    device="cuda",
) -> list[BenchObject]:
    """Train every object at once as an object ensemble on ``device``: each
    step samples every object's DR pairs
    (``data/dataset.ensemble_synth_batch``) and applies every object's Adam
    update (``parallel/spmd.ensemble_train_step`` on the one-card layout,
    where the objects run one after the other, each through its own
    network: per-object throughput as sequential runs, one stats pass and
    one resumable run).

    Per-object statistics (the reference's std of batch means over 4
    batches, each object augmented apart), widths and meshes; otherwise
    :func:`train_object`'s recipe. Step i samples object o from
    ``step_generator(device, 7, i, o)`` and augments it from ``(7, 10**6 +
    i, o)``; the statistics' batch i from ``(900, i, o)`` and ``(i, o)``.
    Returns BenchObjects for :func:`evaluate_tracking`.

    ``ckpt_dir``: the full state is saved every ``ckpt_every`` steps and at
    the end to ``<ckpt_dir>/ensemble_last.msgpack``; a run of the same
    names, steps and recipe resumes from it and consumes the batches the
    uninterrupted run would have (loss entries before the resume point are
    not replayed)."""
    from ..data.dataset import ensemble_synth_batch
    from ..parallel import spmd

    dev = torch.device(device)
    tms = [OBJECTS[n]() if isinstance(n, str) else n for n in names]
    names = [n if isinstance(n, str) else f"obj{i}"
             for i, n in enumerate(names)]
    O = len(tms)
    ens_mesh = spmd.stack_meshes(tms, dev)
    widths = [tm.diameter * 1000 * 1.1 for tm in tms]
    cfg = tr.TrainConfig(
        resolution=res, batch_size=batch, learning_rate=1e-3,
        trans_normalizer=0.02, rot_normalizer=15 * np.pi / 180,
        aug=aug if aug is not None else A.AugmentConfig())
    xyz_range = ((-0.12, 0.12), (-0.09, 0.09), (0.45, 0.85))
    Kt = torch.as_tensor(np.asarray(K), dtype=torch.float32).to(dev)
    recipe = _recipe_fingerprint(dr, cfg.aug, dev)

    def sample(*key):
        return ensemble_synth_batch(
            ens_mesh, Kt, [tr.step_generator(dev, *key, o) for o in range(O)],
            widths, batch, res, 0.02, 15.0, xyz_range, dr)

    ckpt_path = restored = None
    if ckpt_dir:
        ckpt_path = os.path.join(ckpt_dir, "ensemble_last.msgpack")
        if os.path.exists(ckpt_path):
            meta = ck.load_metadata(ckpt_path)
            if (meta.get("names") == list(names)
                    and int(meta.get("total_steps", -1)) == steps
                    and meta.get("recipe") == recipe):
                restored = ck.load_flax_checkpoint(ckpt_path)
            else:
                log(f"[ensemble x{O}] ignoring {ckpt_path}: different "
                    "names/steps/recipe")

    if restored is not None:
        mean = np.array(restored["mean"], np.float32)
        std = np.array(restored["std"], np.float32)
    else:
        zero = torch.zeros(8, device=dev)
        one = torch.ones(8, device=dev)
        batch_means = []
        for i in range(4):
            raw = sample(900, i)
            batch_means.append(torch.stack([torch.cat(tr.preprocess_batch(
                tr.step_generator(dev, i, o),
                {k: v[o] for k, v in raw.items()}, zero, one, cfg,
                train=True)[:2], -1).mean(dim=(0, 1, 2)) for o in range(O)]))
        arr = torch.stack(batch_means).cpu().numpy()  # (4, O, 8)
        mean, std = arr.mean(axis=0), arr.std(axis=0)
    mean_t = torch.as_tensor(mean).to(dev)
    std_t = torch.as_tensor(std).to(dev)

    pairs = []
    for o in range(O):
        net = tracknet.Se3TrackNet(image_size=res).to(dev)
        tracknet.init_params(net, torch.Generator().manual_seed(o))
        opt, lr_at = tr.make_optimizer(net, cfg, steps_per_epoch=10_000)
        pairs.append((net, opt))
    ens = spmd.stack_states(pairs)
    del pairs
    start_step = 0
    if restored is not None:
        _restore_ensemble(ens, restored)
        start_step = int(ck.load_metadata(ckpt_path)["step"]) + 1
        log(f"[ensemble x{O}] resumed from {ckpt_path} at step {start_step}")
    step = spmd.ensemble_train_step(ens.model, ens.opt, cfg,
                                    spmd.make_mesh(1), per_object_stats=True)

    key = 7
    losses = {n: [] for n in names}
    t0 = time.time()
    for i in range(start_step, steps):
        m = step(ens, lr_at(i),
                 [tr.step_generator(dev, key, 10**6 + i, o)
                  for o in range(O)], sample(key, i), mean_t, std_t)
        if i % 100 == 0 or i == steps - 1:
            lv = m["loss"].cpu().numpy()
            for o, n in enumerate(names):
                losses[n].append(float(lv[o]))
            log(f"[ensemble x{O}] step {i}: " + " ".join(
                f"{n}={lv[o]:.5f}" for o, n in enumerate(names))
                + f" ({time.time() - t0:.0f}s)")
        if ckpt_path and i and (i % ckpt_every == 0 or i == steps - 1):
            _ensemble_ckpt(ckpt_path, ens, mean, std, {
                "names": list(names), "step": int(i),
                "total_steps": int(steps), "batch": int(batch),
                "res": int(res), "recipe": recipe})
    train_secs = time.time() - t0

    objs = []
    for o, (n, tm) in enumerate(zip(names, tms)):
        w = float(widths[o])
        objs.append(BenchObject(
            name=n, tm=tm, mesh=rz.upload(tm, dev), model=ens.module(o).eval(),
            mean=mean_t[o], std=std_t[o], width_mm=w,
            tcfg=trk.TrackerConfig(
                resolution=res, trans_normalizer=0.02,
                rot_normalizer=15 * np.pi / 180, object_width_mm=w),
            train_secs=train_secs / O, losses=losses[n]))
    return objs


def hard_aug() -> A.AugmentConfig:
    """Augmentation stack for DR training: the reference set plus depth
    dropout (``depth_missing_prob``, off in reference training)."""
    return A.AugmentConfig(depth_missing_prob=0.15)


def ensemble_evaluate_tracking(objs, gt: np.ndarray, stacked_rgb,
                               stacked_depth, K=YCB_K,
                               init_poses=None) -> list[dict]:
    """Track every object's test video in one call and score each with the
    :func:`evaluate_tracking` protocol, on the device of the first object's
    mesh: the networks stacked (``parallel/spmd.stack_states``), the meshes
    padded to one face count (``parallel/spmd.stack_meshes``), each object
    at its own width and statistics through
    ``parallel/spmd.multi_object_track_videos`` on the one-card layout
    (serial: one ``track_video`` an object).

    ``stacked_rgb``/``stacked_depth``: (O, T, H, W[, 3]) uint8 / uint16
    arrays. ``init_poses``: (O, 4, 4) (default gt[0] for every object)."""
    from ..parallel import spmd

    dev = objs[0].mesh.fverts.device
    O = len(objs)
    ens = spmd.stack_states([o.model for o in objs])
    ens_meshes = spmd.stack_meshes([o.tm for o in objs], dev)
    mean = torch.stack([torch.as_tensor(o.mean).to(dev) for o in objs])
    std = torch.stack([torch.as_tensor(o.std).to(dev) for o in objs])
    if init_poses is None:
        init_poses = np.tile(gt[:1], (O, 1, 1))
    run = spmd.multi_object_track_videos(ens.model, objs[0].tcfg,
                                         spmd.make_mesh(1),
                                         per_object_stats=True)
    poses = run(ens, ens_meshes,
                torch.as_tensor(np.asarray(K), dtype=torch.float32).to(dev),
                mean, std,
                torch.as_tensor(np.asarray(init_poses),
                                dtype=torch.float32).to(dev),
                trk.upload_rgb(np.asarray(stacked_rgb)[:, 1:], dev),
                trk.upload_depth(np.asarray(stacked_depth)[:, 1:], dev),
                [o.width_mm for o in objs]).cpu().numpy()
    return [_score_poses(obj, gt, np.concatenate([gt[:1], poses[o]], axis=0))
            for o, obj in enumerate(objs)]


def make_gt_trajectory(T: int, seed: int = 5,
                       z0: float = 0.6) -> np.ndarray:
    """(T, 4, 4) smooth random-walk camera-frame trajectory: 6 deg/frame
    rotation, ~4 mm/frame translation with gentle direction changes — the
    motion regime the 0.02 m / 15 deg normalizers cover."""
    rng = np.random.RandomState(seed)
    gt = [np.eye(4, dtype=np.float32)]
    gt[0][:3, 3] = [0.0, 0.0, z0]
    w_vel = rng.randn(3)
    w_vel = w_vel / np.linalg.norm(w_vel) * np.deg2rad(6.0)
    t_vel = np.array([0.004, -0.003, 0.005])
    for i in range(1, T):
        prev = gt[-1]
        cur = prev.copy()
        cur[:3, :3] = se3.so3_exp(torch.as_tensor(
            w_vel, dtype=torch.float32)).numpy() @ prev[:3, :3]
        if i % 15 == 0:
            w_vel = rng.randn(3)
            w_vel = w_vel / np.linalg.norm(w_vel) * np.deg2rad(6.0)
            t_vel = rng.randn(3) * 0.004
        cur[:3, 3] = prev[:3, 3] + t_vel
        # keep the object inside the camera frustum
        cur[0, 3] = np.clip(cur[0, 3], -0.12, 0.12)
        cur[1, 3] = np.clip(cur[1, 3], -0.09, 0.09)
        cur[2, 3] = np.clip(cur[2, 3], 0.45, 0.9)
        gt.append(cur)
    return np.stack(gt)


def dropout_mask(i: int, hw) -> torch.Tensor:
    """Frame ``i``'s depth-dropout mask, (H, W) bool on the CPU, drawn from
    a CPU ``torch.Generator`` seeded ``DROPOUT_SEED + i``: the same mask on
    every device. (The JAX module draws ``jax.random.bernoulli`` with
    ``PRNGKey(1000 + i)``, which torch cannot reproduce; ROADMAP F7.)"""
    gen = torch.Generator().manual_seed(DROPOUT_SEED + i)
    return torch.rand(tuple(hw), generator=gen) < DROPOUT_P


def render_test_video(
    mesh: rz.MeshArrays,
    gt: np.ndarray,
    K=YCB_K,
    *,
    hw=(480, 640),
    hard: bool = False,
    bg_seed: int = 11,
    background: bool | None = None,
    occluder: bool | None = None,
    dropout: bool | None = None,
    lighting=None,
    drop_masks=None,
):
    """Render the observed RGB-D video for a gt trajectory, on the mesh's
    device. Returns rgb (T, H, W, 3) in [0, 255] and depth (T, H, W) mm,
    float32.

    ``hard`` builds the robustness scene: a fixed textured background at
    valid sensor depth, an occluder sphere sweeping past (grazing the
    object's edge: partial occlusion), and per-frame depth dropout. The
    three can also be switched one by one. ``lighting``: optional (5,)
    [ambient, diffuse, lx, ly, lz] override for the observed render.
    ``drop_masks``: optional (T, H, W) bool dropout masks (default
    :func:`dropout_mask` per frame), so a test can pass in JAX's own."""
    background = hard if background is None else background
    occluder = hard if occluder is None else occluder
    dropout = hard if dropout is None else dropout
    hard = background or occluder or dropout
    dev = mesh.fverts.device
    H, W = hw
    window = rz.full_frame_window(W, H)
    Kt = torch.as_tensor(np.asarray(K), dtype=torch.float32).to(dev)

    def render(m, pose):
        return rz.render(m, torch.as_tensor(pose, dtype=torch.float32).to(dev),
                         Kt, window, out_hw=hw, lighting=lighting,
                         worklist=True)

    if not hard:
        frames = [render(mesh, gt[i]) for i in range(len(gt))]
        return (torch.stack([f[0] for f in frames]),
                torch.stack([f[1] for f in frames]))

    occ = rz.upload(M.make_icosphere(subdiv=2, radius=0.018), dev)
    bg_rgb = torch.from_numpy(
        _procedural_texture(np.random.RandomState(bg_seed), H, W)).to(dev)
    bg_depth = 1500.0

    def render_hard(pose, i):
        r_obj, d_obj = render(mesh, pose)
        do = torch.where(d_obj > 0, d_obj, torch.inf)
        rgb, depth = r_obj, do
        if occluder:
            # the occluder sweeps laterally, grazing the object's lower edge
            # (partial occlusion)
            phase = 2 * np.pi * i / 40.0
            occ_pose = np.eye(4, dtype=np.float32)
            occ_pose[:3, 3] = pose[:3, 3] * 0.62 + np.array(
                [0.055 * np.cos(phase), 0.030 + 0.004 * np.sin(2 * phase),
                 0.0], np.float32)
            r_occ, d_occ = render(occ, occ_pose)
            dc = torch.where(d_occ > 0, d_occ, torch.inf)
            rgb = torch.where((dc < do)[..., None], r_occ, r_obj)
            depth = torch.minimum(do, dc)
        hit = torch.isfinite(depth)
        if background:
            rgb = torch.where(hit[..., None], rgb, bg_rgb)
            depth = torch.where(hit, depth, bg_depth)
        else:
            rgb = torch.where(hit[..., None], rgb, 0.0)
            depth = torch.where(hit, depth, 0.0)
        if dropout:
            drop = (dropout_mask(i, hw) if drop_masks is None
                    else torch.as_tensor(np.asarray(drop_masks[i])))
            depth = torch.where(drop.to(dev), 0.0, depth)
        return rgb, depth

    frames = [render_hard(gt[i], i) for i in range(len(gt))]
    return (torch.stack([f[0] for f in frames]),
            torch.stack([f[1] for f in frames]))


def _score_poses(obj: BenchObject, gt: np.ndarray,
                 poses: np.ndarray) -> dict:
    """ADD / ADD-S per frame + VOCap AUC for a (T, 4, 4) estimate
    trajectory, with the hold-init drift baseline for context, computed on
    the device of the object's mesh."""
    dev = obj.mesh.fverts.device
    cloud = M.voxel_down_sample(obj.tm.verts, 0.005)
    add, adi = ME.batch_errors(poses, gt, cloud, device=dev)
    base_add, _ = ME.batch_errors(np.tile(gt[:1], (len(gt), 1, 1)), gt,
                                  cloud, device=dev)
    return {
        "name": obj.name,
        "poses": poses,
        "add": add,
        "adi": adi,
        "add_auc": float(ME.vocap(add) * 100),
        "adi_auc": float(ME.vocap(adi) * 100),
        "add_mean_mm": float(add.mean() * 1000),
        "add_max_mm": float(add.max() * 1000),
        "final_trans_err_mm": float(
            np.linalg.norm(poses[-1][:3, 3] - gt[-1][:3, 3]) * 1000),
        "baseline_add_mean_mm": float(base_add.mean() * 1000),
        "baseline_add_auc": float(ME.vocap(base_add) * 100),
    }


def _quantize(rgb, dep):
    """Observed video at sensor precision: uint8 RGB and uint16 mm depth,
    as numpy (round half to even, then clip, as the JAX module)."""
    rgb = torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)
    dep = torch.clamp(torch.round(dep), 0, 65535).to(torch.int32)
    return rgb.cpu().numpy(), dep.cpu().numpy().astype(np.uint16)


def evaluate_tracking(obj: BenchObject, gt: np.ndarray, frames_rgb,
                      frames_depth, K=YCB_K, init_pose=None) -> dict:
    """Track frames 1.. from ``init_pose`` (default gt[0]) on the device of
    the object's mesh and score ADD / ADD-S per frame + VOCap AUC, with the
    hold-init drift baseline for context. Frames are host arrays (uint8 RGB,
    uint16 mm depth, as :func:`_quantize` gives them)."""
    if init_pose is None:
        init_pose = gt[0]
    dev = obj.mesh.fverts.device
    poses = trk.track_video(
        obj.model, obj.tcfg, obj.mesh,
        torch.as_tensor(np.asarray(K), dtype=torch.float32).to(dev),
        obj.mean, obj.std,
        torch.as_tensor(np.asarray(init_pose), dtype=torch.float32).to(dev),
        trk.upload_rgb(frames_rgb[1:], dev),
        trk.upload_depth(frames_depth[1:], dev))
    poses = np.concatenate([gt[:1], poses.cpu().numpy()], axis=0)
    return _score_poses(obj, gt, poses)


def _init_pose_np(draws_seed: int, pose, sensor) -> np.ndarray:
    """A noisy initialization of ``pose`` (``domain_shift.noisy_init_pose``)
    drawn from a CPU generator seeded ``draws_seed``: the same on every
    device. (The JAX module draws from ``PRNGKey(draws_seed)``; F7.)"""
    return DS.noisy_init_pose(torch.Generator().manual_seed(draws_seed), pose,
                              sensor).numpy()


def _shifted_eval(obj: BenchObject, gt, rgb, dep, sm, video_seed: int,
                  init_seed: int, K) -> dict:
    """``evaluate_tracking`` of a rendered video through the sensor model
    ``sm`` (noise drawn on the video's device from ``video_seed``),
    quantized, from a noisy initialization drawn from ``init_seed``."""
    rgb_s, dep_s = _quantize(*DS.shift_video(rgb, dep, gt, K, sm,
                                             seed=video_seed))
    return evaluate_tracking(obj, gt, rgb_s, dep_s, K=K,
                             init_pose=_init_pose_np(init_seed, gt[0], sm))


def shift_severity_sweep(obj: BenchObject, gt: np.ndarray, *,
                         hard: bool = True,
                         severities=(0.5, 1.0, 2.0, 4.0),
                         sensor=None, seed: int = 0, K=YCB_K,
                         hw=(480, 640), log=_print_flush) -> list[dict]:
    """AUC against severity: the tracker under the sensor model scaled to
    each severity (``domain_shift.SensorModel.scaled``). Each severity
    renders the observed video again (its lighting moves with s), shifts it
    (noise seeded 2000 + seed + 100 s) and draws a noisy initialization of
    the scaled size (seed 700 + seed + 100 s). Textured objects get one more
    row, ``"tex_hostile"`` (``domain_shift.texture_hostile``, seeds + 9999):
    the shift that attacks the UV appearance cue."""
    base = sensor if sensor is not None else DS.SensorModel()
    points = [(float(s), base.scaled(float(s))) for s in severities]
    if obj.tm.texture is not None:
        points.append(("tex_hostile", DS.texture_hostile(base)))
    dev = obj.mesh.fverts.device
    rows = []
    for tag, sm in points:
        rgb, dep = render_test_video(obj.mesh, gt, K=K, hw=hw, hard=hard,
                                     lighting=sm.lighting(dev))
        sd = seed + (int(tag * 100) if isinstance(tag, float) else 9999)
        r = _shifted_eval(obj, gt, rgb, dep, sm, 2000 + sd, 700 + sd, K)
        rows.append({
            "severity": tag,
            "add_auc": r["add_auc"],
            "adi_auc": r["adi_auc"],
            "add_mean_mm": r["add_mean_mm"],
            "final_trans_err_mm": r["final_trans_err_mm"],
        })
        log(f"[{obj.name}] shift x{tag}: ADD AUC {r['add_auc']:.2f} "
            f"ADD-S {r['adi_auc']:.2f} mean {r['add_mean_mm']:.1f}mm")
    return rows


SHIFT_AXES = {
    "lighting": ("ambient", "diffuse", "light_cam"),
    "photometric": ("exposure_amp", "wb_amp", "gamma", "rgb_noise_std",
                    "wb_const"),
    "blur": ("motion_blur_px",),
    "depth": ("depth_quant_mm", "edge_dropout_prob", "depth_warp_amp",
              "depth_noise_mm", "dropout_prob"),
    "init": ("init_trans_m", "init_rot_deg"),
}


def shift_axis_ablation(obj: BenchObject, gt: np.ndarray, *,
                        severity: float = 2.0, hard: bool = True,
                        sensor=None, seed: int = 0, K=YCB_K, hw=(480, 640),
                        log=_print_flush) -> list[dict]:
    """Which shift axis kills tracking at ``severity``: the tracker under
    single-axis sensor models, every field at its nominal (severity 0) value
    but one axis group (:data:`SHIFT_AXES`) at the full severity, anchored
    by ``"none"`` (all nominal) and ``"full"`` (all at severity). Only the
    lighting changes the render, so renders are cached by lighting. Noise
    seeded 3000 + seed, the initialization 800 + seed."""
    base = sensor if sensor is not None else DS.SensorModel()
    full = base.scaled(float(severity))
    nominal = base.scaled(0.0)
    axes = ([("none", ())] + list(SHIFT_AXES.items())
            + [("full", tuple(x for f in SHIFT_AXES.values() for x in f))])
    dev = obj.mesh.fverts.device
    render_cache = {}
    rows = []
    for name, fields in axes:
        sm = dataclasses.replace(
            nominal, **{f: getattr(full, f) for f in fields})
        lkey = tuple(sm.lighting().tolist())
        if lkey not in render_cache:
            render_cache[lkey] = render_test_video(
                obj.mesh, gt, K=K, hw=hw, hard=hard,
                lighting=sm.lighting(dev))
        rgb, dep = render_cache[lkey]
        r = _shifted_eval(obj, gt, rgb, dep, sm, 3000 + seed, 800 + seed, K)
        rows.append({
            "axis": name,
            "severity": float(severity),
            "add_auc": r["add_auc"],
            "adi_auc": r["adi_auc"],
            "add_mean_mm": r["add_mean_mm"],
        })
        log(f"[{obj.name}] shift-ablation x{severity} {name}: "
            f"ADD AUC {r['add_auc']:.2f} mean {r['add_mean_mm']:.1f}mm")
    return rows


def recovery_auc_text(row: dict) -> str:
    """A recovery row's post-recovery ADD AUC for a log line, or "not
    recovered" (never ``nan``)."""
    if not row["recovered"]:
        return "not recovered"
    return f"post-recovery ADD AUC {row['post_recovery_add_auc']:.2f}"


def run_suite(
    object_names=("cube", "box", "lshape", "icosahedron"),
    *,
    steps: int = 5_000,
    frames: int = 120,
    batch: int = 200,
    res: int = 176,
    hard: bool = True,
    log=_print_flush,
    on_result=None,
    ensemble: bool = False,
    ensemble_ckpt_dir: str | None = None,
    domain_shift: bool = False,
    shift_sensor=None,
    long_horizon_frames: int = 0,
    shift_sweep=(),
    sweep_objects=("cube", "lshape", "textured_box"),
    recovery_objects=(),
    live_recovery_objects=(),
    ablation_objects=(),
    K=YCB_K,
    hw=(480, 640),
    device="cuda",
) -> list[dict]:
    """Train, track and score each object on ``device``: the accuracy table,
    one dict per object (the JAX ``run_suite``'s keys).

    Defaults are the measured recipe: batch 200 for 5,000 steps, 1M DR
    pairs an object. ``ensemble``: the untextured objects train at once
    (:func:`train_objects_ensemble`, checkpointed to
    ``ensemble_ckpt_dir``) and their matched (and domain-shifted) videos
    are tracked in one call (:func:`ensemble_evaluate_tracking`);
    textured objects cannot ride the ensemble (``stack_meshes`` bakes
    their textures, which would train on baked renders and test on the
    real texture), so they train with :func:`train_object` and evaluate
    alone. Each row's ``eval_path`` says which: ``"ensemble"``,
    ``"sequential"``, or ``"sequential_fallback"`` where the ensemble
    evaluation ran out of device memory (``torch.OutOfMemoryError``, the
    one failure caught; anything else raises). Without ``ensemble``,
    ``ensemble_ckpt_dir`` is :func:`train_object`'s checkpoint directory
    (each object resumes from its own file). ``domain_shift``: also score
    each object on a shifted video (other lighting, photometric drift,
    sensor-model depth, motion blur, noisy initialization;
    ``eval/domain_shift.py``) -> ``domain_shifted``.
    ``long_horizon_frames`` > 0: the closed-loop long-horizon protocol on
    every object -> ``long_horizon``; on ``recovery_objects`` also with a
    forced 15-frame occlusion burst a third of the way in -> ``recovery``,
    and on ``live_recovery_objects`` the same burst through the live path
    -> ``live_recovery``. ``shift_sweep``: severities of the sweep on
    ``sweep_objects`` -> ``shift_sweep``. ``ablation_objects``: the x2
    single-axis ablation -> ``shift_ablation``. ``on_result(rows)`` is
    called after every object (incremental persistence).

    Beyond the JAX signature: ``K`` and ``hw``, the camera and frame size
    of every test video (the JAX suite fixes YCB's), and ``device``."""
    unknown = [n for n in object_names if n not in OBJECTS]
    if unknown:  # fail before hours of training, not at the bad name
        raise KeyError(
            f"unknown object(s) {unknown}; available: {sorted(OBJECTS)}")
    dr = DRComposite() if hard else None
    aug = hard_aug() if hard else None
    sensor = shift_sensor if shift_sensor is not None else DS.SensorModel()
    gt = make_gt_trajectory(frames)

    objs = None
    if ensemble:
        plain_names = [n for n in object_names
                       if OBJECTS[n]().texture is None]
        tex_names = [n for n in object_names if n not in plain_names]
        by_name = {}
        if plain_names:
            by_name.update(zip(plain_names, train_objects_ensemble(
                plain_names, K, steps=steps, batch=batch, res=res, dr=dr,
                aug=aug, log=log, ckpt_dir=ensemble_ckpt_dir,
                device=device)))
        for i, n in enumerate(tex_names):
            by_name[n] = train_object(
                OBJECTS[n](), K, name=n, steps=steps, batch=batch, res=res,
                dr=dr, aug=aug, seed_offset=len(plain_names) + i, log=log,
                ckpt_dir=ensemble_ckpt_dir, device=device)
        objs = [by_name[n] for n in object_names]

    def shifted_video(obj, idx):
        """The domain-shifted video (noise seeded 100 + idx) and the noisy
        initialization (seeded 500 + idx) of object ``idx``."""
        rgb2, dep2 = render_test_video(
            obj.mesh, gt, K, hw=hw, hard=hard,
            lighting=sensor.lighting(obj.mesh.fverts.device))
        rgb_s, dep_s = _quantize(*DS.shift_video(rgb2, dep2, gt, K, sensor,
                                                 seed=100 + idx))
        return rgb_s, dep_s, _init_pose_np(500 + idx, gt[0], sensor)

    # The ensemble evaluation: one call tracks every untextured object's
    # matched video, one more the shifted ones.
    ens_matched, ens_shifted, ens_fallback = {}, {}, False
    if objs is not None:
        plain = [(i, o) for i, o in enumerate(objs) if o.tm.texture is None]
        try:
            if plain:
                sub = [o for _, o in plain]
                vids = [_quantize(*render_test_video(o.mesh, gt, K, hw=hw,
                                                     hard=hard)) for o in sub]
                ens_matched = dict(zip([i for i, _ in plain],
                                       ensemble_evaluate_tracking(
                                           sub, gt,
                                           np.stack([v[0] for v in vids]),
                                           np.stack([v[1] for v in vids]),
                                           K=K)))
                del vids
                if domain_shift:
                    svids = [shifted_video(o, i) for i, o in plain]
                    ens_shifted = dict(zip([i for i, _ in plain],
                                           ensemble_evaluate_tracking(
                                               sub, gt,
                                               np.stack([v[0] for v in svids]),
                                               np.stack([v[1] for v in svids]),
                                               K=K, init_poses=np.stack(
                                                   [v[2] for v in svids]))))
                    del svids
        except torch.OutOfMemoryError as e:
            log(f"ensemble eval ran out of device memory ({e!r}); falling "
                "back to sequential per-object eval: rows carry "
                "eval_path='sequential_fallback'")
            ens_matched, ens_shifted, ens_fallback = {}, {}, True
    seq_path = "sequential_fallback" if ens_fallback else "sequential"

    results = []
    for idx, name in enumerate(object_names):
        if objs is not None:
            obj = objs[idx]
        else:
            obj = train_object(
                OBJECTS[name](), K, name=name, steps=steps, batch=batch,
                res=res, dr=dr, aug=aug, seed_offset=idx, log=log,
                ckpt_dir=ensemble_ckpt_dir, device=device)
        dev = obj.mesh.fverts.device
        if idx in ens_matched:
            r = ens_matched[idx]
            r["eval_path"] = "ensemble"
        else:
            frames_rgb, frames_depth = _quantize(*render_test_video(
                obj.mesh, gt, K, hw=hw, hard=hard))
            r = evaluate_tracking(obj, gt, frames_rgb, frames_depth, K=K)
            r["eval_path"] = seq_path
        r["train_secs"] = obj.train_secs
        r["symmetric"] = name in SYMMETRIC_OBJECTS
        r.pop("poses")
        # JSON-serializable per-frame curves
        r["add"] = [float(v) for v in r["add"]]
        r["adi"] = [float(v) for v in r["adi"]]
        log(f"[{name}] ADD AUC {r['add_auc']:.2f} "
            f"ADD-S AUC {r['adi_auc']:.2f} "
            f"mean {r['add_mean_mm']:.1f}mm "
            f"(hold-init {r['baseline_add_mean_mm']:.1f}mm)")
        if domain_shift:
            if idx in ens_shifted:
                rs, shift_path = ens_shifted[idx], "ensemble"
            else:
                rgb_s, dep_s, init = shifted_video(obj, idx)
                rs = evaluate_tracking(obj, gt, rgb_s, dep_s, K=K,
                                       init_pose=init)
                shift_path = seq_path
            r["domain_shifted"] = {
                k: rs[k] for k in (
                    "add_auc", "adi_auc", "add_mean_mm", "add_max_mm",
                    "final_trans_err_mm")
            }
            r["domain_shifted"]["eval_path"] = shift_path
            log(f"[{name}] domain-shifted: "
                f"ADD AUC {rs['add_auc']:.2f} "
                f"ADD-S AUC {rs['adi_auc']:.2f} "
                f"mean {rs['add_mean_mm']:.1f}mm (noisy init, shifted "
                f"lighting/sensor)")
        if shift_sweep and name in sweep_objects:
            r["shift_sweep"] = shift_severity_sweep(
                obj, gt, hard=hard, severities=shift_sweep, sensor=sensor,
                seed=idx, K=K, hw=hw, log=log)
        if name in ablation_objects:
            r["shift_ablation"] = shift_axis_ablation(
                obj, gt, severity=2.0, hard=hard, sensor=sensor, seed=idx,
                K=K, hw=hw, log=log)
        if long_horizon_frames:
            gt_lh = make_gt_trajectory(long_horizon_frames, seed=17)
            rgb_lh, dep_lh = render_test_video(
                obj.mesh, gt_lh, K, hw=hw, hard=hard,
                lighting=sensor.lighting(dev) if domain_shift else None)
            if domain_shift:
                rgb_lh, dep_lh = DS.shift_video(rgb_lh, dep_lh, gt_lh, K,
                                                sensor, seed=777)
            rgb_lh, dep_lh = _quantize(rgb_lh, dep_lh)
            lh = r["long_horizon"] = DS.long_horizon_eval(
                obj, gt_lh, rgb_lh, dep_lh, K, reinit_sensor=sensor)
            log(f"[{name}] long-horizon {lh['frames']}fr: "
                f"ADD AUC {lh['add_auc']:.2f} "
                f"reinit x{lh['reinit_count']}")
            if name in recovery_objects:
                # a forced 15-frame full-occlusion burst a third of the way
                # in: detection latency and post-recovery AUC
                rc = r["recovery"] = DS.long_horizon_eval(
                    obj, gt_lh, rgb_lh, dep_lh, K, reinit_sensor=sensor,
                    fail_at=long_horizon_frames // 3, fail_len=15)
                log(f"[{name}] recovery (occlusion burst @"
                    f"{rc['fail_at']}+{rc['fail_len']}): detected in "
                    f"{rc['detection_latency']} frames, recovered at "
                    f"{rc['recovered_at']}, {recovery_auc_text(rc)}, "
                    f"reinit x{rc['reinit_count']}")
            if name in live_recovery_objects:
                # the same burst through the live path: latency quantized
                # by patience x refetch_every + the fetch's round trip
                lv = r["live_recovery"] = DS.live_recovery_eval(
                    obj, gt_lh, rgb_lh, dep_lh, K, reinit_sensor=sensor,
                    fail_at=long_horizon_frames // 3, fail_len=15)
                log(f"[{name}] LIVE recovery (burst @{lv['fail_at']}+"
                    f"{lv['fail_len']}, samples={lv['samples']}, "
                    f"refetch_every={lv['refetch_every']}): detected in "
                    f"{lv['detection_latency']} frames, reinit applied "
                    f"at {lv['reinit_applied_at']}, "
                    f"{recovery_auc_text(lv)}")
        results.append(r)
        if on_result is not None:  # incremental persistence for long runs
            on_result(list(results))
    return results
