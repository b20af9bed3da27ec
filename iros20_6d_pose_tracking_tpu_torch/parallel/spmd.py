"""Scale-out over the ranks of ``torch.distributed``, and object ensembles
and batched videos on one card, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/parallel/spmd.py``. The JAX
module lays its devices out as a 2-D ("obj", "dp") ``jax.sharding.Mesh`` and
lets GSPMD place the collectives. Here the layout is a :class:`Mesh` of
ranks, one process a rank, and every collective is written out:

  - **dp**: data parallelism. The parameters are replicated, the batch is
    split over the ranks. :func:`dp_train_step` equals the single-device
    ``train/trainer.train_step`` on the whole batch: BatchNorm normalizes
    with the statistics of the whole batch (sync BatchNorm, through
    ``models/tracknet.BatchNorm2d.sync``), the loss and the gradients are
    global means, and every rank takes its rows of the whole batch's
    augmentation draws (ROADMAP F7). Plain DDP with per-rank BatchNorm
    would not equal the single device, and is not used.
  - **obj**: the object ensemble. se(3)-TrackNet is trained per object, so
    O networks of one architecture are stacked (:class:`EnsembleState`)
    and split over "obj"; each object's batch splits over "dp".

On one card (:func:`make_mesh` ``(1)``, no process group) the ensemble is a
batch axis: :func:`ensemble_train_step` and :func:`multi_object_track_videos`
run the O networks one after the other (``serial``, JAX's default on one
device) or at once, through ``torch.func.stack_module_state`` and ``vmap``
of ``functional_call`` (their convolutions become grouped ones);
:func:`batched_track_videos` and the batched :func:`multi_object_track_videos`
step V videos, or O objects, per frame as one batch of views: V crops, each
from its own video's frame, V views in one K1 and one ``pass2_shade``
launch, the CNN at batch V and the decode over V.

Across ranks the caller initialises ``torch.distributed`` and picks the
backend (NCCL for CUDA, gloo for the CPU); this module never switches
backend and never moves a tensor to the CPU when a collective fails.
Every rank is handed the whole of the inputs and takes its part itself
(:func:`shard_pytree`), as JAX's functions take global arrays; results
come back whole on every rank.
"""
from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call, stack_module_state, vmap

from ..core import se3
from ..data import augment as aug
from ..models import tracknet
from ..render import mesh as mesh_mod
from ..render import rasterizer as rz
from ..tracking import tracker as trk
from ..train import trainer as tr

AXES = ("obj", "dp")


@dataclass(frozen=True)
class Mesh:
    """``obj * dp`` ranks laid out as the ("obj", "dp") grid: rank r sits at
    (r // dp, r % dp). ``dp_group`` is the process group of this rank's row
    (the ranks that split one object's batch), None where a row is one
    rank. The one-rank layout needs no process group."""

    obj: int = 1
    dp: int = 1
    rank: int = 0
    dp_group: object = None
    axis_names: tuple = AXES

    @property
    def size(self) -> int:
        return self.obj * self.dp

    def axis_size(self, axis) -> int:
        """The ranks along ``axis``: "obj", "dp", or ("obj", "dp")."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        return int(np.prod([{"obj": self.obj, "dp": self.dp}[a]
                            for a in axes]))

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis`` (("obj", "dp"): the rank)."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        where = {"obj": self.rank // self.dp, "dp": self.rank % self.dp}
        out = 0
        for a in axes:
            out = out * self.axis_size(a) + where[a]
        return out


def world_size() -> int:
    """Ranks of the default process group; 1 where none is initialised."""
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def make_mesh(n_devices: int | None = None, obj: int = 1) -> Mesh:
    """The ("obj", "dp") layout of ``n_devices`` ranks (default: every rank
    of the process group), ``obj`` rows of ``n_devices / obj``. ``1`` is the
    one-card layout and works with or without a process group; any other
    count must be the process group's size. Every rank must call this in
    the same order (it makes the rows' groups)."""
    world = world_size()
    n = world if n_devices is None else int(n_devices)
    if n != 1 and n != world:
        raise ValueError(f"a layout of {n} ranks needs a process group of "
                         f"{n}; this one has {world}")
    if obj <= 0 or n % obj:
        raise ValueError(f"{n} ranks not divisible into obj={obj}")
    dp = n // obj
    if n == 1:
        return Mesh()
    rank = dist.get_rank()
    mine = None
    if dp > 1:
        for o in range(obj):
            group = dist.new_group(list(range(o * dp, (o + 1) * dp)))
            if o == rank // dp:
                mine = group
    return Mesh(obj, dp, rank, mine)


# ---------------------------------------------------------------------------
# The ensemble's state.
# ---------------------------------------------------------------------------

@dataclass
class EnsembleState:
    """O networks of one architecture as stacked tensors (the JAX stacked
    ``TrainState``): ``params`` (O, ...) leaves that take gradients,
    ``buffers`` (O, ...) BatchNorm statistics, ``opt`` one Adam over the
    stacked leaves or None (Adam is elementwise: one optimizer over the
    stacked leaves steps each object as its own optimizer would), and
    ``model`` the architecture on the meta device, run on object o's
    tensors by ``torch.func.functional_call``."""

    model: tracknet.Se3TrackNet
    params: dict
    buffers: dict
    opt: torch.optim.Optimizer | None = None

    def __len__(self) -> int:
        return next(iter(self.params.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def tensors(self, o: int) -> tuple[dict, dict]:
        """Object o's parameters and buffers, views of the stacked ones."""
        return ({k: v[o] for k, v in self.params.items()},
                {k: v[o] for k, v in self.buffers.items()})

    def module(self, o: int) -> tracknet.Se3TrackNet:
        """Object o's network as a module of its own (copies), in the
        training mode of ``model``."""
        net = copy.deepcopy(self.model).to_empty(device=self.device)
        p, b = self.tensors(o)
        net.load_state_dict({k: v.detach() for k, v in {**p, **b}.items()},
                            strict=True)
        return net

    def select(self, objs: slice) -> "EnsembleState":
        """The objects ``objs`` as an ensemble of their own: new leaves,
        and a new optimizer with their slices of the optimizer's state."""
        params = {k: v[objs].detach().clone().requires_grad_(v.requires_grad)
                  for k, v in self.params.items()}
        buffers = {k: v[objs].clone() for k, v in self.buffers.items()}
        opt = None
        if self.opt is not None:
            opt = _adam_like(self.opt, params)
            for name, p in self.params.items():
                st = self.opt.state.get(p)
                if st:
                    opt.state[params[name]] = {
                        k: (v.clone() if k == "step" else v[objs].clone())
                        for k, v in st.items()}
        return EnsembleState(self.model, params, buffers, opt)


def _adam_like(opt: torch.optim.Optimizer, params: dict):
    """A fresh Adam over ``params`` with ``opt``'s hyperparameters."""
    group = opt.param_groups[0]
    return torch.optim.Adam(
        list(params.values()), lr=group["lr"], betas=group["betas"],
        eps=group["eps"], weight_decay=group["weight_decay"],
        amsgrad=group["amsgrad"])


def stack_states(states: list) -> EnsembleState:
    """Stack per-object networks into an ensemble (leading object axis).
    ``states`` holds ``(model, optimizer)`` pairs, or bare models (then the
    ensemble has no optimizer). The optimizers must be Adams with the same
    hyperparameters; their state, where they have stepped, is stacked."""
    pairs = [s if isinstance(s, (tuple, list)) else (s, None) for s in states]
    models = [m for m, _ in pairs]
    params, buffers = stack_module_state(models)
    base = copy.deepcopy(models[0]).to("meta")
    opts = [o for _, o in pairs]
    opt = None
    if all(o is not None for o in opts):
        opt = _adam_like(opts[0], params)
        for name in params:
            per = [o.state.get(dict(m.named_parameters())[name])
                   for o, m in zip(opts, models)]
            if all(per):
                opt.state[params[name]] = {
                    "step": per[0]["step"].clone(),
                    **{k: torch.stack([s[k] for s in per])
                       for k in per[0] if k != "step"}}
    return EnsembleState(base, params, buffers, opt)


# ---------------------------------------------------------------------------
# Sharding, gathering, collectives.
# ---------------------------------------------------------------------------

def _map(fn, tree):
    """``fn`` over the tensors and arrays of nested dicts, lists, tuples and
    named tuples (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _part(length: int, mesh: Mesh, axis) -> slice:
    """This rank's slice of ``length`` rows split evenly along ``axis``."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    if length % n:
        raise ValueError(f"{length} rows do not split over {n} ranks "
                         f"along {axis}")
    k = length // n
    return slice(i * k, (i + 1) * k)


def shard_pytree(tree, mesh: Mesh, leading_axis):
    """This rank's part of a tree: every array or tensor of rank >= 1 keeps
    its slice of the leading axis split along ``leading_axis`` ("obj",
    "dp" or ("obj", "dp")); ``None`` keeps the whole tree (replicated). An
    :class:`EnsembleState` keeps its objects (:meth:`EnsembleState.select`).
    """
    if leading_axis is None or mesh.axis_size(leading_axis) == 1:
        return tree

    def take(x):
        if isinstance(x, EnsembleState):
            return x.select(_part(len(x), mesh, leading_axis))
        if getattr(x, "ndim", 0) < 1:
            return x
        return x[_part(x.shape[0], mesh, leading_axis)]

    return _map(take, tree)


def gather(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """Every rank's part along ``axis`` ("obj" or ("obj", "dp")),
    concatenated in the axis's order (the inverse of
    :func:`shard_pytree`); along "obj" the rows' first ranks give the
    parts."""
    if mesh.axis_size(axis) == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x)
    ranks = ([o * mesh.dp for o in range(mesh.obj)] if axis == "obj"
             else range(mesh.size))
    return torch.cat([parts[r] for r in ranks])


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks of ``group``, in autograd: the gradient of a
    sum over ranks is the sum over ranks of the gradients. Under ``vmap``
    the stacked tensor is reduced whole (the sum is elementwise across
    ranks), so the batched ensemble step may call it."""

    @staticmethod
    def forward(x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _AllReduceSum.apply(x, group), in_dims[0]


@contextlib.contextmanager
def synced_batchnorm(model: torch.nn.Module, group, ranks: int):
    """BatchNorm in train mode over the batch of ``ranks`` ranks of
    ``group`` (None: every rank) while the block runs; nothing where
    ``ranks`` is 1."""
    bns = [m for m in model.modules() if isinstance(m, tracknet.BatchNorm2d)]
    if ranks > 1:
        for m in bns:
            m.sync = (lambda t: _AllReduceSum.apply(t, group), ranks)
    try:
        yield
    finally:
        for m in bns:
            m.__dict__.pop("sync", None)


def _all_reduce_grads(params, group, ranks: int):
    """Sum the gradients of ``params`` over the ranks in one collective."""
    grads = [p.grad for p in params if p.grad is not None]
    if ranks == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _mean_over(x: torch.Tensor, group, ranks: int) -> torch.Tensor:
    """The mean of ``x`` over the ranks."""
    if ranks == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x / ranks


def _rows(tree, part: slice):
    """Rows ``part`` of every array and tensor of a tree (a batch, or its
    draws)."""
    return _map(lambda x: x[part], tree)


def _set_lr(opt: torch.optim.Optimizer, lr: float):
    for group in opt.param_groups:
        group["lr"] = lr


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

def dp_train_step(model: tracknet.Se3TrackNet, opt: torch.optim.Optimizer,
                  cfg: tr.TrainConfig, mesh: Mesh):
    """The data-parallel train step: replicated parameters (every rank's
    ``model`` and ``opt`` start equal), the batch split over every rank of
    ``mesh`` (both axes).

    Returns ``step(lr, gen, raw, mean, std, aug_draws=None) -> metrics``:
    ``raw`` the whole batch, whose length must divide by ``mesh.size``;
    ``gen`` draws the whole batch's augmentation on every rank (or
    ``aug_draws`` gives them), and each rank applies its rows. One update
    of ``model`` and ``opt`` in place that equals ``trainer.train_step`` on
    the whole batch (the same bits on one rank): sync BatchNorm, the loss
    scaled by 1 / ranks and the gradients summed over the ranks. The
    metrics ({"loss", "trans", "rot"}, 0-d) are the whole batch's."""
    ranks = mesh.size

    def step(lr, gen, raw, mean, std, aug_draws=None):
        n = len(raw["rgbB"])
        part = _part(n, mesh, AXES)
        if aug_draws is None:
            aug_draws = aug.draw_augment(
                gen, n, tuple(raw["depthB"].shape[1:]), cfg.aug, mean.device)
        bufA, bufB, t_label, r_label = tr.preprocess_batch(
            None, _rows(raw, part), mean, std, cfg, train=True,
            aug_draws=_rows(aug_draws, part))
        model.train()
        with synced_batchnorm(model, None, ranks):
            out = model(bufA, bufB)
            loss, parts = tracknet.loss_fn(out["trans"], out["rot"], t_label,
                                           r_label, cfg.trans_loss_weight,
                                           cfg.rot_loss_weight)
            opt.zero_grad(set_to_none=True)
            (loss / ranks).backward()
        _all_reduce_grads(model.parameters(), None, ranks)
        _set_lr(opt, lr)
        opt.step()
        m = _mean_over(torch.stack([loss, parts["trans"], parts["rot"]])
                       .detach(), None, ranks)
        return {"loss": m[0], "trans": m[1], "rot": m[2]}

    return step


def ensemble_train_step(model: tracknet.Se3TrackNet,
                        opt: torch.optim.Optimizer, cfg: tr.TrainConfig,
                        mesh: Mesh, per_object_stats: bool = False,
                        serial: bool | None = None):
    """The object-ensemble x data-parallel train step. ``model`` and ``opt``
    are an :class:`EnsembleState`'s architecture and optimizer.

    Returns ``step(state, lr, gens, raw, mean, std, aug_draws=None) ->
    metrics``: ``state`` holds this rank's objects (``shard_pytree(state,
    mesh, "obj")``); ``raw`` the whole batch (O, N, ...); ``gens`` O
    generators, object o's augmentation drawn on ``gens[o]`` for its whole
    batch (or ``aug_draws[o]`` given); ``mean``/``std`` (8,) shared, or
    (O, 8) with ``per_object_stats``. Objects split over "obj", each
    object's batch over "dp" as in :func:`dp_train_step`. The metrics
    ("loss", "trans", "rot") are (O,), every object's, on every rank.

    ``serial`` (default: one rank): the objects one after the other, each
    through ``functional_call`` on its own tensors: the same bits as O
    ``trainer.train_step`` calls on the same device. ``serial=False``: one
    ``vmap`` of ``functional_call`` over the objects (grouped
    convolutions; BatchNorm's stacked buffers are passed in batched, so
    each object updates its own). Either way one Adam step over the
    stacked leaves."""
    if serial is None:
        serial = mesh.size == 1
    dp, group = mesh.dp, mesh.dp_group

    def forward_loss(params, buffers, A, B, t_label, r_label):
        out = functional_call(model, (params, buffers), (A, B))
        loss, parts = tracknet.loss_fn(out["trans"], out["rot"], t_label,
                                       r_label, cfg.trans_loss_weight,
                                       cfg.rot_loss_weight)
        return loss, parts["trans"], parts["rot"]

    def step(state: EnsembleState, lr, gens, raw, mean, std, aug_draws=None):
        O = len(raw["rgbB"])
        objs = range(O)[_part(O, mesh, "obj")]
        if len(state) != len(objs):
            raise ValueError(f"the state holds {len(state)} objects; this "
                             f"rank's share of {O} is {len(objs)} "
                             "(shard_pytree(state, mesh, 'obj'))")
        n = raw["rgbB"].shape[1]
        part = _part(n, mesh, "dp")
        dev = state.device
        bufs = []
        for o in objs:
            draws = aug_draws[o] if aug_draws is not None else \
                aug.draw_augment(gens[o], n, tuple(raw["depthB"].shape[2:]),
                                 cfg.aug, dev)
            mn, sd = (mean[o], std[o]) if per_object_stats else (mean, std)
            bufs.append(tr.preprocess_batch(
                None, _rows({k: v[o] for k, v in raw.items()}, part), mn, sd,
                cfg, train=True, aug_draws=_rows(draws, part)))
        model.train()
        opt.zero_grad(set_to_none=True)
        with synced_batchnorm(model, group, dp):
            if serial:
                rows = []
                for j, b in enumerate(bufs):
                    loss, t, r = forward_loss(*state.tensors(j), *b)
                    (loss / dp).backward()
                    rows.append(torch.stack([loss.detach(), t.detach(),
                                             r.detach()]))
                m = torch.stack(rows)
            else:
                stacked = [torch.stack(x) for x in zip(*bufs)]
                loss, t, r = vmap(forward_loss)(state.params, state.buffers,
                                                *stacked)
                (loss.sum() / dp).backward()
                m = torch.stack([loss.detach(), t.detach(), r.detach()], -1)
        _all_reduce_grads(state.params.values(), group, dp)
        _set_lr(opt, lr)
        opt.step()
        m = gather(_mean_over(m, group, dp), mesh, "obj")
        return {"loss": m[:, 0], "trans": m[:, 1], "rot": m[:, 2]}

    return step


# ---------------------------------------------------------------------------
# Tracking.
# ---------------------------------------------------------------------------

def stack_meshes(meshes: list, device="cuda") -> rz.MeshArrays:
    """Stack per-object TriMeshes into one MeshArrays on ``device`` with a
    leading object axis, faces padded to the largest object's count
    (``fmask`` False on the padding). Textured meshes are baked to vertex
    colours first (``render/mesh.bake_texture_to_colors``): per-object
    texture images differ in shape and cannot share one stacked array."""
    max_f = max(m.faces.shape[0] for m in meshes)
    uploaded = []
    for m in meshes:
        if m.texture is not None and m.face_uvs is not None:
            m = mesh_mod.TriMesh(
                verts=m.verts, faces=m.faces,
                colors=mesh_mod.bake_texture_to_colors(
                    m.verts, m.faces[: m.num_faces],
                    m.face_uvs[: m.num_faces], m.texture),
                normals=m.normals, num_faces=m.num_faces)
        pad = max_f - m.faces.shape[0]
        if pad:
            m = mesh_mod.TriMesh(
                verts=m.verts,
                faces=np.concatenate([m.faces, np.zeros((pad, 3), np.int32)]),
                colors=m.colors, normals=m.normals, num_faces=m.num_faces)
        uploaded.append(rz.upload(m, device))
    return rz.MeshArrays(*(torch.stack(f) for f in zip(
        *(u[:4] for u in uploaded))))


def ensemble_forward(state: EnsembleState):
    """``(A, B) -> (trans, rot)`` of the O networks in eval mode, view o
    through network o: one ``vmap`` of ``functional_call`` (batch 1 each)."""
    base = state.model

    def one(params, buffers, A, B):
        out = functional_call(base, (params, buffers), (A[None], B[None]))
        return out["trans"][0], out["rot"][0]

    batched = vmap(one)

    def forward(A, B):
        base.eval()
        return batched(state.params, state.buffers, A, B)

    return forward


@torch.no_grad()
def track_views(cnn, cfg: trk.TrackerConfig, meshes: rz.MeshArrays, K, mean,
                std, init_poses, frames_rgb, frames_depth_mm,
                widths=None) -> torch.Tensor:
    """Track V videos ((V, T, H, W, 3), (V, T, H, W)) from V poses (V, 4, 4)
    with one step per frame over the V views: the V crops (each from its
    video's frame) in one gather, the V views in one K1 and one
    ``pass2_shade`` launch, ``cnn(A, B) -> (trans, rot)`` at batch V and
    the decode over V. ``meshes`` is one mesh or a stack of V;
    ``mean``/``std`` (8,) or (V, 8); ``widths`` None (``cfg``'s) or (V,).
    Returns (V, T, 4, 4)."""
    V, T = frames_rgb.shape[:2]
    per_view = mean.dim() == 2
    mean_v = mean[:, None, None] if per_view else mean
    std_v = std[:, None, None] if per_view else std
    poses = torch.empty((V, T, 4, 4), dtype=torch.float32,
                        device=init_poses.device)
    pose = init_poses
    for i in range(T):
        rgbA, depthA, rgbB, depthB = trk.roi_views(
            cfg, meshes, K, pose, frames_rgb[:, i], frames_depth_mm[:, i],
            widths)
        bufA, bufB = tracknet.normalize_pair(rgbA, depthA, rgbB, depthB,
                                             pose[:, None, None], mean_v,
                                             std_v)
        trans, rot = cnn(bufA, bufB)
        pose = se3.decode_delta(pose, trans, rot, cfg.trans_normalizer,
                                cfg.rot_normalizer)
        poses[:, i] = pose
    return poses


def batched_track_videos(model: tracknet.Se3TrackNet, cfg: trk.TrackerConfig,
                         mesh: Mesh):
    """Track V videos of one object, one step per frame over all V views
    (:func:`track_views`): the multi-video throughput mode. The recurrence
    over frames stays sequential; the parallelism is across videos.

    Returns ``run(mesh_arrays, K, mean, std, init_poses, frames_rgb,
    frames_depth) -> (V, T, 4, 4)``. Across ranks every rank tracks its
    share of the videos (split over ("obj", "dp")) and the poses are
    gathered at the end."""

    def cnn(A, B):
        model.eval()
        out = model(A, B)
        return out["trans"], out["rot"]

    def run(mesh_arrays, K, mean, std, init_poses, frames_rgb, frames_depth):
        init, rgb, dep = shard_pytree((init_poses, frames_rgb, frames_depth),
                                      mesh, AXES)
        poses = track_views(cnn, cfg, mesh_arrays, K, mean, std, init, rgb,
                            dep)
        return gather(poses, mesh, AXES)

    return run


def multi_object_track_videos(model: tracknet.Se3TrackNet,
                              cfg: trk.TrackerConfig, mesh: Mesh,
                              per_object_stats: bool = False,
                              serial: bool | None = None):
    """Track O objects, each with its own network, mesh, ROI width and video.
    ``model`` is the :class:`EnsembleState`'s architecture.

    Returns ``run(ens, ens_meshes, K, mean, std, init_poses, frames_rgb,
    frames_depth, widths) -> (O, T, 4, 4)``: ``ens`` the stacked networks,
    ``ens_meshes`` from :func:`stack_meshes`, ``mean``/``std`` (8,) shared
    or (O, 8) with ``per_object_stats``, ``widths`` (O,) mm.

    ``serial`` (default: one rank): a loop of ``tracker.track_video``, one
    per object, on object o's own network and its slice of the stacked
    meshes. ``serial=False``: one step per frame over the O views
    (:func:`track_views`): the O views in one K1 and one ``pass2_shade``
    launch, per-view widths and statistics, the CNN through
    :func:`ensemble_forward`. Across ranks the objects split over "obj"
    and the poses are gathered at the end."""
    if serial is None:
        serial = mesh.size == 1
    stats_axis = "obj" if per_object_stats else None
    del model  # the architecture travels with ``ens``

    def run(ens, ens_meshes, K, mean, std, init_poses, frames_rgb,
            frames_depth, widths):
        widths = torch.as_tensor(widths, dtype=torch.float32)
        ens, meshes, init, rgb, dep, widths = shard_pytree(
            (ens, ens_meshes, init_poses, frames_rgb, frames_depth, widths),
            mesh, "obj")
        mean, std = shard_pytree((mean, std), mesh, stats_axis)
        if serial:
            out = []
            for o, w in enumerate(widths.tolist()):
                net = ens.module(o).eval()
                mn, sd = (mean[o], std[o]) if per_object_stats else (mean, std)
                out.append(trk.track_video(
                    net, cfg, rz.mesh_of(meshes, o), K, mn, sd, init[o],
                    rgb[o], dep[o], w))
            poses = torch.stack(out)
        else:
            poses = track_views(ensemble_forward(ens), cfg, meshes, K, mean,
                                std, init, rgb, dep,
                                widths.to(init.device))
        return gather(poses, mesh, "obj")

    return run

