"""Rank processes of the port's distributed tests
(``tests/test_torch_distributed.py``): gloo on the CPU, one process a rank,
spawned by :func:`run_ranks` with a ``file://`` rendezvous in a temporary
directory (no TCP port, so parallel test workers never collide).

This module imports torch and the port only: the spawned interpreters load
neither jax nor the JAX package. Each job reads its inputs from a
``torch.save`` file and writes its rank's result beside it.
"""
from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist

INIT_TIMEOUT_S = 60


def _rank_main(rank: int, world: int, tmp: str, job: str):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"),
                            weights_only=False)
        out = JOBS[job](inputs)
        torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, job: str, inputs: dict, tmp, timeout_s=120.0):
    """Run ``job`` on ``world`` gloo ranks with ``inputs``; returns each
    rank's output. A rank that fails raises here; ranks that outlive
    ``timeout_s`` are killed and the call fails."""
    import torch.multiprocessing as mp

    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    ctx = mp.start_processes(_rank_main, args=(world, tmp, job),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"{job} on {world} ranks did not end "
                                     f"within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# Jobs.
# ---------------------------------------------------------------------------

def _net(res, state_dict):
    from iros20_6d_pose_tracking_tpu_torch.models import tracknet

    net = tracknet.create_model(res)
    net.load_state_dict(state_dict, strict=True)
    return net


def _grads(params: dict) -> dict:
    return {k: v.grad.detach().clone() for k, v in params.items()}


def dp_train(inp):
    """``dp_train_step`` over every rank: per step the loss; the first
    step's gradients; the state after the steps."""
    from iros20_6d_pose_tracking_tpu_torch.parallel import spmd
    from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

    cfg = tr.TrainConfig(**inp["cfg"])
    net = _net(cfg.resolution, inp["state"])
    opt, _ = tr.make_optimizer(net, cfg, steps_per_epoch=1000)
    step = spmd.dp_train_step(net, opt, cfg, spmd.make_mesh())
    losses, grads = [], None
    for i, draws in enumerate(inp["draws"]):
        m = step(inp["lr"], None, inp["raw"], inp["mean"], inp["std"],
                 aug_draws=draws)
        losses.append(float(m["loss"]))
        if i == 0:
            grads = _grads(dict(net.named_parameters()))
    return {"losses": losses, "grads": grads, "state": net.state_dict()}


def ensemble_train(inp):
    """``ensemble_train_step`` on the ("obj", "dp") layout of
    ``inp["obj"]`` rows, serial and batched: this rank's objects' first-step
    gradients and states after the steps, and every object's losses."""
    from iros20_6d_pose_tracking_tpu_torch.parallel import spmd
    from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

    cfg = tr.TrainConfig(**inp["cfg"])
    mesh = spmd.make_mesh(obj=inp["obj"])
    out = {"objs": list(range(len(inp["states"])))[
        spmd._part(len(inp["states"]), mesh, "obj")]}
    for serial in (True, False):
        pairs = []
        for sd in inp["states"]:
            net = _net(cfg.resolution, sd)
            pairs.append((net, tr.make_optimizer(net, cfg, 1000)[0]))
        ens = spmd.shard_pytree(spmd.stack_states(pairs), mesh, "obj")
        step = spmd.ensemble_train_step(ens.model, ens.opt, cfg, mesh,
                                        serial=serial)
        losses, grads = [], None
        for i, draws in enumerate(inp["draws"]):
            m = step(ens, inp["lr"], None, inp["raw"], inp["mean"],
                     inp["std"], aug_draws=draws)
            losses.append(m["loss"].tolist())
            if i == 0:
                grads = _grads(ens.params)
        out[serial] = {"losses": losses, "grads": grads,
                       "params": {k: v.detach() for k, v in
                                  ens.params.items()},
                       "buffers": ens.buffers}
    return out


def track(inp):
    """``multi_object_track_videos`` (serial and batched) and
    ``batched_track_videos`` over every rank."""
    from iros20_6d_pose_tracking_tpu_torch.parallel import spmd
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    cfg = trk.TrackerConfig(**inp["cfg"])
    mesh = spmd.make_mesh(obj=inp["obj"])
    nets = [_net(cfg.resolution, sd).eval() for sd in inp["states"]]
    ens = spmd.stack_states(nets)
    meshes = spmd.stack_meshes(inp["tms"], "cpu")
    out = {}
    for serial in (True, False):
        run = spmd.multi_object_track_videos(ens.model, cfg, mesh,
                                             serial=serial)
        out[serial] = run(ens, meshes, inp["K"], inp["mean"], inp["std"],
                          inp["init"], inp["rgb"], inp["depth"],
                          inp["widths"])
    run = spmd.batched_track_videos(nets[0], cfg, mesh)
    out["videos"] = run(rz.upload(inp["tms"][0], "cpu"), inp["K"],
                        inp["mean"], inp["std"], inp["v_init"], inp["v_rgb"],
                        inp["v_depth"])
    return out


def sharded(inp):
    """``sharded_render`` and ``sp_track_step`` over every rank."""
    from iros20_6d_pose_tracking_tpu_torch.ops import roi
    from iros20_6d_pose_tracking_tpu_torch.parallel import latency as lat
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    cfg = trk.TrackerConfig(**inp["cfg"])
    spm = lat.sp_mesh()
    shard = lat.shard_mesh_faces(rz.upload(inp["tm"], "cpu"), spm)
    bbox = roi.compute_bbox(inp["pose"], inp["K"], cfg.object_width_mm,
                            (1000.0, 1000.0, 1000.0))
    rgb, depth = lat.sharded_render(cfg, spm)(shard, inp["pose"], inp["K"],
                                              bbox)
    net = _net(cfg.resolution, inp["state"])
    pose = lat.sp_track_step(net, cfg, spm)(
        shard, inp["K"], inp["mean"], inp["std"], inp["pose"],
        inp["frame_rgb"], inp["frame_depth"])
    return {"rgb": rgb, "depth": depth, "pose": pose,
            "faces": shard.fverts.shape[0]}


JOBS = {"dp_train": dp_train, "ensemble_train": ensemble_train,
        "track": track, "sharded": sharded}
