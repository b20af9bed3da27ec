"""The system under test, ``iros20_6d_pose_tracking_tpu_torch``, assembled
from the benchmark's inputs through its public entry points: the network
(``models.tracknet.Se3TrackNet``) with the benchmark's weights, the
tracker (``tracking.tracker.Tracker.from_parts``) and the training
pieces (``data.dataset.SyntheticPairs``, ``train.trainer``)."""
from __future__ import annotations


import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def network(params, buffers, cfg, device):
    """The port's Se3TrackNet in the configuration's activation type,
    holding the benchmark's weights (made without an initialisation of
    its own)."""
    from iros20_6d_pose_tracking_tpu_torch.models import tracknet

    with torch.device("meta"):
        net = tracknet.Se3TrackNet(image_size=cfg["resolution"],
                                   dtype=DTYPES[cfg["dtype"]])
    net = net.to_empty(device=device)
    state = {**params, **buffers}
    for name, t in net.state_dict().items():
        if name.endswith("num_batches_tracked"):
            state[name] = torch.zeros_like(t)
    net.load_state_dict(state, strict=True)
    return net.eval()


def mesh_arrays(mesh, device):
    """The port's render mesh from the benchmark's vertex arrays."""
    from iros20_6d_pose_tracking_tpu_torch.render import mesh as M
    from iros20_6d_pose_tracking_tpu_torch.render import rasterizer as rz

    tm = M.build_trimesh(mesh["verts"], mesh["faces"].astype(np.int32),
                         mesh["colors"], mesh["normals"])
    return rz.upload(tm, device)


def tracker(net, mesh, cfg, device):
    """``Tracker.from_parts`` in the production configuration: the ROI
    width of the object's diameter plus the bounding-box pad, back faces
    culled, the configuration's normalisation statistics."""
    from iros20_6d_pose_tracking_tpu_torch.tracking import tracker as trk

    tcfg = trk.TrackerConfig(
        resolution=cfg["resolution"],
        trans_normalizer=cfg["trans_normalizer"],
        rot_normalizer=cfg["rot_normalizer"],
        object_width_mm=cfg["object_width_mm"],
        cull_backfaces=cfg["mesh"]["cull"], dtype=DTYPES[cfg["dtype"]])
    return trk.Tracker.from_parts(net, tcfg, mesh_arrays(mesh, device),
                                  np.asarray(cfg["K"], np.float32),
                                  np.asarray(cfg["mean"], np.float32),
                                  np.asarray(cfg["std"], np.float32))


def trainer(net, mesh, cfg, device):
    """(sampler, TrainConfig, optimizer, lr_at) of the configuration."""
    from iros20_6d_pose_tracking_tpu_torch.data import dataset as DS
    from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

    t = cfg["train"]
    synth = DS.SyntheticPairs(
        mesh_arrays(mesh, device), np.asarray(cfg["K"], np.float32),
        resolution=cfg["resolution"], object_width_mm=cfg["object_width_mm"],
        max_trans=cfg["max_translation_m"],
        max_rot_deg=cfg["max_rotation_deg"],
        xyz_range=t["xyz_range_m"], dr=DS.DRComposite(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg["dr"].items()}))
    tcfg = tr.TrainConfig(
        learning_rate=t["learning_rate"], weight_decay=t["weight_decay"],
        betas=tuple(t["betas"]), batch_size=t["batch_size"],
        trans_normalizer=cfg["train_trans_norm"],
        rot_normalizer=cfg["train_rot_norm"], resolution=cfg["resolution"])
    opt, lr_at = tr.make_optimizer(net, tcfg, steps_per_epoch=1 << 40)
    return synth, tcfg, opt, lr_at


def sample(synth, draws):
    """The sampler's pair batch from the benchmark's draws, given in the
    layout of the port's own ``draw_synth``: the port works out the poses
    (``sample_poses``), renders both branches in A's ROI (one K1 and one
    pass2_shade launch for the 2N views) and composites B."""
    from iros20_6d_pose_tracking_tpu_torch.data import dataset as DS

    return DS._synth_batch(synth.mesh, synth.K, None, draws["t_B"].shape[0],
                           synth.resolution, synth.object_width_mm,
                           synth.max_trans, synth.max_rot_deg,
                           synth.xyz_range, synth.dr, draws)


def train_step(net, opt, lr, tcfg, raw, draws, mean, std):
    from iros20_6d_pose_tracking_tpu_torch.train import trainer as tr

    return tr.train_step(net, opt, lr, tcfg, None, raw, mean, std,
                         aug_draws=draws["aug"])


def free():
    """Drop the module's compiled tracking programs and the cached blocks."""
    from iros20_6d_pose_tracking_tpu_torch.tracking import compiled

    compiled.programs.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


