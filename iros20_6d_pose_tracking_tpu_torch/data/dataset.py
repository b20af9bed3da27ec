"""Training-pair data sources, in PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/data/dataset.py``. Two sources
feed the trainer:

  1. :class:`PairDataset` reads the reference's on-disk pair layout
     ``%07d{rgbA,rgbB,depthA,depthB,segB}.png + %07dmeta.npz`` (keys
     ``A_in_cam``/``B_in_cam``; reference datasets.py:70-93) on the host,
     decoding with the native libpng loader (``native/dataload.py``, a
     whole batch's PNGs of each kind in one call on its thread pool) where
     it builds, else with Pillow (imported when a file is read).

  2. :class:`SyntheticPairs` samples poses and renders both branches on the
     device of its mesh: B uniform in the configured view ranges, the prior
     A = B . inv(perturbation), both rendered in A's ROI window. The 2N
     views of a batch go through one batched
     :func:`~..render.rasterizer.render`: one K1 and one fused pass-2
     launch per batch. ``DRComposite`` adds the
     randomized scene (valid-depth background, occluder blob) to B.

Randomness is split from the computation (ROADMAP F7): :func:`draw_synth`
makes every draw of a batch on a ``torch.Generator``, :func:`sample_poses`
and :func:`render_pairs` apply them. A test feeds the JAX sampler's own
poses (they are in the batch dict) and DR draws to the port.
"""
from __future__ import annotations

import glob
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
from torch.nn import functional as F

from ..core import se3
from ..ops import roi as roi_ops
from ..render import rasterizer as rz


@dataclass
class PairRecord:
    rgbA: np.ndarray
    depthA: np.ndarray
    rgbB: np.ndarray
    depthB: np.ndarray
    maskB: np.ndarray
    A_in_cam: np.ndarray
    B_in_cam: np.ndarray


def _imread(path: str, gray: bool = False, native=None) -> np.ndarray:
    """Decode a PNG with ``native`` (a ``NativeLoader``) where given and it
    succeeds, else with Pillow; ``gray`` keeps the first channel."""
    img = native.read_png(path) if native is not None else None
    if img is None:
        from PIL import Image

        with Image.open(path) as im:
            img = np.array(im)
    if gray and img.ndim == 3:
        img = img[..., 0]
    return img


def _native_loader():
    """The native PNG loader, or None where it does not build (no g++ or
    no libpng)."""
    from ..native.dataload import NativeLoader

    try:
        return NativeLoader()
    except (OSError, RuntimeError):
        return None


class PairDataset:
    """File-backed (A, B) pair reader, reference layout.

    Pairs are found by globbing ``*rgbA.png`` and substituting suffixes
    (reference datasets.py:70,86-93). Images are resized to ``resolution``
    with the cv2 INTER_NEAREST index rule when needed (reference
    datasets.py:95-101)."""

    def __init__(self, root: str, resolution: int = 176):
        self.root = root
        self.resolution = resolution
        self.rgbA_files = sorted(glob.glob(os.path.join(root, "*rgbA.png")))
        self._native = _native_loader()

    def __len__(self):
        return len(self.rgbA_files)

    def _resize(self, img):
        r = self.resolution
        h, w = img.shape[:2]
        if h == r and w == r:
            return img
        rr = (np.arange(r) * h) // r
        cc = (np.arange(r) * w) // r
        return img[rr[:, None], cc[None, :]]

    def __getitem__(self, i: int) -> PairRecord:
        fA = self.rgbA_files[i]
        nl = self._native
        rgbA = _imread(fA, native=nl)[..., :3]
        rgbB = _imread(fA.replace("rgbA", "rgbB"), native=nl)[..., :3]
        depthA = _imread(fA.replace("rgbA", "depthA"), gray=True, native=nl)
        depthB = _imread(fA.replace("rgbA", "depthB"), gray=True, native=nl)
        seg_path = fA.replace("rgbA", "segB")
        if os.path.exists(seg_path):
            maskB = _imread(seg_path, gray=True, native=nl)
        else:
            maskB = (depthB > 100).astype(np.uint8)  # reference datasets.py:104
        meta = np.load(fA.replace("rgbA.png", "meta.npz"))
        rec = PairRecord(
            rgbA=self._resize(rgbA).astype(np.float32),
            depthA=self._resize(depthA).astype(np.float32),
            rgbB=self._resize(rgbB).astype(np.float32),
            depthB=self._resize(depthB).astype(np.float32),
            maskB=self._resize(maskB).astype(np.uint8),
            A_in_cam=meta["A_in_cam"].astype(np.float32),
            B_in_cam=meta["B_in_cam"].astype(np.float32),
        )
        if rec.maskB.sum() == 0:
            raise ValueError(f"{fA}: empty segmentation mask")
        return rec

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True, pad_to_batch: bool = False):
        """Yield stacked numpy batch dicts (N, ...), in the order of
        ``np.random.RandomState(seed)`` when ``shuffle``.

        ``pad_to_batch`` (validation): pad a final partial batch up to
        ``batch_size`` by wrapping around, and add its ``n_valid`` count
        (``train.trainer.eval_step`` masks the padding)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        end = len(self) - (len(self) % batch_size if drop_last else 0)
        for s in range(0, end, batch_size):
            idx = order[s:s + batch_size]
            if len(idx) == 0:
                continue
            n_valid = len(idx)
            if pad_to_batch and n_valid < batch_size:
                extra = order[np.arange(batch_size - n_valid) % len(order)]
                idx = np.concatenate([idx, extra])
            batch = self._native_batch(idx)
            if batch is None:
                recs = [self[int(i)] for i in idx]
                batch = {k: np.stack([getattr(r, k) for r in recs])
                         for k in ("rgbA", "depthA", "rgbB", "depthB",
                                   "maskB", "A_in_cam", "B_in_cam")}
            if pad_to_batch:
                batch["n_valid"] = n_valid
            yield batch


    def _native_batch(self, idx):
        """The batch decoded by the native loader, each kind's PNGs in one
        call on its thread pool: the arrays of the record path. None where
        the loader is missing, the files need a resize, or a file fails
        (the record path then decodes, with Pillow where it must)."""
        if self._native is None:
            return None
        nl = self._native
        fAs = [self.rgbA_files[int(i)] for i in idx]

        def files(kind):
            return [f.replace("rgbA", kind) for f in fAs]

        try:
            meta = nl.info(fAs[0])
            if meta is None or meta[:2] != (self.resolution,
                                            self.resolution):
                return None
            rgbA = nl.read_png_batch(fAs, np.uint8)
            rgbB = nl.read_png_batch(files("rgbB"), np.uint8)
            depthA = nl.read_png_batch(files("depthA"), np.uint16)
            depthB = nl.read_png_batch(files("depthB"), np.uint16)
            if all(os.path.exists(f) for f in files("segB")):
                maskB = nl.read_png_batch(files("segB"), np.uint8)
                if maskB.ndim == 4:
                    maskB = maskB[..., 0]
            else:
                maskB = (depthB > 100).astype(np.uint8)
        except (OSError, ValueError):
            return None
        if (maskB.reshape(len(idx), -1).sum(1) == 0).any():
            return None  # the record path names the empty mask
        metas = [np.load(f.replace("rgbA.png", "meta.npz")) for f in fAs]
        return {
            "rgbA": rgbA[..., :3].astype(np.float32),
            "depthA": depthA.astype(np.float32),
            "rgbB": rgbB[..., :3].astype(np.float32),
            "depthB": depthB.astype(np.float32),
            "maskB": maskB.astype(np.uint8),
            "A_in_cam": np.stack([m["A_in_cam"] for m in metas]).astype(
                np.float32),
            "B_in_cam": np.stack([m["B_in_cam"] for m in metas]).astype(
                np.float32),
        }


@dataclass(frozen=True)
class DRComposite:
    """Domain randomization composited into the observed (B) branch: a
    textured background at valid sensor depth, and an occluder blob in front
    of the object (the on-device stand-in for the reference's Blender DR
    scenes, blender_dataset_generator.py:175-192,
    produce_train_pair_data.py:118-128)."""

    bg_prob: float = 0.9
    bg_depth_range: tuple = (850.0, 1900.0)
    occluder_prob: float = 0.5
    # an occluder that would hide more than this fraction of the object's
    # pixels is dropped (the reference producer rejects over-occluded
    # samples, produce_train_pair_data.py:128)
    max_occluded_frac: float = 0.5


def draw_smooth_noise(gen, n, channels, device, coarse=6, fine=24) -> dict:
    """Draws of :func:`apply_smooth_noise`: a coarse and a fine uniform
    grid per sample."""
    return {"lo": se3.uniform(gen, (n, coarse, coarse, channels), device),
            "hi": se3.uniform(gen, (n, fine, fine, channels), device)}


def _upsample(img, res):
    """(N, h, w, C) -> (N, res, res, C), bilinear with half-pixel centres
    (``jax.image.resize(..., "bilinear")`` when upsampling)."""
    out = F.interpolate(img.permute(0, 3, 1, 2), size=(res, res),
                        mode="bilinear", align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1)


def apply_smooth_noise(d: dict, res: int) -> torch.Tensor:
    """Two-octave smooth noise in [0, 1), (N, res, res, C): the coarse grid
    upsampled x 0.75 plus the fine grid upsampled x 0.25."""
    return _upsample(d["lo"], res) * 0.75 + _upsample(d["hi"], res) * 0.25


def draw_dr(gen, n: int, res: int, dr: DRComposite, device) -> dict:
    """Every draw of :func:`apply_dr` for ``n`` samples at ``res``."""
    return {
        "bg_noise": draw_smooth_noise(gen, n, 3, device),
        "u_base": se3.uniform(gen, (n,), device),
        "grad": se3.uniform(gen, (n, 2), device, -1.5, 1.5),
        "depth_noise": draw_smooth_noise(gen, n, 1, device),
        "use_bg": se3.uniform(gen, (n,), device) < dr.bg_prob,
        "centre": se3.uniform(gen, (n, 2), device, 0.2 * res, 0.8 * res),
        "radii": se3.uniform(gen, (n, 2), device, 0.10 * res, 0.30 * res),
        "occ_scale": se3.uniform(gen, (n,), device, 0.5, 0.85),
        "occ_colour": se3.uniform(gen, (n, 3), device),
        "occ_noise": draw_smooth_noise(gen, n, 3, device),
        "use_occ": se3.uniform(gen, (n,), device) < dr.occluder_prob,
    }


def apply_dr(d: dict, rgbB, depthB, dr: DRComposite):
    """z-composite (background, object, occluder) into a batch of B
    branches (N, H, H, 3), (N, H, H). Object pixels keep their rendered
    values unless the occluder wins the z-test; the returned mask is the
    object's visibility (reference segB semantics)."""
    res = depthB.shape[-1]
    dev = depthB.device
    obj = depthB > 100.0

    def per(x):  # (N,) -> (N, 1, 1)
        return x[:, None, None]

    # Background: texture and a tilted plane of valid depth, its floor set
    # behind the object's mean depth so the background never z-fights it.
    lo, hi = dr.bg_depth_range
    bg_rgb = apply_smooth_noise(d["bg_noise"], res) * 255.0
    n_obj = obj.sum(dim=(1, 2))
    obj_sum = (depthB * obj).sum(dim=(1, 2))
    obj_mean_d = torch.where(n_obj > 0, obj_sum / (n_obj + 1e-9), 600.0)
    lo = torch.clamp(obj_mean_d + 120.0, min=lo)
    hi = torch.maximum(torch.full_like(lo, hi), lo + 100.0)
    base = torch.maximum(lo, d["u_base"] * (hi - lo) + lo)
    yy = torch.arange(res, device=dev)[:, None].expand(res, res)
    xx = torch.arange(res, device=dev)[None, :].expand(res, res)
    gx, gy = d["grad"][:, 0], d["grad"][:, 1]
    bg_depth = per(base) + per(gx) * (xx - res / 2) \
        + per(gy) * (yy - res / 2) \
        + apply_smooth_noise(d["depth_noise"], res)[..., 0] * 40.0
    bg_depth = torch.minimum(torch.maximum(bg_depth, per(lo)),
                             torch.full_like(bg_depth, 2500.0))
    use_bg = per(d["use_bg"]) & ~obj
    out_rgb = torch.where(use_bg[..., None], bg_rgb, rgbB)
    out_depth = torch.where(use_bg, bg_depth, depthB)

    # Occluder: a coloured ellipse in front of the object.
    cx, cy = d["centre"][:, 0], d["centre"][:, 1]
    rx, ry = d["radii"][:, 0], d["radii"][:, 1]
    ell = ((xx - per(cx)) / per(rx)) ** 2 + ((yy - per(cy)) / per(ry)) ** 2 \
        < 1.0
    occ_depth = obj_mean_d * d["occ_scale"]
    occ_rgb = (d["occ_colour"][:, None, None, :] * 235.0 + 10.0
               + (apply_smooth_noise(d["occ_noise"], res) - 0.5) * 40.0)
    hidden = (ell & obj).sum(dim=(1, 2)) / (n_obj + 1e-9)
    use_occ = d["use_occ"] & (hidden <= dr.max_occluded_frac)
    # depth <= 100 means "no reading": infinitely far for the z-test
    far = torch.where(out_depth > 100.0, out_depth, torch.inf)
    occ_wins = ell & (per(occ_depth) < far) & per(use_occ)
    out_rgb = torch.where(occ_wins[..., None], torch.clamp(occ_rgb, 0, 255),
                          out_rgb)
    out_depth = torch.where(occ_wins, per(occ_depth), out_depth)
    return out_rgb, out_depth, obj & ~occ_wins


def draw_synth(gen: torch.Generator, n: int, resolution: int,
               dr: DRComposite | None, device) -> dict:
    """Every draw of one sampler batch, made on ``gen``'s device in a fixed
    order and moved to ``device``: B's rotation (direction, angle in
    [0, pi)) and translation (uniforms in [0, 1), scaled to the view
    ranges by :func:`sample_poses`), the A-from-B perturbation, and the DR
    draws when ``dr`` is set."""
    d = {"dir_B": se3.draw_direction(gen, (n,), device),
         "angle_B": se3.uniform(gen, (n, 1), device, 0.0, math.pi),
         "t_B": se3.uniform(gen, (n, 3), device),
         "pert": se3.draw_gaussian_magnitude(gen, (n,), device)}
    if dr is not None:
        d["dr"] = draw_dr(gen, n, resolution, dr, device)
    return d


def sample_poses(d: dict, xyz_range, max_trans: float, max_rot_deg: float):
    """(A_in_cam, B_in_cam), each (N, 4, 4), from :func:`draw_synth`'s
    draws: B uniform in ``xyz_range`` with a uniform random rotation, A =
    B . inv(random_gaussian_magnitude(max_trans, max_rot_deg))
    (reference produce_train_pair_data.py:109-110)."""
    w = se3.apply_direction(d["dir_B"]) * d["angle_B"]
    # The ranges in float32 arithmetic, as JAX computes (hi - lo) on arrays.
    lo = np.array([r[0] for r in xyz_range], np.float32)
    span = np.array([r[1] for r in xyz_range], np.float32) - lo
    u = d["t_B"]
    t_B = torch.stack([u[:, i] * float(span[i]) + float(lo[i])
                       for i in range(3)], dim=-1)
    B_in_cam = se3.make_pose(se3.so3_exp(w), t_B)
    B_in_A = se3.apply_gaussian_magnitude(d["pert"], max_trans, max_rot_deg)
    return B_in_cam @ se3.pose_inv(B_in_A), B_in_cam


def render_pairs(mesh: rz.MeshArrays, K, A_in_cam, B_in_cam, resolution: int,
                 object_width_mm: float, dr: DRComposite | None = None,
                 dr_draws: dict | None = None) -> dict:
    """Render both branches of N pairs in the ROI window of each A pose:
    the 2N views in one batched :func:`~..render.rasterizer.render` (one
    K1 and one fused pass-2 launch), then the DR composite of the B branches. Returns
    the raw batch dict (rgbA, depthA, rgbB, depthB, maskB, A_in_cam,
    B_in_cam)."""
    n = A_in_cam.shape[0]
    bbox = roi_ops.compute_bbox(A_in_cam, K, object_width_mm,
                                (1000.0, 1000.0, 1000.0))
    window = rz.window_from_bbox(bbox)
    rgb, depth = rz.render(
        mesh, torch.cat([A_in_cam, B_in_cam]), K,
        torch.cat([window, window]), out_hw=(resolution, resolution))
    rgbA, rgbB, depthA, depthB = rgb[:n], rgb[n:], depth[:n], depth[n:]
    if dr is not None:
        rgbB, depthB, maskB = apply_dr(dr_draws, rgbB, depthB, dr)
    else:
        maskB = depthB > 100.0
    return {"rgbA": rgbA, "depthA": depthA, "rgbB": rgbB, "depthB": depthB,
            "maskB": maskB, "A_in_cam": A_in_cam, "B_in_cam": B_in_cam}


def _synth_batch(mesh: rz.MeshArrays, K, gen: torch.Generator,
                 batch_size: int, resolution: int, object_width_mm: float,
                 max_trans: float, max_rot_deg: float, xyz_range,
                 dr: DRComposite | None = None, draws: dict | None = None
                 ) -> dict:
    """One sampler batch on the mesh's device: draw (or ``draws``, as
    :func:`draw_synth` gives them), poses, render."""
    d = draws if draws is not None else draw_synth(
        gen, batch_size, resolution, dr, mesh.fverts.device)
    A_in_cam, B_in_cam = sample_poses(d, xyz_range, max_trans, max_rot_deg)
    return render_pairs(mesh, K, A_in_cam, B_in_cam, resolution,
                        object_width_mm, dr, d.get("dr"))


class SyntheticPairs:
    """On-device (A, B) pair generator: the training input pipeline without
    a disk (the JAX ``SyntheticPairs``). Samples B uniformly in the view
    ranges (reference dataset_info.yml blender ranges), perturbs it by
    ``random_gaussian_magnitude(max_trans, max_rot_deg)`` into the prior A
    (reference produce_train_pair_data.py:109-110), and renders both
    branches in A's ROI window on the mesh's device. ``dr`` composites the
    B branch into a randomized scene (:class:`DRComposite`)."""

    def __init__(
        self,
        mesh: rz.MeshArrays,
        K,
        resolution: int = 176,
        object_width_mm: float = 250.0,
        max_trans: float = 0.02,
        max_rot_deg: float = 15.0,
        xyz_range=((-0.1, 0.1), (-0.1, 0.1), (0.4, 0.9)),
        dr: DRComposite | None = None,
    ):
        self.mesh = mesh
        self.device = mesh.fverts.device
        self.K = torch.as_tensor(np.asarray(K), dtype=torch.float32).to(
            self.device)
        self.resolution = resolution
        self.object_width_mm = object_width_mm
        self.max_trans = max_trans
        self.max_rot_deg = max_rot_deg
        self.xyz_range = tuple(map(tuple, xyz_range))
        self.dr = dr

    def sample_batch(self, gen: torch.Generator, batch_size: int) -> dict:
        """A raw pair batch (tensors on the mesh's device) from the draws
        of ``gen``, which may live on the CPU or on that device."""
        return _synth_batch(self.mesh, self.K, gen, batch_size,
                            self.resolution, self.object_width_mm,
                            self.max_trans, self.max_rot_deg, self.xyz_range,
                            self.dr)


def ensemble_synth_batch(ens_mesh: rz.MeshArrays, K, keys, widths_mm,
                         batch_size: int, resolution: int, max_trans: float,
                         max_rot_deg: float, xyz_range,
                         dr: DRComposite | None = None,
                         draws: list | None = None) -> dict:
    """Per-object synthetic pair batches: the input of the ensemble train
    step (``parallel/spmd.ensemble_train_step``), for the accuracy suite's
    ensemble mode.

    ``ens_mesh``: O meshes stacked by ``parallel/spmd.stack_meshes``;
    ``keys``: O generators, object o's batch drawn on ``keys[o]`` (the
    caller keys them by (step, object)), or ``draws[o]`` given in their
    place; ``widths_mm``: O ROI widths. Each object is one :func:`_synth_batch`
    (one K1 and one ``pass2_shade`` launch over its 2 x ``batch_size``
    views), quantized as the reference's PNG pair files are: RGB rounded to
    uint8, depth rounded to millimetres in the uint16 range, held as int32
    on the device (the integers ``tracking/tracker.upload_depth`` gives).
    Returns the raw batch dict with leading (O, batch) axes."""
    O = ens_mesh.fverts.shape[0]
    out = []
    for o in range(O):
        raw = _synth_batch(
            rz.mesh_of(ens_mesh, o), K, None if keys is None else keys[o],
            batch_size, resolution, float(widths_mm[o]), max_trans,
            max_rot_deg, xyz_range, dr,
            None if draws is None else draws[o])
        for k in ("rgbA", "rgbB"):
            raw[k] = torch.clamp(torch.round(raw[k]), 0, 255).to(torch.uint8)
        for k in ("depthA", "depthB"):
            raw[k] = torch.clamp(torch.round(raw[k]), 0, 65535).to(
                torch.int32)
        out.append(raw)
    return {k: torch.stack([r[k] for r in out]) for k in out[0]}
