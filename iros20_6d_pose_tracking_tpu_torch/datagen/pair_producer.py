"""Synthetic training-pair production (file-based, reference protocol), in
PyTorch.

Counterpart of ``iros20_6d_pose_tracking_tpu/datagen/pair_producer.py``,
which re-implements the reference's offline pair factory (reference
produce_train_pair_data.py:58-231): given source images of the object with a
known pose B (domain-randomized renders or real frames), perturb B by
``random_gaussian_magnitude(max_translation, max_rotation)`` to make the
prior A (reference :109-110), render A in its ROI, crop B to A's ROI, and
write ``%07d{rgbA,rgbB,depthA,depthB,segB}.png + %07dmeta.npz``, the layout
``data/dataset.PairDataset`` reads (reference datasets.py:70-93).

``render_dr_scene`` is the self-contained DR source: the object at a random
pose over a textured background with randomized photometry and optional
distractor and occluder layers, each layer a full-frame render through K3
(``rasterizer.render(..., worklist=True)``) and one ``pass2_shade``, merged
by nearest depth on the device. ``DRSceneGenerator`` draws layouts,
primitives and procedural textures from a ``np.random.RandomState`` in the
JAX package's order, so they are the same numbers as JAX's. The A render of
a pair is the ROI render of the tracking step (K1 and ``pass2_shade``, not
culled).

Random numbers on the device come from an explicit ``torch.Generator``
(ROADMAP F7): ``draw_dr_photometry`` gives a scene's background noise, gain,
brightness and background depth, ``PairProducer.generate`` takes the B-in-A
perturbations from ``se3.draw_gaussian_magnitude`` or as ``perturb``, so a
test can pass JAX's. Pillow is imported where an image is written or read.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core import se3
from ..ops import roi as roi_ops
from ..render import rasterizer as rz


def _on(x, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=dtype).to(device)


@dataclass
class ProducerConfig:
    resolution: int = 176
    object_width_mm: float = 250.0
    max_translation: float = 0.02   # dataset_info.yml:12
    max_rotation_deg: float = 15.0  # dataset_info.yml:13
    min_visible_px: int = 100       # reference produce_train_pair_data.py:99,128
    width: int = 640
    height: int = 480


class PairProducer:
    """ProducerPurturb equivalent (reference produce_train_pair_data.py:58),
    on the device of ``mesh``."""

    def __init__(self, mesh: rz.MeshArrays, K, cfg: ProducerConfig,
                 check_vis: bool = False):
        self.mesh = mesh
        self.device = mesh.fverts.device
        self.K = _on(K, self.device)
        self._K_host = self.K.cpu().numpy()
        self.cfg = cfg
        self.check_vis = check_vis
        self.count = 0

    def generate(self, out_dir: str, B_in_cam, current_rgb, current_depth_mm,
                 num_sample: int, class_id: int = 0, current_seg=None,
                 generator: torch.Generator | None = None,
                 perturb=None) -> int:
        """Write up to ``num_sample`` (A, B) pairs for one source image
        (arrays or tensors; the image float RGB, depth in mm).

        The reference's flow: draw the B-in-A perturbation, reject priors
        that project off the image, crop B to A's ROI and reject it when
        fewer than ``min_visible_px`` object pixels remain, render A, save.
        B is checked before A renders (JAX renders first; the outputs are
        the same). ``perturb``: (num_sample, 4, 4) B-in-A poses; by default
        drawn from ``generator`` (one on the device seeded with ``count``,
        as JAX keys ``PRNGKey(count)``). Returns the pairs written.
        """
        cfg = self.cfg
        dev = self.device
        os.makedirs(out_dir, exist_ok=True)
        if perturb is None:
            gen = generator or torch.Generator(dev).manual_seed(self.count)
            perturb = se3.apply_gaussian_magnitude(
                se3.draw_gaussian_magnitude(gen, (num_sample,), dev),
                cfg.max_translation, cfg.max_rotation_deg)
        B = _on(B_in_cam, dev)
        rgb = _on(current_rgb, dev)
        depth = _on(current_depth_mm, dev)
        seg = None if current_seg is None else torch.as_tensor(
            current_seg).to(dev)
        A_all = B @ se3.pose_inv(_on(perturb, dev))
        t_all = A_all[:, :3, 3].cpu().numpy()
        res = (cfg.resolution, cfg.resolution)
        K = self._K_host
        written = 0
        for i in range(num_sample):
            # Reject priors projecting outside the image (reference
            # produce_train_pair_data.py:112-116).
            t = t_all[i]
            u = t[0] * float(K[0, 0]) / t[2] + float(K[0, 2])
            v = t[1] * float(K[1, 1]) / t[2] + float(K[1, 2])
            if not (0 <= u < cfg.width and 0 <= v < cfg.height):
                continue
            A = A_all[i]
            bbox = roi_ops.compute_bbox(A, self.K, cfg.object_width_mm,
                                        (1000.0, 1000.0, 1000.0))
            if seg is not None:
                rgbB, depthB, segB = roi_ops.crop_bbox(rgb, depth, bbox, res,
                                                       seg)
                segB = (segB == class_id).to(torch.uint8)
            else:
                rgbB, depthB = roi_ops.crop_bbox(rgb, depth, bbox, res)
                segB = (depthB > 100).to(torch.uint8)
            segB_np = segB.cpu().numpy()
            if segB_np.sum() < cfg.min_visible_px:  # reference :99,128
                continue
            rgbA, depthA = rz.render(self.mesh, A, self.K,
                                     rz.window_from_bbox(bbox), out_hw=res)
            self._save(out_dir, rgbA.cpu().numpy(), depthA.cpu().numpy(),
                       rgbB.cpu().numpy(), depthB.cpu().numpy(), segB_np,
                       A.cpu().numpy(), B.cpu().numpy())
            written += 1
        return written

    def _save(self, out_dir, rgbA, depthA, rgbB, depthB, segB, A, B):
        from PIL import Image

        i = self.count
        Image.fromarray(rgbA.astype(np.uint8)).save(
            os.path.join(out_dir, f"{i:07d}rgbA.png"), optimize=True)
        Image.fromarray(rgbB.astype(np.uint8)).save(
            os.path.join(out_dir, f"{i:07d}rgbB.png"), optimize=True)
        _save_png16(os.path.join(out_dir, f"{i:07d}depthA.png"),
                    depthA.astype(np.uint16))
        _save_png16(os.path.join(out_dir, f"{i:07d}depthB.png"),
                    depthB.astype(np.uint16))
        Image.fromarray(segB).save(os.path.join(out_dir, f"{i:07d}segB.png"))
        np.savez(os.path.join(out_dir, f"{i:07d}meta.npz"),
                 A_in_cam=A, B_in_cam=B)
        self.count += 1


def _save_png16(path: str, img: np.ndarray):
    from PIL import Image

    Image.fromarray(img).save(path)  # uint16 -> I;16 PNG


def _upsample_linear_t(small: torch.Tensor, height: int,
                       width: int) -> torch.Tensor:
    """(h, w, 3) -> (height, width, 3) float32 on ``small``'s device by
    bilinear interpolation with half-pixel centres and clamped edges:
    ``jax.image.resize(..., "linear")`` when it enlarges, as it does here."""
    x = small.to(torch.float32).permute(2, 0, 1)[None]
    up = F.interpolate(x, size=(height, width), mode="bilinear",
                       align_corners=False)
    return up[0].permute(1, 2, 0)


def _upsample_linear(small: np.ndarray, height: int, width: int) -> np.ndarray:
    """:func:`_upsample_linear_t` of a numpy array, on the CPU."""
    return _upsample_linear_t(torch.from_numpy(small.astype(np.float32)),
                              height, width).numpy()


def draw_dr_photometry(generator: torch.Generator, height: int, width: int,
                       device, noise: bool = True) -> dict:
    """Draws of one :func:`render_dr_scene`: the procedural background's
    (height // 8, width // 8, 3) uniforms (``noise=False``: none, the
    caller gives a background), the per-channel gain in [0.75, 1.25), the
    brightness in [0.4, 1.4) and the background depth in [1200, 1999) mm."""
    return {
        "noise": (se3.uniform(generator, (height // 8, width // 8, 3), device)
                  if noise else None),
        "gain": se3.uniform(generator, (3,), device, 0.75, 1.25),
        "bright": se3.uniform(generator, (), device, 0.4, 1.4),
        "bg_depth": se3.uniform(generator, (), device, 1200.0, 1999.0),
    }


@torch.no_grad()
def render_dr_scene(mesh: rz.MeshArrays, K, pose, draws: dict,
                    width: int = 640, height: int = 480, background=None,
                    extra_layers=()):
    """One domain-randomized full-frame scene on the device of ``mesh``: the
    target object (plus optional distractor/occluder layers, depth-merged
    like a shared z-buffer) composited over a textured background with
    randomized photometry, the stand-in for the reference's Blender DR stage
    (reference blender_dataset_generator.py:265-389).

    Each layer is one full-frame render through K3 (``worklist=True``).
    ``extra_layers`` is a sequence of (MeshArrays, pose) rendered into the
    same camera; pixels are resolved by nearest depth (the first layer on
    ties), so layers in front of the target occlude it and the seg mask
    holds only visible target pixels, like the reference's IndexOB output
    (reference blender_dataset_generator.py:201-254). ``draws`` come from
    :func:`draw_dr_photometry`; ``background`` (H, W, 3), else the noise
    draws upsampled.

    Returns (rgb (H, W, 3) float32, depth_mm (H, W) float32, seg (H, W)
    uint8, 1 = visible target).
    """
    dev = mesh.fverts.device
    Kt = _on(K, dev)
    window = rz.full_frame_window(width, height)
    rgbs, depths = [], []
    for m, p in [(mesh, pose)] + list(extra_layers):
        r, d = rz.render(m, _on(p, dev), Kt, window, out_hw=(height, width),
                         worklist=True)
        rgbs.append(r)
        depths.append(d)
    d = torch.stack([torch.where(di > 0, di, torch.inf) for di in depths])
    winner = torch.argmin(d, dim=0)
    zmin = torch.amin(d, dim=0)
    hit = torch.isfinite(zmin)
    rgb = torch.take_along_dim(torch.stack(rgbs), winner[None, ..., None],
                               dim=0)[0]
    if background is None:
        background = _upsample_linear_t(draws["noise"] * 255.0, height, width)
    # Photometric DR: per-channel gain and a global brightness (the stand-in
    # for the reference's randomized lamps, blender_dataset_generator.py:
    # 122-145; the rasterizer's directional term itself is a fixed
    # headlight).
    rgb = torch.clamp(rgb * draws["gain"] * draws["bright"], 0, 255)
    out_rgb = torch.where(hit[..., None], rgb, _on(background, dev))
    out_depth = torch.where(hit, zmin, draws["bg_depth"])
    seg = (hit & (winner == 0)).to(torch.uint8)
    return out_rgb, out_depth, seg


def load_texture_pool(folder: str, hw: tuple[int, int] = (480, 640),
                      max_textures: int = 64) -> np.ndarray | None:
    """Load a pool of background textures from an image folder (the
    reference samples DTD/ETH texture files onto its background planes,
    reference blender_dataset_generator.py:175-192,296-304; dataset_info
    'texture_folders'). Returns (N, H, W, 3) uint8 or None when empty."""
    import glob as _glob

    from PIL import Image

    files = sorted(
        f for f in _glob.glob(os.path.join(folder, "**", "*"), recursive=True)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))
    )[:max_textures]
    if not files:
        return None
    H, W = hw
    out = []
    for f in files:
        try:
            img = Image.open(f).convert("RGB").resize((W, H))
            out.append(np.asarray(img, np.uint8))
        except OSError:  # not a readable image
            continue
    return np.stack(out) if out else None


def _procedural_texture(rng: np.random.RandomState, height: int,
                        width: int) -> np.ndarray:
    """A random texture from one of four families (multi-octave noise,
    checker, stripes, gradient+noise) — richer stand-ins for the
    reference's texture files when no pool is provided. The draws from
    ``rng`` are the JAX function's, in the same order."""
    fam = rng.randint(4)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    c0 = rng.uniform(0, 255, 3).astype(np.float32)
    c1 = rng.uniform(0, 255, 3).astype(np.float32)
    if fam == 0:  # multi-octave noise
        img = np.zeros((height, width, 3), np.float32)
        for scale in (8, 32, 128):
            small = rng.uniform(0, 1, (max(height // scale, 1),
                                       max(width // scale, 1), 3))
            img += _upsample_linear(small, height, width)
        img = img / 3.0 * 255.0
    elif fam == 1:  # checker
        period = rng.randint(16, 96)
        mask = ((yy // period + xx // period) % 2)[..., None]
        img = mask * c0 + (1 - mask) * c1
    elif fam == 2:  # stripes at a random angle
        theta = rng.uniform(0, np.pi)
        period = rng.uniform(12, 80)
        phase = np.sin((xx * np.cos(theta) + yy * np.sin(theta))
                       * (2 * np.pi / period))
        mask = (phase > 0)[..., None]
        img = mask * c0 + (1 - mask) * c1
    else:  # smooth two-color gradient + noise
        t = (xx / width * rng.uniform(-1, 1)
             + yy / height * rng.uniform(-1, 1) + 1) / 2
        img = t[..., None] * c0 + (1 - t[..., None]) * c1
        img += rng.uniform(-20, 20, (height, width, 1))
    return np.clip(img, 0, 255).astype(np.float32)


@dataclass
class DRSceneConfig:
    """Scene-level domain randomization (parity targets in
    reference blender_dataset_generator.py: textures :175-192, distractor
    clutter/gravity drop :306-363, lighting :75-145)."""

    width: int = 640
    height: int = 480
    max_distractors: int = 2
    occluder_prob: float = 0.3
    texture_dir: str | None = None


class DRSceneGenerator:
    """Randomized full-frame scene factory around :func:`render_dr_scene`.

    Host-side randomness (numpy, the JAX package's draws in its order) picks
    layout and textures; the device renders and composites. Distractors are
    random color-jittered primitives (cubes of 12 faces, icospheres of 320)
    at poses near the target's depth; occluders sit on the camera->target
    ray so they clip the object partially (the producer's visibility check
    rejects over-occluded samples, reference
    produce_train_pair_data.py:128). ``layers`` counts the layers rendered
    so far (one K3 launch each).
    """

    def __init__(self, mesh: rz.MeshArrays, K, cfg: DRSceneConfig,
                 seed: int = 0):
        from ..render import mesh as mesh_mod

        self.mesh = mesh
        self.device = mesh.fverts.device
        self.K = np.asarray(K, np.float32)
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        self.layers = 0
        self._pool = None
        if cfg.texture_dir:
            self._pool = load_texture_pool(cfg.texture_dir,
                                           (cfg.height, cfg.width))
        prims = []
        for i in range(6):
            if i % 2 == 0:
                tm = mesh_mod.make_cube(self.rng.uniform(0.03, 0.09))
            else:
                tm = mesh_mod.make_icosphere(
                    subdiv=2, radius=self.rng.uniform(0.02, 0.05))
            colors = np.clip(
                tm.colors * self.rng.uniform(0.3, 1.0, 3), 0, 1
            ).astype(np.float32)
            prims.append(rz.upload(mesh_mod.TriMesh(
                verts=tm.verts, faces=tm.faces, colors=colors,
                normals=tm.normals, num_faces=tm.num_faces), self.device))
        self._prims = prims

    def _random_pose(self, t):
        w = self.rng.randn(3)
        n = np.linalg.norm(w) + 1e-9
        w = w / n * self.rng.uniform(0, np.pi)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = se3.so3_exp(
            torch.as_tensor(w, dtype=torch.float32)).numpy()
        pose[:3, 3] = t
        return pose

    def scene(self, pose: np.ndarray, draws: dict):
        """(rgb, depth_mm, seg) for the target at ``pose`` in a cluttered
        randomized scene; ``draws`` from :func:`draw_dr_photometry` (its
        noise unused: the background is a pool texture or a procedural
        one)."""
        cfg = self.cfg
        rng = self.rng
        t_obj = np.asarray(pose)[:3, 3]
        layers = []
        for _ in range(rng.randint(0, cfg.max_distractors + 1)):
            off = rng.uniform(-0.18, 0.18, 3) * np.array([1, 1, 0.6])
            t = t_obj + off
            if t[2] < 0.25:
                continue
            layers.append((self._prims[rng.randint(len(self._prims))],
                           self._random_pose(t)))
        if rng.rand() < cfg.occluder_prob:
            s = rng.uniform(0.45, 0.75)  # between camera and target
            perp = rng.uniform(-1.0, 1.0, 2)
            perp = perp / (np.linalg.norm(perp) + 1e-9)
            # offset so the occluder clips the object edge, not its center
            r_off = rng.uniform(0.01, 0.04)
            t = t_obj * s + np.array([perp[0] * r_off, perp[1] * r_off, 0.0])
            layers.append((self._prims[rng.randint(len(self._prims))],
                           self._random_pose(t)))
        if self._pool is not None:
            background = torch.from_numpy(
                self._pool[rng.randint(len(self._pool))].astype(np.float32))
        else:
            background = torch.from_numpy(
                _procedural_texture(rng, cfg.height, cfg.width))
        self.layers += 1 + len(layers)
        return render_dr_scene(self.mesh, self.K, np.asarray(pose), draws,
                               cfg.width, cfg.height, background=background,
                               extra_layers=layers)


def produce_dataset(
    mesh: rz.MeshArrays,
    K: np.ndarray,
    out_root: str,
    cfg: ProducerConfig,
    train_samples: int,
    val_samples: int,
    xyz_range=((-0.2, 0.2), (-0.15, 0.15), (0.4, 0.9)),
    seed: int = 0,
    scene_cfg: DRSceneConfig | None = None,
    stats: dict | None = None,
):
    """End-to-end dataset factory on the device of ``mesh``: DR scenes ->
    perturbation pairs -> the reference's train/val folder split (reference
    produce_train_pair_data.py:145-227, one pair per DR image, the last
    ``val_samples`` in validation). ``scene_cfg`` controls scene richness
    (texture pool, distractor clutter, occluders). The device draws (pose
    direction, photometry, perturbation) come from one generator seeded
    ``seed``. ``stats``, where given, receives the counts of the run:
    scenes, layers (K3 launches), pairs (A renders), train and val.
    Returns (train_dir, val_dir)."""
    train_dir = os.path.join(out_root, "train_data_blender_DR")
    val_dir = os.path.join(out_root, "validation_data_blender_DR")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(val_dir, exist_ok=True)

    dev = mesh.fverts.device
    producer = PairProducer(mesh, K, cfg)
    scene_cfg = scene_cfg or DRSceneConfig(width=cfg.width,
                                           height=cfg.height)
    scenes = DRSceneGenerator(mesh, K, scene_cfg, seed=seed)
    gen = torch.Generator(dev).manual_seed(seed)
    total = train_samples + val_samples
    lo = np.array([r[0] for r in xyz_range])
    hi = np.array([r[1] for r in xyz_range])
    rng = np.random.RandomState(seed)

    made = n_scenes = 0
    while made < total:
        w = (se3.apply_direction(se3.draw_direction(gen, (), dev)).cpu()
             .numpy() * rng.uniform(0, np.pi))
        t = rng.uniform(lo, hi)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = se3.so3_exp(
            torch.as_tensor(w, dtype=torch.float32)).numpy()
        pose[:3, 3] = t
        rgb, depth, seg = scenes.scene(pose, draw_dr_photometry(
            gen, scene_cfg.height, scene_cfg.width, dev, noise=False))
        n_scenes += 1
        out_dir = train_dir if made < train_samples else val_dir
        if made == train_samples:
            producer.count = 0  # val files restart at 0000000
        made += producer.generate(out_dir, pose, rgb, depth, 1, class_id=1,
                                  current_seg=seg, generator=gen)
    if stats is not None:
        stats.update(scenes=n_scenes, layers=scenes.layers, pairs=made,
                     train=train_samples, val=made - train_samples)
    return train_dir, val_dir


def complete_blender(
    generated_dir: str,
    out_root: str,
    dataset_info: dict,
    mesh: rz.MeshArrays | None = None,
    class_id: int = 0,
    seed: int = 0,
    device="cuda",
):
    """Convert Blender DR renders into training pairs: protocol parity with
    reference produce_train_pair_data.py:145-227.

    Reads ``<generated_dir>/%07d{rgb,depth,seg}.png + poses_in_world.npz``
    (keys class_ids / poses_in_world / blendercam_in_world, reference
    blender_dataset_generator.py:367-384), converts poses from the Blender
    camera frame to the CV camera frame (cvcam_in_blendercam = diag(1,-1,-1)
    flip, reference :172-200), produces one perturbation pair per image on
    the device of ``mesh`` (else ``device``; the perturbations from a
    generator seeded ``seed``), and moves the last ``val_samples`` pairs
    into the validation split. Blender itself stays an optional external
    stage (``datagen/blender_gen.py``); the port's rasterizer renders the A
    branch.
    """
    import glob as _glob
    import shutil

    from PIL import Image

    from ..core.camera import Camera

    cam = Camera.from_dict(dataset_info["camera"])
    if mesh is None:
        from ..render import mesh as mesh_mod

        mesh = rz.upload(mesh_mod.load_mesh(
            dataset_info["models"][0]["model_path"]), device)
    cfg = ProducerConfig(
        resolution=int(dataset_info["resolution"]),
        object_width_mm=float(dataset_info["object_width"]),
        max_translation=float(dataset_info["max_translation"]),
        max_rotation_deg=float(dataset_info["max_rotation"]),
        width=cam.width,
        height=cam.height,
    )
    train_dir = os.path.join(out_root, "train_data_blender_DR")
    val_dir = os.path.join(out_root, "validation_data_blender_DR")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(val_dir, exist_ok=True)

    # Blender cam -> CV cam: y/z flip (reference :172-175).
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    producer = PairProducer(mesh, cam.K, cfg)
    gen = torch.Generator(mesh.fverts.device).manual_seed(seed)

    rgb_files = sorted(_glob.glob(os.path.join(generated_dir, "*rgb.png")))
    if not rgb_files:
        raise FileNotFoundError(f"no *rgb.png in {generated_dir}")
    for i, rgb_file in enumerate(rgb_files):
        if i % 100 == 0:
            print(f"pair data {i}/{len(rgb_files)}", flush=True)
        meta = np.load(rgb_file.replace("rgb.png", "poses_in_world.npz"))
        pos = np.where(meta["class_ids"] == class_id)[0]
        pose_w = meta["poses_in_world"][pos].reshape(4, 4)
        B_in_cam = flip @ np.linalg.inv(meta["blendercam_in_world"]) @ pose_w

        seg = np.array(Image.open(rgb_file.replace("rgb", "seg")))
        if seg.ndim == 3:
            seg = seg[..., 0]
        if (seg == class_id).sum() < cfg.min_visible_px:
            continue
        rgb = np.array(Image.open(rgb_file))[..., :3]
        depth = np.array(Image.open(rgb_file.replace("rgb", "depth")))
        producer.generate(train_dir, B_in_cam, rgb, depth.astype(np.float32),
                          num_sample=1, class_id=class_id, current_seg=seg,
                          generator=gen)

    # Move the tail into validation (reference :214-226).
    num_val = int(dataset_info.get("val_samples", 0))
    pairs = sorted(_glob.glob(os.path.join(train_dir, "*rgbA.png")))
    pairs.reverse()
    for j in range(min(num_val, len(pairs))):
        src = pairs[j]
        for suffix in ("rgbA", "rgbB", "depthA", "depthB", "segB"):
            shutil.move(src.replace("rgbA", suffix),
                        os.path.join(val_dir, f"{j:07d}{suffix}.png"))
        shutil.move(src.replace("rgbA.png", "meta.npz"),
                    os.path.join(val_dir, f"{j:07d}meta.npz"))
    return train_dir, val_dir
