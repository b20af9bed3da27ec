"""Optional Blender-side domain-randomized scene generator (bpy script).

The framework's default DR pipeline is the on-device renderer
(datagen/pair_producer.py render_dr_scene) — no Blender needed. This
script is the optional high-fidelity external stage, playing the role of
the reference's Blender 2.79 generator (reference
blender_dataset_generator.py:57-396) but written for Blender >= 2.80
(Eevee/Cycles, collection-based API). Run it INSIDE Blender:

    blender --background --python blender_gen.py -- \
        --dataset_info dataset_info.yml --out_dir generated_data --count 2000

Outputs the layout `datagen.pair_producer.complete_blender` consumes:
``%07d{rgb,depth,seg}.png + %07dposes_in_world.npz`` with keys
class_ids / poses_in_world / blendercam_in_world.

Behavior mirrors the reference stage: camera from intrinsics, randomized
environment light and 0..N point lamps, random background textures on a
box of planes, objects dropped with random pose + a short rigid-body
settle, compositor outputs for RGB / depth / object-index segmentation.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys


def _require_bpy():
    try:
        import bpy  # noqa: F401
    except ImportError:
        raise SystemExit(
            "blender_gen.py must run inside Blender: "
            "blender --background --python blender_gen.py -- ..."
        )


def setup_camera(scene, cam_cfg):
    """Camera from pinhole intrinsics (sensor fit to focal, principal
    point via shift)."""
    import bpy

    cam_data = bpy.data.cameras.new("dr_cam")
    cam = bpy.data.objects.new("dr_cam", cam_data)
    scene.collection.objects.link(cam)
    scene.camera = cam
    w, h = int(cam_cfg["width"]), int(cam_cfg["height"])
    scene.render.resolution_x = w
    scene.render.resolution_y = h
    sensor_w = 36.0
    cam_data.sensor_width = sensor_w
    cam_data.lens = cam_cfg["focalX"] * sensor_w / w
    cam_data.shift_x = (w / 2.0 - cam_cfg["centerX"]) / w
    cam_data.shift_y = (cam_cfg["centerY"] - h / 2.0) / w
    return cam


def setup_compositor(scene, tmp_dir):
    """RGB png + depth exr + IndexOB exr outputs."""
    import bpy

    scene.use_nodes = True
    scene.view_layers[0].use_pass_z = True
    scene.view_layers[0].use_pass_object_index = True
    tree = scene.node_tree
    tree.nodes.clear()
    rl = tree.nodes.new("CompositorNodeRLayers")
    out_depth = tree.nodes.new("CompositorNodeOutputFile")
    out_depth.base_path = tmp_dir
    out_depth.format.file_format = "OPEN_EXR"
    out_depth.file_slots[0].path = "depth_"
    out_seg = tree.nodes.new("CompositorNodeOutputFile")
    out_seg.base_path = tmp_dir
    out_seg.format.file_format = "OPEN_EXR"
    out_seg.file_slots[0].path = "seg_"
    tree.links.new(rl.outputs["Depth"], out_depth.inputs[0])
    tree.links.new(rl.outputs["IndexOB"], out_seg.inputs[0])


def randomize_lights(scene, cfg, rng):
    import bpy

    # Clear previous lamps.
    for ob in [o for o in scene.collection.objects if o.type == "LIGHT"]:
        bpy.data.objects.remove(ob, do_unlink=True)
    world = scene.world or bpy.data.worlds.new("dr_world")
    scene.world = world
    world.use_nodes = True
    bg = world.node_tree.nodes.get("Background")
    lo, hi = cfg.get("env_light_range", (0.3, 5.0))
    bg.inputs[1].default_value = rng.uniform(lo, hi)
    n = rng.randint(0, cfg.get("max_lamp_num", 3))
    pos_range = cfg.get("lamp_pos_range", [[-3, 3], [-3, 3], [-2, 0]])
    for i in range(n):
        light = bpy.data.lights.new(f"lamp{i}", type="POINT")
        b0, b1 = cfg.get("lamp_brightness", (0.1, 1.0))
        light.energy = rng.uniform(b0, b1) * 1000.0
        ob = bpy.data.objects.new(f"lamp{i}", light)
        ob.location = [rng.uniform(*pos_range[k]) for k in range(3)]
        scene.collection.objects.link(ob)


def build_background_box(scene, room: float = 1.2, center_z: float = -0.65):
    """Box of 6 planes enclosing the scene volume, each with an
    image-texture material slot (reference
    blender_dataset_generator.py:175-192 builds the same textured room).
    Returns the plane objects; ``assign_random_textures`` re-textures them
    per frame."""
    import bpy
    import mathutils

    planes = []
    specs = [  # (location, rotation_euler)
        ((0, 0, center_z - room / 2), (0, 0, 0)),            # floor
        ((0, 0, center_z + room / 2), (3.1416, 0, 0)),       # ceiling
        ((-room / 2, 0, center_z), (0, 1.5708, 0)),          # walls
        ((room / 2, 0, center_z), (0, -1.5708, 0)),
        ((0, -room / 2, center_z), (-1.5708, 0, 0)),
        ((0, room / 2, center_z), (1.5708, 0, 0)),
    ]
    for i, (loc, rot) in enumerate(specs):
        mesh = bpy.data.meshes.new(f"bgplane{i}")
        mesh.from_pydata(
            [(-room, -room, 0), (room, -room, 0), (room, room, 0),
             (-room, room, 0)], [], [(0, 1, 2, 3)])
        mesh.uv_layers.new()
        ob = bpy.data.objects.new(f"bgplane{i}", mesh)
        ob.location = mathutils.Vector(loc)
        ob.rotation_euler = mathutils.Euler(rot)
        mat = bpy.data.materials.new(f"bgmat{i}")
        mat.use_nodes = True
        bsdf = mat.node_tree.nodes.get("Principled BSDF")
        tex = mat.node_tree.nodes.new("ShaderNodeTexImage")
        mat.node_tree.links.new(tex.outputs["Color"],
                                bsdf.inputs["Base Color"])
        ob.data.materials.append(mat)
        scene.collection.objects.link(ob)
        planes.append(ob)
    return planes


def load_texture_files(cfg):
    """Texture image paths from the dataset_info blender config
    (reference dataset_info.yml:34-38 texture folder keys)."""
    files = []
    for key in ("texture_folder", "texture_folders", "texture_paths"):
        val = cfg.get(key)
        if not val:
            continue
        folders = val if isinstance(val, (list, tuple)) else [val]
        for folder in folders:
            files += [
                f for f in glob.glob(os.path.join(folder, "**", "*"),
                                     recursive=True)
                if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))
            ]
    return sorted(files)


def assign_random_textures(planes, texture_files, rng):
    """Random texture per plane per frame (reference
    blender_dataset_generator.py:296-304 re-textures every image)."""
    import bpy

    if not texture_files:
        return
    for ob in planes:
        path = texture_files[rng.randint(len(texture_files))]
        img = bpy.data.images.get(os.path.basename(path))
        if img is None:
            try:
                img = bpy.data.images.load(path)
            except Exception:
                continue
        tex = ob.data.materials[0].node_tree.nodes.get("Image Texture")
        if tex is not None:
            tex.image = img


def setup_rigid_body(scene, objects, planes, rng):
    """Rigid-body world: objects active, the room passive, so the random
    drop + 3-frame settle actually simulates (the reference configures the
    same gravity sim, blender_dataset_generator.py:306-363). Returns True
    when the world is live."""
    import bpy

    try:
        if scene.rigidbody_world is None:
            bpy.ops.rigidbody.world_add()
        for _, ob in objects:
            bpy.context.view_layer.objects.active = ob
            if ob.rigid_body is None:
                bpy.ops.rigidbody.object_add()
            ob.rigid_body.type = "ACTIVE"
            ob.rigid_body.collision_shape = "CONVEX_HULL"
        for ob in planes:
            bpy.context.view_layer.objects.active = ob
            if ob.rigid_body is None:
                bpy.ops.rigidbody.object_add()
            ob.rigid_body.type = "PASSIVE"
        return True
    except Exception as e:  # headless builds without the rigidbody op
        print(f"rigid-body setup unavailable ({e}); using kinematic poses")
        return False


def settle_physics(scene, rng, frames: int = 3):
    """Random gravity direction + short settle (reference
    blender_dataset_generator.py:349-363: random gravity, 3 frames)."""
    g = rng.randn(3)
    g = g / (max(float((g ** 2).sum()) ** 0.5, 1e-9)) * 9.81
    scene.gravity = tuple(g)
    if scene.rigidbody_world is not None:
        scene.rigidbody_world.point_cache.frame_start = scene.frame_current
    for _ in range(frames):
        scene.frame_set(scene.frame_current + 1)


def random_pose(rng, ranges):
    import mathutils

    loc = mathutils.Vector([
        rng.uniform(*ranges.get("range_x", (-0.3, 0.3))),
        rng.uniform(*ranges.get("range_y", (-0.3, 0.3))),
        -rng.uniform(*ranges.get("range_z", (0.4, 0.9))),
    ])
    rot = mathutils.Euler([rng.uniform(0, 6.2832) for _ in range(3)])
    return loc, rot


def main():
    _require_bpy()
    import bpy
    import numpy as np

    argv = sys.argv[sys.argv.index("--") + 1:] if "--" in sys.argv else []
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_info", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--count", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import yaml

    with open(args.dataset_info) as f:
        info = yaml.safe_load(f)
    np_rng = np.random.RandomState(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    tmp_dir = os.path.join(args.out_dir, "_tmp")
    os.makedirs(tmp_dir, exist_ok=True)

    scene = bpy.context.scene
    scene.render.engine = "BLENDER_EEVEE_NEXT" if hasattr(
        bpy.types, "SceneEEVEE") else "BLENDER_EEVEE"
    cam = setup_camera(scene, info["camera"])
    setup_compositor(scene, tmp_dir)

    # Import the object(s).
    objects = []
    for class_id, entry in sorted(info["models"].items()):
        path = entry["model_path"]
        if path.endswith(".ply"):
            bpy.ops.import_mesh.ply(filepath=path)
        else:
            bpy.ops.wm.obj_import(filepath=path)
        ob = bpy.context.selected_objects[0]
        ob.pass_index = int(class_id) + 1
        objects.append((int(class_id), ob))

    blender_cfg = info.get("blender", {})
    count = args.count or int(
        (info["train_samples"] + info["val_samples"]) / 0.7
    )  # reference blender_dataset_generator.py:271 oversampling factor

    # Textured room + rigid-body world (reference :175-192, :306-363).
    planes = build_background_box(scene)
    texture_files = load_texture_files(blender_cfg)
    if not texture_files:
        print("no texture folders configured; background planes stay untextured")
    physics = setup_rigid_body(scene, objects, planes, np_rng)

    for i in range(count):
        randomize_lights(scene, blender_cfg, np_rng)
        assign_random_textures(planes, texture_files, np_rng)
        for _, ob in objects:
            loc, rot = random_pose(np_rng, blender_cfg)
            ob.location = loc
            ob.rotation_euler = rot
        if physics:
            settle_physics(scene, np_rng, frames=3)

        scene.render.filepath = os.path.join(args.out_dir, f"{i:07d}rgb.png")
        bpy.ops.render.render(write_still=True)

        # Convert compositor exr outputs to the protocol files.
        _convert_outputs(tmp_dir, args.out_dir, i)

        class_ids = np.array([cid for cid, _ in objects])
        poses = np.stack([
            np.array(ob.matrix_world) for _, ob in objects
        ])
        np.savez(
            os.path.join(args.out_dir, f"{i:07d}poses_in_world.npz"),
            class_ids=class_ids,
            poses_in_world=poses,
            blendercam_in_world=np.array(cam.matrix_world),
        )
        if i % 50 == 0:
            print(f"generated {i}/{count}", flush=True)


def _convert_outputs(tmp_dir, out_dir, index):
    """exr depth/seg -> 16-bit mm png / 8-bit index png."""
    import numpy as np

    import bpy

    for slot, suffix in (("depth_", "depth"), ("seg_", "seg")):
        matches = sorted(glob.glob(os.path.join(tmp_dir, slot + "*.exr")))
        if not matches:
            continue
        img = bpy.data.images.load(matches[-1])
        w, h = img.size
        arr = np.array(img.pixels[:]).reshape(h, w, -1)[::-1, :, 0]
        bpy.data.images.remove(img)
        if suffix == "depth":
            out = np.clip(arr * 1000.0, 0, 65535).astype("uint16")
        else:
            # IndexOB carries pass_index = class_id + 1 (the +1 keeps
            # class 0 distinct from the 0-valued background). Decode back
            # to class ids here so seg pixels match the npz class_ids and
            # complete_blender's `seg == class_id` test (reference
            # produce_train_pair_data.py:207 uses raw pass_index, which
            # breaks for class 0); background becomes 255.
            idx = np.rint(arr).astype(np.int32)
            out = np.where(idx > 0, idx - 1, 255).astype("uint8")
        # write via Blender-bundled PIL-free path: reuse bpy image save
        _save_png(os.path.join(out_dir, f"{index:07d}{suffix}.png"), out)
        for m in matches:
            os.remove(m)


def _save_png(path, arr):
    try:
        from PIL import Image

        Image.fromarray(arr).save(path)
    except ImportError:  # Blender python without PIL: fall back to numpy
        import numpy as np

        np.save(path + ".npy", arr)


if __name__ == "__main__":
    main()
