"""Mesh IO and preprocessing for the rasterizer.

The port's own copy of ``iros20_6d_pose_tracking_tpu/render/mesh.py``
(numpy only), function for function, so the port imports nothing of the
JAX package; ``tests/test_torch_port_copies.py`` holds the two equal.
:func:`~.rasterizer.upload` copies a :class:`TriMesh` (this one or the JAX
package's: it reads only the fields) to a torch device.

Self-contained PLY/OBJ loaders (the reference leans on plyfile/trimesh,
reference vispy_renderer.py:104-122 / offscreen_renderer.py:58-64; neither
is a dependency here). Loaded meshes are packed into a static
:class:`TriMesh` of padded, Morton-ordered triangles — the layout the
rasterizer's (pixel-tile x face-block) grid relies on for tight per-block
screen bounds.

Also hosts the point-cloud utilities the tracker needs at init:
``voxel_down_sample`` (reference predict.py:131-133) and
``compute_cloud_diameter`` (reference Utils.py:101-105).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

FACE_BLOCK = 256  # faces per rasterizer block; padding granularity


@dataclass
class TriMesh:
    """Triangle soup prepared for rendering.

    verts: (V, 3) float32 object-space positions (meters)
    faces: (F, 3) int32 vertex indices, padded with degenerate (0,0,0) rows
    colors: (V, 3) float32 vertex albedo in [0, 1]
    normals: (V, 3) float32 unit vertex normals
    num_faces: actual face count before padding
    face_uvs: optional (F, 3, 2) float32 PER-CORNER texture coordinates
      (OBJ convention: origin bottom-left, padded rows zero). Per-corner
      — not per-vertex — because OBJ indexes positions and UVs
      independently (``f v/vt/vn``): a seam vertex carries different UVs
      on each side, which a (V, 2) table cannot represent.
    texture: optional (Th, Tw, 3) float32 albedo texture in [0, 1]
      (the ``map_Kd`` image of the mesh's material). When present the
      rasterizer samples it perspective-correctly instead of vertex
      colors — required for real textured CAD models (YCB textured.obj;
      the reference renders these through trimesh/pyrender materials,
      reference offscreen_renderer.py:53-69).
    """

    verts: np.ndarray
    faces: np.ndarray
    colors: np.ndarray
    normals: np.ndarray
    num_faces: int
    face_uvs: np.ndarray | None = None
    texture: np.ndarray | None = None

    @property
    def diameter(self) -> float:
        return compute_cloud_diameter(self.verts)


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path: str):
    """Parse ascii / binary_little_endian PLY.

    Returns dict with 'verts' (V,3) f32 and optional 'normals', 'colors'
    (f32 in [0,1]), 'faces' (F,3) i32 — whichever the file provides.
    """
    with open(path, "rb") as f:
        data = f.read()

    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"not a PLY file: {path}")
    header_end = data.find(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end:]

    fmt = None
    elements = []  # (name, count, [(prop_name, type, is_list, list_count_type)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], parts[3], True, parts[2]))
            else:
                elements[-1][2].append((parts[2], parts[1], False, None))

    out: dict = {}
    if fmt == "ascii":
        tokens = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            if count == 0:
                continue
            if any(p[2] for p in props):  # list property (faces)
                rows = []
                for _ in range(count):
                    n = int(tokens[pos]); pos += 1
                    rows.append([int(t) for t in tokens[pos : pos + n]])
                    pos += n
                out[name + "_lists"] = rows
            else:
                vals = np.array(
                    tokens[pos : pos + count * len(props)], dtype=np.float64
                ).reshape(count, len(props))
                pos += count * len(props)
                out[name] = (vals, [p[0] for p in props])
    elif fmt == "binary_little_endian":
        offset = 0
        for name, count, props in elements:
            if count == 0:
                continue
            if any(p[2] for p in props):
                rows = []
                for _ in range(count):
                    (pname, ptype, _, ctype) = props[0]
                    cfmt, csz = _PLY_TYPES[ctype]
                    (n,) = struct.unpack_from("<" + cfmt, body, offset)
                    offset += csz
                    ifmt, isz = _PLY_TYPES[ptype]
                    rows.append(
                        list(struct.unpack_from("<" + ifmt * n, body, offset))
                    )
                    offset += isz * n
                out[name + "_lists"] = rows
            else:
                fmt_str = "<" + "".join(_PLY_TYPES[p[1]][0] for p in props)
                row_sz = struct.calcsize(fmt_str)
                vals = np.array(
                    [
                        struct.unpack_from(fmt_str, body, offset + i * row_sz)
                        for i in range(count)
                    ],
                    dtype=np.float64,
                )
                offset += row_sz * count
                out[name] = (vals, [p[0] for p in props])
    else:
        raise ValueError(f"unsupported PLY format {fmt}")

    result: dict = {}
    if "vertex" in out:
        vals, names = out["vertex"]
        col = {n: vals[:, i] for i, n in enumerate(names)}
        result["verts"] = np.stack([col["x"], col["y"], col["z"]], -1).astype(
            np.float32
        )
        if "nx" in col:
            n = np.stack([col["nx"], col["ny"], col["nz"]], -1)
            norm = np.linalg.norm(n, axis=-1, keepdims=True)
            if np.any(norm > 1e-9):
                result["normals"] = (n / np.maximum(norm, 1e-9)).astype(np.float32)
        if "red" in col:
            result["colors"] = (
                np.stack([col["red"], col["green"], col["blue"]], -1) / 255.0
            ).astype(np.float32)
    if "face_lists" in out:
        tris = []
        for row in out["face_lists"]:
            for k in range(1, len(row) - 1):  # fan-triangulate
                tris.append([row[0], row[k], row[k + 1]])
        if tris:
            result["faces"] = np.array(tris, dtype=np.int32)
    return result


def _load_mtl_texture(mtl_path: str):
    """First ``map_Kd`` image of an .mtl file as (H, W, 3) float32 in
    [0, 1], or None. Texture paths are resolved relative to the .mtl."""
    tex_file = None
    try:
        with open(mtl_path, "r", errors="replace") as f:
            for line in f:
                parts = line.split()
                if parts and parts[0] == "map_Kd":
                    # options (-s, -o, ...) may precede the filename
                    tex_file = parts[-1]
                    break
    except OSError:
        return None
    if tex_file is None:
        return None
    import os

    cand = os.path.join(os.path.dirname(mtl_path), tex_file)
    if not os.path.exists(cand):
        cand = tex_file
    try:
        from PIL import Image

        img = np.asarray(Image.open(cand).convert("RGB"), np.float32)
        return img / 255.0
    except Exception:
        return None


def load_obj(path: str):
    """OBJ loader: v / vt / vn / f records; polygon faces fan-triangulated.

    Faces may index positions, UVs, and normals independently
    (``f v/vt/vn``, ``v//vn``, ``v/vt``); per-corner UVs come back as
    ``face_uvs`` (F, 3, 2) aligned with ``faces``. ``mtllib`` is followed
    and the material's ``map_Kd`` image returned as ``texture`` — the
    path real textured CAD models (YCB textured.obj) need
    (reference offscreen_renderer.py:53-69 carries the trimesh material).

    Vertex colors: supports the common 'v x y z r g b' extension.
    """
    import os

    verts, normals, colors, faces = [], [], [], []
    uvs, face_uv_idx, mtl_files = [], [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:
                    colors.append([float(x) for x in parts[4:7]])
            elif parts[0] == "vt":
                uvs.append([float(parts[1]),
                            float(parts[2]) if len(parts) > 2 else 0.0])
            elif parts[0] == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif parts[0] == "mtllib":
                mtl_files.append(" ".join(parts[1:]))
            elif parts[0] == "f":
                sub = [p.split("/") for p in parts[1:]]
                idx = [int(s[0]) - 1 for s in sub]
                tix = [int(s[1]) - 1 if len(s) > 1 and s[1] else -1
                       for s in sub]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
                    face_uv_idx.append([tix[0], tix[k], tix[k + 1]])
    result = {"verts": np.array(verts, np.float32)}
    if faces:
        result["faces"] = np.array(faces, np.int32)
    if colors and len(colors) == len(verts):
        result["colors"] = np.array(colors, np.float32)
    if normals and len(normals) == len(verts):
        result["normals"] = np.array(normals, np.float32)
    fuv = np.array(face_uv_idx, np.int64) if face_uv_idx else None
    if uvs and fuv is not None and (fuv >= 0).all():
        uv_table = np.array(uvs, np.float32)
        result["face_uvs"] = uv_table[fuv]  # (F, 3, 2)
        for mtl in mtl_files:
            tex = _load_mtl_texture(
                os.path.join(os.path.dirname(path), mtl))
            if tex is not None:
                result["texture"] = tex
                break
    return result


def save_obj(tm: TriMesh, path: str) -> None:
    """Write a TriMesh as OBJ — the inverse of :func:`load_obj`.

    Vertex colors ride the common ``v x y z r g b`` extension; textured
    meshes additionally emit one ``vt`` per face corner (OBJ indexes UVs
    independently of positions, so per-corner tables map 1:1), an
    ``.mtl`` with ``map_Kd``, and the texture as a PNG next to the OBJ.
    Gives procedural assets a disk form both this framework's CLIs
    (``--model_path``) and the reference's trimesh-based tools can read.
    Round-trip render equality is pinned in tests/test_texture.py."""
    import os

    base = os.path.splitext(path)[0]
    F = tm.num_faces
    textured = tm.texture is not None and tm.face_uvs is not None
    lines = []
    if textured:
        mtl_path = base + ".mtl"
        tex_name = os.path.basename(base) + "_kd.png"
        lines.append(f"mtllib {os.path.basename(mtl_path)}")
    for v, c in zip(tm.verts, tm.colors):
        lines.append("v %.8f %.8f %.8f %.5f %.5f %.5f"
                     % (v[0], v[1], v[2], c[0], c[1], c[2]))
    for n in tm.normals:
        lines.append("vn %.6f %.6f %.6f" % (n[0], n[1], n[2]))
    if textured:
        for fu in np.asarray(tm.face_uvs[:F], np.float32).reshape(-1, 2):
            lines.append("vt %.6f %.6f" % (fu[0], fu[1]))
        lines.append("usemtl material_0")
        for i, fc in enumerate(tm.faces[:F]):
            t = 3 * i
            lines.append(
                "f %d/%d/%d %d/%d/%d %d/%d/%d"
                % (fc[0] + 1, t + 1, fc[0] + 1, fc[1] + 1, t + 2,
                   fc[1] + 1, fc[2] + 1, t + 3, fc[2] + 1))
    else:
        for fc in tm.faces[:F]:
            lines.append("f %d//%d %d//%d %d//%d"
                         % (fc[0] + 1, fc[0] + 1, fc[1] + 1, fc[1] + 1,
                            fc[2] + 1, fc[2] + 1))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    if textured:
        from PIL import Image

        Image.fromarray(
            np.clip(np.asarray(tm.texture) * 255.0 + 0.5, 0,
                    255).astype(np.uint8)
        ).save(os.path.join(os.path.dirname(path) or ".", tex_name))
        with open(mtl_path, "w") as f:
            f.write("newmtl material_0\nKd 1.0 1.0 1.0\n"
                    f"map_Kd {tex_name}\n")


# ---------------------------------------------------------------------------
# Geometry utilities
# ---------------------------------------------------------------------------

def bake_texture_to_colors(verts: np.ndarray, faces: np.ndarray,
                           face_uvs: np.ndarray,
                           texture: np.ndarray) -> np.ndarray:
    """(V, 3) per-vertex albedo from a texture: each vertex averages the
    texels its face corners sample. Lossy (texture detail below vertex
    density is gone) — used when a textured mesh must be DECIMATED for
    rendering speed and the per-corner UV pipeline no longer applies
    (decimate() merges vertices across UV seams). Pass REAL faces only."""
    faces = np.asarray(faces, np.int64)
    th, tw = texture.shape[:2]
    u = np.asarray(face_uvs, np.float64)[..., 0] % 1.0
    v = np.asarray(face_uvs, np.float64)[..., 1] % 1.0
    x = np.clip(np.round(u * (tw - 1)).astype(np.int64), 0, tw - 1)
    y = np.clip(np.round((1.0 - v) * (th - 1)).astype(np.int64), 0, th - 1)
    texel = texture[y, x]  # (F, 3, 3)
    cols = np.zeros((len(verts), 3), np.float64)
    cnt = np.zeros((len(verts), 1), np.float64)
    np.add.at(cols, faces.reshape(-1), texel.reshape(-1, 3))
    np.add.at(cnt, faces.reshape(-1), 1.0)
    return (cols / np.maximum(cnt, 1.0)).astype(np.float32)


def compute_vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(verts)
    for k in range(3):
        np.add.at(normals, faces[:, k], fn)
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.maximum(norm, 1e-12)).astype(np.float32)


def voxel_down_sample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Centroid-per-voxel downsampling (open3d voxel_down_sample semantics,
    used at reference predict.py:131-133 with voxel=0.005)."""
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    n = inv.max() + 1
    sums = np.zeros((n, 3), np.float64)
    counts = np.zeros((n, 1), np.float64)
    np.add.at(sums, inv, points)
    np.add.at(counts, inv, 1.0)
    return (sums / counts).astype(np.float32)


def is_closed(verts: np.ndarray, faces: np.ndarray) -> bool:
    """True when the face set is a watertight ORIENTED surface: after
    welding coincident vertices (flat-shaded meshes duplicate vertices per
    face), every directed edge appears exactly once and its reverse also
    appears. Backfaces of such a mesh viewed from outside are always
    occluded by a front face along the ray, so backface culling is
    output-identical (render(..., cull_backfaces=True)). Pass the REAL
    faces only (``mesh.faces[:mesh.num_faces]``, padding is degenerate)."""
    f = np.asarray(faces, np.int64)
    if len(f) == 0:
        return False
    v = np.round(np.asarray(verts, np.float64) / 1e-7).astype(np.int64)
    _, weld = np.unique(v, axis=0, return_inverse=True)
    f = weld[f]
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    if np.any(e[:, 0] == e[:, 1]):  # degenerate edge
        return False
    key = (e[:, 0] << 32) | e[:, 1]
    rkey = (e[:, 1] << 32) | e[:, 0]
    key = np.sort(key)
    if np.any(key[1:] == key[:-1]):  # repeated directed edge
        return False
    return bool(np.array_equal(key, np.sort(rkey)))


def is_outward_oriented(verts: np.ndarray, faces: np.ndarray,
                        normals: np.ndarray) -> bool:
    """True when the per-vertex shading normals point OUTWARD on every
    non-degenerate face. Backface culling orients geometric normals by the
    stored shading normals (raster_kernels.backface_mask), so on a closed
    mesh whose file normals point inward (a common CAD/PLY export error)
    culling would keep the FAR surface — only auto-enable it when the
    winding-outward geometric normal (sign fixed by the mesh's signed
    volume) agrees with the shading normal everywhere."""
    v = np.asarray(verts, np.float64)[np.asarray(faces, np.int64)]
    if len(v) == 0:
        return False
    gn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    vol = np.einsum("fi,fi->", gn, v[:, 0]) / 6.0  # divergence theorem
    if vol == 0.0:
        return False
    gn_out = gn * np.sign(vol)
    n_avg = np.asarray(normals, np.float64)[np.asarray(faces, np.int64)]
    n_avg = n_avg.mean(axis=1)
    d = np.einsum("fi,fi->f", gn_out, n_avg)
    nz = (np.linalg.norm(gn, axis=-1) > 0) & (
        np.linalg.norm(n_avg, axis=-1) > 0)
    return bool(nz.any() and (d[nz] > 0).all())


def compute_cloud_diameter(points: np.ndarray) -> float:
    """Max pairwise distance via convex hull (reference Utils.py:101-105)."""
    pts = np.asarray(points, np.float64)
    try:
        from scipy.spatial import ConvexHull

        hull_pts = pts[ConvexHull(pts).vertices]
    except Exception:
        hull_pts = pts
    if len(hull_pts) > 4096:  # bound the quadratic pass
        idx = np.linspace(0, len(hull_pts) - 1, 4096).astype(int)
        hull_pts = hull_pts[idx]
    d2 = ((hull_pts[:, None, :] - hull_pts[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(d2.max()))


def compute_obj_max_width(points: np.ndarray) -> float:
    """Diameter in millimetres (reference Utils.py:450-451)."""
    return compute_cloud_diameter(points) * 1000.0


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit coords -> 30-bit Morton codes."""
    def split3(a):
        a = a.astype(np.uint64) & 0x3FF
        a = (a | (a << 16)) & np.uint64(0x30000FF)
        a = (a | (a << 8)) & np.uint64(0x300F00F)
        a = (a | (a << 4)) & np.uint64(0x30C30C3)
        a = (a | (a << 2)) & np.uint64(0x9249249)
        return a

    return split3(x[:, 0]) | (split3(x[:, 1]) << np.uint64(1)) | (
        split3(x[:, 2]) << np.uint64(2)
    )


def morton_order_faces(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Sort faces along a 3-D Morton curve of their centroids.

    Static per mesh. Keeps each FACE_BLOCK of triangles spatially compact so
    projected per-block screen bounds stay tight under any pose — the
    rasterizer skips (pixel-tile, face-block) pairs whose bounds miss.
    """
    return faces[morton_face_order(verts, faces)]


def morton_face_order(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """The Morton permutation itself — applied to ``faces`` AND to any
    per-face attribute table (face_uvs) so they stay aligned."""
    cen = verts[faces].mean(axis=1)
    lo, hi = cen.min(0), cen.max(0)
    q = ((cen - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(np.int64)
    return np.argsort(_morton3(q), kind="stable")


def build_trimesh(
    verts: np.ndarray,
    faces: np.ndarray,
    colors: np.ndarray | None = None,
    normals: np.ndarray | None = None,
    block: int | None = None,
    face_uvs: np.ndarray | None = None,
    texture: np.ndarray | None = None,
) -> TriMesh:
    """Pack loaded geometry into the rasterizer's static layout.

    ``block`` is the face-count padding granule, which also bounds the
    pass-1 kernel's face-block choice (raster_kernels.pick_face_block needs
    fb | F). Meshes past 512 real faces default to 1024-granule padding,
    the JAX package's choice (its TPU kernel is cheaper per (pixel, face)
    pair at 1024-face blocks, docs/KERNEL.md), so both packages pad a mesh
    alike. Tiny meshes keep the fine granule (padding a 12-face cube to
    1024 would be 4x wasted pass-1 work)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    if block is None:
        block = 1024 if len(faces) > 512 else FACE_BLOCK
    if colors is None:
        colors = np.full((len(verts), 3), 0.7, np.float32)
    if normals is None:
        normals = compute_vertex_normals(verts, faces)
    order = morton_face_order(verts, faces)
    faces = faces[order]
    if face_uvs is not None:
        face_uvs = np.asarray(face_uvs, np.float32)[order]
    num = len(faces)
    padded = ((num + block - 1) // block) * block
    if padded != num:
        # Degenerate faces (all three indices 0) never cover any pixel.
        pad = np.zeros((padded - num, 3), np.int32)
        faces = np.concatenate([faces, pad], 0)
        if face_uvs is not None:
            face_uvs = np.concatenate(
                [face_uvs, np.zeros((padded - num, 3, 2), np.float32)], 0)
    return TriMesh(
        verts=verts,
        faces=faces,
        colors=np.asarray(colors, np.float32),
        normals=np.asarray(normals, np.float32),
        num_faces=num,
        face_uvs=face_uvs,
        texture=None if texture is None else np.asarray(texture, np.float32),
    )


def load_mesh(path: str) -> TriMesh:
    """Load a PLY/OBJ file into a render-ready TriMesh."""
    if path.endswith(".ply"):
        d = load_ply(path)
    elif path.endswith(".obj"):
        d = load_obj(path)
    else:
        raise ValueError(f"unsupported mesh format: {path}")
    if "faces" not in d or len(d["faces"]) == 0:
        raise ValueError(
            f"{path} has no faces (point cloud?) — cannot rasterize. "
            "Use load_ply/load_obj directly for point data."
        )
    return build_trimesh(
        d["verts"], d["faces"], d.get("colors"), d.get("normals"),
        face_uvs=d.get("face_uvs"), texture=d.get("texture"),
    )


# ---------------------------------------------------------------------------
# Procedural meshes (tests, demos, synthetic data generation)
# ---------------------------------------------------------------------------

def make_box(size_xyz, color=(0.8, 0.2, 0.2), distinct_faces: bool = True,
             center=(0.0, 0.0, 0.0), _raw: bool = False) -> TriMesh:
    """Axis-aligned cuboid with per-face-correct normals (vertices
    duplicated per face). With ``distinct_faces`` each side gets its own
    hue so orientation is visually observable. ``size_xyz`` may be a
    scalar (cube) or an (sx, sy, sz) triple (anisotropic box — no
    rotational symmetry ambiguity along any axis)."""
    size_xyz = np.broadcast_to(np.asarray(size_xyz, np.float32), (3,))
    s = size_xyz / 2.0
    c = np.asarray(center, np.float32)
    corners = np.array(
        [[x, y, z] for x in (-s[0], s[0]) for y in (-s[1], s[1])
         for z in (-s[2], s[2])],
        np.float32,
    ) + c
    # 6 faces as corner-index quads (+x,-x,+y,-y,+z,-z), outward CCW.
    quads = [
        (4, 6, 7, 5), (0, 1, 3, 2),
        (2, 3, 7, 6), (0, 4, 5, 1),
        (1, 5, 7, 3), (0, 2, 6, 4),
    ]
    verts, faces, normals = [], [], []
    for q in quads:
        base = len(verts)
        pts = corners[list(q)]
        n = np.cross(pts[1] - pts[0], pts[2] - pts[0])
        n = n / np.linalg.norm(n)
        verts.extend(pts)
        normals.extend([n] * 4)
        faces.append([base, base + 1, base + 2])
        faces.append([base, base + 2, base + 3])
    verts = np.array(verts, np.float32)
    if distinct_faces:
        palette = np.array([
            [0.85, 0.25, 0.2], [0.2, 0.7, 0.3], [0.25, 0.35, 0.85],
            [0.9, 0.8, 0.2], [0.8, 0.3, 0.8], [0.25, 0.8, 0.8],
        ], np.float32)
        colors = np.repeat(palette, 4, axis=0)  # 4 verts per face
    else:
        colors = np.tile(np.array(color, np.float32), (len(verts), 1))
    if _raw:  # unpacked pieces for compound builders (make_lshape)
        return (verts, np.array(faces, np.int32), colors,
                np.array(normals, np.float32))
    return build_trimesh(verts, np.array(faces, np.int32), colors,
                         np.array(normals, np.float32))


def make_cube(size: float = 0.1, color=(0.8, 0.2, 0.2),
              distinct_faces: bool = True) -> TriMesh:
    """Cube: :func:`make_box` with one size (kept as the demos' and
    tests' historical entry point)."""
    return make_box(size, color=color, distinct_faces=distinct_faces)


def make_lshape(size: float = 0.09, thickness: float = 0.035) -> TriMesh:
    """L-shaped bracket: two cuboids sharing a corner — fully asymmetric
    geometry (no rotation axis leaves it invariant), so both depth and
    RGB observe every rotation component. A harder tracking target than
    the cube (thin arms, self-occlusion at grazing views)."""
    a = make_box((size, thickness, thickness),
                 center=(0.0, 0.0, 0.0), _raw=True)
    b = make_box((thickness, size - thickness, thickness),
                 center=(-(size - thickness) / 2.0,
                         (size) / 2.0, 0.0), _raw=True)
    verts = np.concatenate([a[0], b[0]])
    faces = np.concatenate([a[1], b[1] + len(a[0])])
    # shuffle the second arm's palette so the arms are distinguishable
    colors = np.concatenate([a[2], b[2][:, [1, 2, 0]]])
    normals = np.concatenate([a[3], b[3]])
    return build_trimesh(verts, faces, colors, normals)


def make_icosphere(subdiv: int = 3, radius: float = 0.05,
                   color=(0.2, 0.6, 0.9)) -> TriMesh:
    """Icosphere by midpoint subdivision (subdiv=3 -> 1280 faces)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdiv):
        cache: dict = {}
        vlist = list(verts)

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = (verts[i] + verts[j]) / 2.0
                m /= np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(vlist)
        faces = np.array(new_faces, np.int64)

    normals = verts.astype(np.float32)
    verts = (verts * radius).astype(np.float32)
    # Procedural banded color so renders have gradient structure to learn.
    colors = np.stack(
        [
            0.5 + 0.5 * np.sin(normals[:, 0] * 6.0),
            0.5 + 0.5 * np.sin(normals[:, 1] * 6.0 + 1.0),
            0.5 + 0.5 * np.sin(normals[:, 2] * 6.0 + 2.0),
        ],
        -1,
    ).astype(np.float32)
    colors = 0.3 * np.array(color, np.float32) + 0.7 * colors
    return build_trimesh(verts, faces.astype(np.int32), colors, normals)


def make_cylinder(radius: float = 0.033, height: float = 0.12,
                  segments: int = 48, color=(0.75, 0.72, 0.68),
                  banded: bool = False) -> TriMesh:
    """Closed cylinder along +z. With a uniform ``color`` it is exactly
    rotationally symmetric about its axis — the ADD-S-matters regime the
    reference's bowl/cans embody (reference eval_ycb.py ADD vs ADI
    distinction): no observation can pin the axial rotation, so ADD is
    ill-posed while ADD-S stays meaningful. ``banded=True`` paints an
    angular band that breaks the symmetry (ablation control)."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ca, sa = np.cos(ang), np.sin(ang)
    h = height / 2.0
    # side wall: smooth normals (radial), two rings of verts
    ring_lo = np.stack([radius * ca, radius * sa, -h * np.ones_like(ca)], -1)
    ring_hi = np.stack([radius * ca, radius * sa, h * np.ones_like(ca)], -1)
    side_v = np.concatenate([ring_lo, ring_hi], 0).astype(np.float32)
    side_n = np.concatenate(
        [np.stack([ca, sa, np.zeros_like(ca)], -1)] * 2, 0
    ).astype(np.float32)
    side_f = []
    for i in range(segments):
        j = (i + 1) % segments
        side_f += [[i, j, segments + j], [i, segments + j, segments + i]]
    # caps: flat normals, separate verts (sharp edge)
    cap_v, cap_n, cap_f = [], [], []
    for z, nz in ((-h, -1.0), (h, 1.0)):
        center = len(cap_v)
        cap_v.append([0.0, 0.0, z])
        cap_n.append([0.0, 0.0, nz])
        for k in range(segments):
            cap_v.append([radius * ca[k], radius * sa[k], z])
            cap_n.append([0.0, 0.0, nz])
        for k in range(segments):
            a_i = center + 1 + k
            b_i = center + 1 + (k + 1) % segments
            tri = [center, a_i, b_i] if nz > 0 else [center, b_i, a_i]
            cap_f.append([2 * segments + t for t in tri])
    verts = np.concatenate([side_v, np.array(cap_v, np.float32)], 0)
    normals = np.concatenate([side_n, np.array(cap_n, np.float32)], 0)
    faces = np.array(side_f + cap_f, np.int32)
    colors = np.tile(np.array(color, np.float32), (len(verts), 1))
    if banded:
        theta = np.arctan2(verts[:, 1], verts[:, 0])
        band = (theta > 0.3) & (theta < 1.2)
        colors[band] = (0.2, 0.3, 0.8)
    return build_trimesh(verts, faces, colors, normals)


def make_plate(size=(0.12, 0.09, 0.006), color=(0.82, 0.8, 0.75)) -> TriMesh:
    """Thin uniform-color plate: near-degenerate depth extent along its
    normal and a 180-degree flip ambiguity when viewed face-on — a
    documented failure geometry, not a passing-grade object."""
    return make_box(size, color=color, distinct_faces=False)


def make_plain_sphere(subdiv: int = 2, radius: float = 0.045,
                      color=(0.6, 0.62, 0.65)) -> TriMesh:
    """Uniform-color icosphere: FULLY rotationally symmetric — every
    rotation is unobservable in both RGB and depth; only translation is
    trackable. ADD is ill-posed by construction, ADD-S is the honest
    metric (reference eval_ycb.py:102-118 ADD vs ADI split)."""
    t = make_icosphere(subdiv=subdiv, radius=radius)
    return TriMesh(
        verts=t.verts,
        faces=t.faces,
        colors=np.tile(np.array(color, np.float32), (len(t.verts), 1)),
        normals=t.normals,
        num_faces=t.num_faces,
    )


def make_textured_box(size_xyz=(0.11, 0.08, 0.055),
                      cell: int = 32) -> TriMesh:
    """UV-textured box: :func:`make_box` geometry with each side mapped
    onto its own cell of a 3x2 procedural texture atlas (checkerboards,
    stripes and dots at different scales/hues — sub-face detail that
    vertex colors cannot represent). The accuracy suite's textured
    object: exercises the UV pipeline end-to-end (train on textured
    renders -> track a textured video), the synthetic stand-in for a
    YCB ``textured.obj`` (the reference renders those through pyrender
    materials, reference offscreen_renderer.py:53-69).

    Vertex colors are also baked from the texture so decimation and the
    face-sharded SP path keep a (lossy) appearance fallback."""
    # raw (pre-Morton-reorder) geometry: face 2*i / 2*i+1 IS side i, so
    # UVs can be assigned per side before build_trimesh reorders both
    # tables together
    verts, faces, _, normals = make_box(size_xyz, distinct_faces=False,
                                        _raw=True)
    # --- 3x2 atlas: per-cell high-frequency patterns ------------------
    th, tw = 2 * cell, 3 * cell
    tex = np.zeros((th, tw, 3), np.float32)
    yy, xx = np.mgrid[0:cell, 0:cell]
    checker = ((yy // 4 + xx // 4) % 2).astype(np.float32)[..., None]
    fine = ((yy // 2 + xx // 2) % 2).astype(np.float32)[..., None]
    diag = (((yy + xx) // 5) % 2).astype(np.float32)[..., None]
    horiz = ((yy // 5) % 2).astype(np.float32)[..., None]
    dots = ((np.hypot(yy % 8 - 3.5, xx % 8 - 3.5) < 2.5)
            .astype(np.float32)[..., None])
    cells = [
        checker * [0.9, 0.15, 0.1] + (1 - checker) * [0.95, 0.9, 0.85],
        diag * [0.1, 0.6, 0.2] + (1 - diag) * [0.1, 0.15, 0.1],
        fine * [0.15, 0.25, 0.9] + (1 - fine) * [0.9, 0.85, 0.2],
        dots * [0.8, 0.15, 0.7] + (1 - dots) * [0.95, 0.95, 0.9],
        horiz * [0.95, 0.55, 0.1] + (1 - horiz) * [0.1, 0.1, 0.1],
        checker * [0.1, 0.8, 0.8] + (1 - checker) * [0.15, 0.2, 0.25],
    ]
    for i, c in enumerate(cells):
        r, q = divmod(i, 3)
        tex[r * cell:(r + 1) * cell, q * cell:(q + 1) * cell] = c
    # --- per-corner UVs: face i -> atlas cell i (inset against bleed) --
    # make_box emits 2 triangles per side as (0,1,2) and (0,2,3) of each
    # quad; map quad corners to the cell rectangle in OBJ convention
    # (v origin bottom-left — _sample_texture flips, so cells land
    # exactly regardless of orientation).
    m = 0.04  # margin in cell-normalized units
    F = 12  # real faces (before padding — build_trimesh pads after)
    face_uvs = np.zeros((F, 3, 2), np.float32)
    for side in range(6):
        r, q = divmod(side, 3)
        u0, u1 = (q + m) / 3.0, (q + 1 - m) / 3.0
        # OBJ v: bottom-left origin; atlas row 0 is the TOP of the image
        v1, v0 = 1.0 - (r + m) / 2.0, 1.0 - (r + 1 - m) / 2.0
        quad = np.array([[u0, v0], [u1, v0], [u1, v1], [u0, v1]],
                        np.float32)
        face_uvs[2 * side] = quad[[0, 1, 2]]
        face_uvs[2 * side + 1] = quad[[0, 2, 3]]
    colors = bake_texture_to_colors(verts, faces, face_uvs, tex)
    return build_trimesh(verts, faces, colors, normals,
                         face_uvs=face_uvs, texture=tex)


def decimate(verts: np.ndarray, faces: np.ndarray, colors: np.ndarray | None,
             target_faces: int, iters: int = 8,
             face_uvs: np.ndarray | None = None):
    """Vertex-clustering decimation to approximately ``target_faces``.

    Production CAD scans often carry 10-100x more triangles than a
    176x176 ROI can resolve; rasterization cost is linear in face count,
    so decimation is the single biggest tracking-throughput lever. Grid
    resolution is bisected until the face count lands near the target.

    Returns (verts, faces, colors) with degenerate faces removed — or
    (verts, faces, colors, face_uvs) when ``face_uvs`` is given. UVs are
    PER-CORNER (aligned with faces, (F,3,2)): each surviving face keeps
    its OWN affine UV chart, re-evaluated at the new corner positions
    (corners move to cluster centroids, so the original corner UVs would
    paint the original small triangle's texture across the whole merged
    face — the chart must be extrapolated, not copied). Using only the
    face's own chart means texture seams need no special casing: a seam
    is just two faces whose shared geometric corner carries different
    UVs, true before and after clustering. On locally-flat surfaces the
    extrapolation is exact; elsewhere the UV error is the same order as
    the geometric error — unlike baking the texture to vertex colors,
    which destroys all sub-face detail.
    """
    verts = np.asarray(verts, np.float64)
    lo, hi = verts.min(0), verts.max(0)
    extent = float(np.max(hi - lo))
    if len(faces) <= target_faces:
        out = (verts.astype(np.float32), faces.astype(np.int32),
               None if colors is None else np.asarray(colors, np.float32))
        if face_uvs is not None:
            return out + (np.asarray(face_uvs, np.float32),)
        return out

    def cluster(cell):
        keys = np.floor((verts - lo) / cell).astype(np.int64)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        n = len(uniq)
        sums = np.zeros((n, 3))
        cnt = np.zeros((n, 1))
        np.add.at(sums, inv, verts)
        np.add.at(cnt, inv, 1.0)
        new_verts = sums / cnt
        new_faces = inv[faces]
        keep = (
            (new_faces[:, 0] != new_faces[:, 1])
            & (new_faces[:, 1] != new_faces[:, 2])
            & (new_faces[:, 0] != new_faces[:, 2])
        )
        new_faces = new_faces[keep]
        new_colors = None
        if colors is not None:
            csum = np.zeros((n, colors.shape[1]))
            np.add.at(csum, inv, np.asarray(colors, np.float64))
            new_colors = csum / cnt
        new_uvs = None
        if face_uvs is not None:
            # Re-evaluate each kept face's affine UV chart at its new
            # corners: solve q - p0 = a*e1 + b*e2 (least squares onto
            # the original face plane), uv(q) = uv0 + a*du1 + b*du2.
            uv0 = np.asarray(face_uvs, np.float64)[keep]
            orig = verts[faces[keep]]              # (Fk, 3, 3)
            newc = new_verts[new_faces]            # (Fk, 3, 3)
            e1 = orig[:, 1] - orig[:, 0]
            e2 = orig[:, 2] - orig[:, 0]
            du1 = uv0[:, 1] - uv0[:, 0]
            du2 = uv0[:, 2] - uv0[:, 0]
            d = newc - orig[:, 0:1]
            g11 = (e1 * e1).sum(-1)
            g12 = (e1 * e2).sum(-1)
            g22 = (e2 * e2).sum(-1)
            det = np.maximum(g11 * g22 - g12 * g12, 1e-18)
            r1 = np.einsum("fkc,fc->fk", d, e1)
            r2 = np.einsum("fkc,fc->fk", d, e2)
            a = (g22[:, None] * r1 - g12[:, None] * r2) / det[:, None]
            b = (g11[:, None] * r2 - g12[:, None] * r1) / det[:, None]
            new_uvs = (uv0[:, 0:1]
                       + a[..., None] * du1[:, None, :]
                       + b[..., None] * du2[:, None, :]).astype(np.float32)
        return new_verts, new_faces, new_colors, new_uvs

    lo_cell, hi_cell = extent / 512.0, extent / 2.0
    best = None
    for _ in range(iters):
        cell = np.sqrt(lo_cell * hi_cell)  # geometric bisection
        v, f, c, fu = cluster(cell)
        if best is None or abs(len(f) - target_faces) < abs(len(best[1]) - target_faces):
            best = (v, f, c, fu)
        if len(f) > target_faces:
            lo_cell = cell  # need coarser grid
        else:
            hi_cell = cell
    v, f, c, fu = best
    out = (v.astype(np.float32), f.astype(np.int32),
           None if c is None else c.astype(np.float32))
    if face_uvs is not None:
        return out + (fu,)
    return out
