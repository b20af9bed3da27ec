"""Triangle meshes on the host: loading, procedural shapes, decimation.

Counterpart of ``iros20_6d_pose_tracking_tpu/render/mesh.py``. That module
is numpy only (it imports neither jax nor anything that does), so the port
re-exports its functions instead of copying them: a :class:`TriMesh` built
here is the one the JAX package builds, and :func:`~.rasterizer.upload`
copies it to a torch device.
"""
from __future__ import annotations

from iros20_6d_pose_tracking_tpu.render.mesh import (  # noqa: F401
    TriMesh,
    bake_texture_to_colors,
    build_trimesh,
    compute_cloud_diameter,
    compute_obj_max_width,
    compute_vertex_normals,
    decimate,
    is_closed,
    is_outward_oriented,
    load_mesh,
    load_obj,
    load_ply,
    make_box,
    make_cube,
    make_cylinder,
    make_icosphere,
    make_lshape,
    make_plain_sphere,
    make_plate,
    make_textured_box,
    morton_face_order,
    morton_order_faces,
    save_obj,
    voxel_down_sample,
)
