"""Viewpoint sampling utilities (reference Utils.py:171-299,406-441).

Used by offline data generation to cover the view sphere:
  - ``hinter_sampling``: near-uniform view directions by recursive
    icosahedron subdivision (Hinterstoisser et al.; reference
    Utils.py:171-246).
  - ``sample_views``: camera poses looking at the origin from those
    directions within an elevation range (reference Utils.py:248-299).
  - ``random_view_matrix``: random look-at view with roll, radius in
    [min, max] (reference Utils.py:406-441).
"""
from __future__ import annotations

import math

import numpy as np


def hinter_sampling(min_n_pts: int, radius: float = 1.0):
    """Refine an icosahedron until >= min_n_pts vertices; returns
    (points (N, 3) on the sphere, per-point subdivision level)."""
    a, b, c = 0.0, 1.0, (1.0 + math.sqrt(5.0)) / 2.0
    pts = [
        (-b, c, a), (b, c, a), (-b, -c, a), (b, -c, a),
        (a, -b, c), (a, b, c), (a, -b, -c), (a, b, -c),
        (c, a, -b), (c, a, b), (-c, a, -b), (-c, a, b),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    levels = [0] * len(pts)
    level = 0
    while len(pts) < min_n_pts:
        level += 1
        cache: dict = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                pi, pj = pts[i], pts[j]
                pts.append(tuple((pi[k] + pj[k]) / 2.0 for k in range(3)))
                levels.append(level)
                cache[key] = len(pts) - 1
            return cache[key]

        new_faces = []
        for f0, f1, f2 in faces:
            m01, m12, m20 = midpoint(f0, f1), midpoint(f1, f2), midpoint(f2, f0)
            new_faces += [
                (f0, m01, m20), (f1, m12, m01), (f2, m20, m12), (m01, m12, m20)
            ]
        faces = new_faces

    out = np.array(pts, np.float64)
    out = out / np.linalg.norm(out, axis=1, keepdims=True) * radius
    return out, np.array(levels)


def look_at_rotation(eye: np.ndarray, center=None, up=(0.0, 0.0, 1.0)):
    """World->camera rotation for a camera at ``eye`` looking at ``center``
    (camera convention: x right, y down, z forward — CV)."""
    center = np.zeros(3) if center is None else np.asarray(center, np.float64)
    f = center - np.asarray(eye, np.float64)
    f = f / np.linalg.norm(f)
    up = np.asarray(up, np.float64)
    s = np.cross(f, up)
    if np.linalg.norm(s) < 1e-9:  # degenerate: view along up
        s = np.cross(f, np.array([1.0, 0.0, 0.0]))
    s = s / np.linalg.norm(s)
    d = np.cross(f, s)  # camera-down axis
    return np.stack([s, d, f], axis=0)


def sample_views(min_n_views: int, radius: float = 1.0,
                 elev_range=(-math.pi / 2, math.pi / 2)):
    """Camera poses on the view sphere looking at the origin (reference
    Utils.py:248-299 semantics: hinter sampling filtered by elevation).

    Returns a list of dicts {'R': world->cam 3x3, 't': 3x1} like the
    reference, plus the sampled points.
    """
    pts, _ = hinter_sampling(min_n_views, radius=radius)
    views = []
    kept = []
    for p in pts:
        elev = math.asin(np.clip(p[2] / radius, -1.0, 1.0))
        if not (elev_range[0] - 1e-9 <= elev <= elev_range[1] + 1e-9):
            continue
        R = look_at_rotation(p)
        t = (-R @ p.reshape(3, 1))
        views.append({"R": R, "t": t})
        kept.append(p)
    return views, np.array(kept)


def random_view_matrix(rng: np.random.RandomState, min_radius: float,
                       max_radius: float) -> np.ndarray:
    """Random look-at view matrix with random roll and distance
    (reference Utils.py:406-441)."""
    theta = rng.uniform(0, 2 * math.pi)
    phi = math.acos(2 * rng.uniform(0, 1) - 1)
    eye = np.array([
        math.sin(phi) * math.cos(theta),
        math.sin(phi) * math.sin(theta),
        math.cos(phi),
    ])
    eye *= rng.uniform(min_radius, max_radius)
    R = look_at_rotation(eye)
    roll = rng.uniform(0, 2 * math.pi)
    cr, sr = math.cos(roll), math.sin(roll)
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]], np.float64)
    view = np.eye(4)
    view[:3, :3] = Rz @ R
    view[:3, 3] = (Rz @ (-R @ eye.reshape(3, 1))).reshape(-1)
    return view
