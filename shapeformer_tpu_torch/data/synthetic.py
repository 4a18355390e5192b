"""Synthetic partial clouds: superellipsoid surfaces cut by a half-space.

Own copy of the superellipsoid family of shapeformer_tpu/data/synthetic.py
(random_shape_occupancy's part draws).  The surface is sampled by radial
projection instead of meshing an occupancy grid, so no mesher is needed.
All randomness comes from the numpy Generator the caller passes.
"""
from __future__ import annotations

import numpy as np


def superellipsoid_occupancy(coords, center, radii, power, rot=None):
    """Inside-test of |x/a|^p + |y/b|^p + |z/c|^p <= 1 at given coords."""
    p = coords - center
    if rot is not None:
        p = p @ rot.T
    t = np.abs(p / radii) ** power
    return t.sum(axis=-1) <= 1.0


def random_superellipsoid(rng: np.random.Generator):
    """(center, radii, power, rot) drawn like one part of
    random_shape_occupancy: the shape stays inside [-0.9, 0.9]^3."""
    center = rng.uniform(-0.35, 0.35, 3)
    radii = rng.uniform(0.15, 0.55, 3)
    power = rng.choice([2.0, 4.0, 8.0])
    theta = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    return center, radii, power, rot


def superellipsoid_surface(n: int, center, radii, power, rot,
                           rng: np.random.Generator) -> np.ndarray:
    """(n, 3) points on the surface: random directions pushed out to where
    sum |x_i / a_i|^p = 1."""
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = (np.abs(u / radii) ** power).sum(axis=1) ** (-1.0 / power)
    return (r[:, None] * u) @ rot + center


def partial_cloud(rng: np.random.Generator, n_points: int = 16384
                  ) -> np.ndarray:
    """(n_points, 3) float32 partial scan in [-1, 1]: one random
    superellipsoid's surface, keeping the side of a random plane through
    (near) its centre."""
    center, radii, power, rot = random_superellipsoid(rng)
    normal = rng.normal(size=3)
    normal /= np.linalg.norm(normal)
    offset = rng.uniform(-0.1, 0.1) * radii.min()
    kept = []
    total = 0
    while total < n_points:
        pts = superellipsoid_surface(2 * n_points, center, radii, power, rot,
                                     rng)
        pts = pts[(pts - center) @ normal > offset]
        kept.append(pts)
        total += len(pts)
    return np.concatenate(kept)[:n_points].astype(np.float32)
