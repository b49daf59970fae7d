"""Synthetic point-cloud generators (numpy only): copies of the cube, room
and corridor generators of `aicp_mapping_tpu.tools.synthetic`, so the
port's scripts make the same scenes from the same seed on a machine
without JAX. `cube_cloud` is the reference's validation target (an
axis-aligned cube sampled on its faces, create_cube_cloud.cpp).
"""
from __future__ import annotations

import numpy as np


def cube_cloud(n_per_face: int = 2000, size: float = 4.0, seed: int = 0,
               noise: float = 0.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h = size / 2.0
    faces = []
    for axis in range(3):
        for sign in (-h, h):
            uv = rng.uniform(-h, h, size=(n_per_face, 2))
            pts = np.zeros((n_per_face, 3), dtype=np.float32)
            others = [a for a in range(3) if a != axis]
            pts[:, others[0]] = uv[:, 0]
            pts[:, others[1]] = uv[:, 1]
            pts[:, axis] = sign
            faces.append(pts)
    cloud = np.concatenate(faces).astype(np.float32)
    if noise > 0:
        cloud = cloud + rng.normal(0, noise, cloud.shape).astype(np.float32)
    return cloud


def room_cloud(n: int = 8000, size: float = 10.0, seed: int = 0,
               noise: float = 0.0) -> np.ndarray:
    """Floor + 4 walls + one 45-degree ramp; constrains all 6 DoF."""
    rng = np.random.default_rng(seed)
    h = size / 2.0
    parts = []
    m = n // 6

    def plane(origin, u, v, extent_u, extent_v):
        a = rng.uniform(0, extent_u, (m, 1))
        b = rng.uniform(0, extent_v, (m, 1))
        return origin + a * np.asarray(u) + b * np.asarray(v)

    parts.append(plane([-h, -h, 0], [1, 0, 0], [0, 1, 0], size, size))  # floor
    parts.append(plane([-h, -h, 0], [1, 0, 0], [0, 0, 1], size, 3.0))    # y=-h
    parts.append(plane([-h, h, 0], [1, 0, 0], [0, 0, 1], size, 3.0))     # y=+h
    parts.append(plane([-h, -h, 0], [0, 1, 0], [0, 0, 1], size, 3.0))    # x=-h
    parts.append(plane([h, -h, 0], [0, 1, 0], [0, 0, 1], size, 3.0))     # x=+h
    s2 = 1.0 / np.sqrt(2.0)
    parts.append(plane([0, -h, 0], [0, 1, 0], [s2, 0, s2], size, 3.0))   # ramp
    cloud = np.concatenate(parts).astype(np.float32)
    if noise > 0:
        cloud = cloud + rng.normal(0, noise, cloud.shape).astype(np.float32)
    return cloud


def corridor_cloud(n: int = 6000, length: float = 20.0, width: float = 3.0,
                   seed: int = 0, noise: float = 0.0) -> np.ndarray:
    """Degenerate along x: two parallel walls (y = +/- w/2) and a floor."""
    rng = np.random.default_rng(seed)
    m = n // 3
    x = rng.uniform(-length / 2, length / 2, (m, 1))

    def strip(y, z_extent):
        z = rng.uniform(0, z_extent, (m, 1))
        return np.concatenate([x, np.full_like(x, y), z], axis=1)

    floor_y = rng.uniform(-width / 2, width / 2, (m, 1))
    floor = np.concatenate([x, floor_y, np.zeros_like(x)], axis=1)
    cloud = np.concatenate([
        strip(-width / 2, 2.5), strip(width / 2, 2.5), floor
    ]).astype(np.float32)
    if noise > 0:
        cloud = cloud + rng.normal(0, noise, cloud.shape).astype(np.float32)
    return cloud
