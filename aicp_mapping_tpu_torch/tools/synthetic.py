"""Synthetic point-cloud generators (numpy only): a copy of the room
generator of `aicp_mapping_tpu.tools.synthetic`, so the port's scripts make
the same scenes from the same seed on a machine without JAX.
"""
from __future__ import annotations

import numpy as np


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
