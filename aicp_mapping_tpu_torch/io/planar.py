"""Planar-scan CSV IO, numpy port of `aicp_mapping_tpu.io.planar`.

2D laser scans as "x , y" lines (the reference's savePlanarCloudCSV
format), their reader, the lift to z = 0 clouds for the 2D-testing ICP
chain, and the synthetic room scan behind the shipped data/scan_*.csv,
which gives the JAX package's bits for the same seed.
"""
from __future__ import annotations

import numpy as np


def read_planar_csv(path: str) -> np.ndarray:
    """Read an "x , y" CSV planar scan -> (N, 2) float32."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = [p.strip() for p in line.replace(",", " ").split()]
            if len(parts) >= 2:
                rows.append((float(parts[0]), float(parts[1])))
    return np.asarray(rows, np.float32).reshape(-1, 2)


def write_planar_csv(path: str, points: np.ndarray) -> None:
    """Write (N, 2) or (N, 3) points as "x , y" lines
    (cloudIO.cpp:3-51 output format — z is dropped)."""
    pts = np.asarray(points, np.float32)
    with open(path, "w") as f:
        for x, y in pts[:, :2]:
            f.write(f"{x:g} , {y:g}\n")


def planar_to_cloud(points_2d: np.ndarray) -> np.ndarray:
    """Lift a planar scan to (N, 3) with z = 0 so the 3D pipeline
    (2D-testing chain, configs/icp/icp_2d_testing.yaml) can consume it."""
    pts = np.asarray(points_2d, np.float32)
    return np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], axis=1)


def synthetic_room_scan(pose_xytheta=(0.0, 0.0, 0.0), n_beams: int = 720,
                        room: float = 8.0, max_range: float = 12.0,
                        noise: float = 0.0, seed: int = 0) -> np.ndarray:
    """Simulate a 2D lidar scan of a square room with a center pillar —
    the generator behind the shipped data/scan_*.csv planar-scan assets
    (role of aicp_core/data/scan_00..02.csv). Returns (N, 2) hit points in
    the sensor frame.
    """
    x0, y0, theta = pose_xytheta
    rng = np.random.default_rng(seed)
    angles = theta + np.linspace(0, 2 * np.pi, n_beams, endpoint=False)
    dx, dy = np.cos(angles), np.sin(angles)
    half = room / 2.0

    # ray vs. the 4 walls of [-half, half]^2
    with np.errstate(divide="ignore"):
        tx = np.where(dx > 0, (half - x0) / dx,
                      np.where(dx < 0, (-half - x0) / dx, np.inf))
        ty = np.where(dy > 0, (half - y0) / dy,
                      np.where(dy < 0, (-half - y0) / dy, np.inf))
    t = np.minimum(tx, ty)

    # ray vs. a 0.5 m-radius pillar at (1.5, -1.0)
    cx, cy, r = 1.5, -1.0, 0.5
    ox, oy = x0 - cx, y0 - cy
    b = ox * dx + oy * dy
    c = ox * ox + oy * oy - r * r
    disc = b * b - c
    t_circ = np.where(disc >= 0, -b - np.sqrt(np.maximum(disc, 0)), np.inf)
    t_circ = np.where(t_circ > 0, t_circ, np.inf)
    t = np.minimum(t, t_circ)

    keep = t < max_range
    t = t[keep]
    if noise > 0:
        t = t + rng.normal(0, noise, t.shape)
    hits_world = np.stack([x0 + t * dx[keep], y0 + t * dy[keep]], axis=1)
    # back into the sensor frame (scan files are sensor-frame like the
    # reference's assets)
    rel = hits_world - np.array([x0, y0])
    ct, st = np.cos(-theta), np.sin(-theta)
    rot = np.array([[ct, -st], [st, ct]], np.float64)
    return (rel @ rot.T).astype(np.float32)
