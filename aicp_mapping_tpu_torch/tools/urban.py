"""Outdoor-scale synthetic world + spinning-lidar simulator, a numpy copy of
`make_urban_world`, `_ray_box_t` and `velodyne_scan` from
`aicp_mapping_tpu.tools.urban` (which cannot be imported here: its package
imports JAX). An urban block world (ground plane + buildings) scanned by a
raycast spinning lidar: occlusion, range-dependent density and ground
dominance, as the SLAM accuracy regression drives it.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class UrbanWorld:
    boxes: np.ndarray  # (B, 6) [xmin ymin zmin xmax ymax zmax]
    extent: float      # half-size of the world square
    pitch: float       # street-centerline spacing (street grid period)


def make_urban_world(seed: int = 0, extent: float = 120.0,
                     pitch: float = 44.0, street: float = 14.0,
                     presence: float = 0.85) -> UrbanWorld:
    """City blocks on a grid. Street centerlines run along the lines
    x = -extent + i*pitch and y = -extent + j*pitch; building lots fill the
    cells between them (inset street/2 from each centerline), with random
    footprint jitter and height. Some lots are empty so the skyline is
    irregular."""
    rng = np.random.default_rng(seed)
    boxes = []
    k = int(np.floor(2 * extent / pitch))
    lot = pitch - street
    for i in range(k):
        for j in range(k):
            if rng.uniform() > presence:
                continue
            cx = -extent + (i + 0.5) * pitch
            cy = -extent + (j + 0.5) * pitch
            w = rng.uniform(0.55, 1.0) * lot
            d = rng.uniform(0.55, 1.0) * lot
            x0 = cx - w / 2 + rng.uniform(-2, 2)
            y0 = cy - d / 2 + rng.uniform(-2, 2)
            h = rng.uniform(5.0, 25.0)
            boxes.append([x0, y0, 0.0, x0 + w, y0 + d, h])
    return UrbanWorld(np.asarray(boxes, np.float32), extent, pitch)


def _ray_box_t(origins: np.ndarray, dirs: np.ndarray,
               boxes: np.ndarray) -> np.ndarray:
    """Slab test: first-hit parameter t for each (ray, box), inf if missed.

    origins (N, 3), dirs (N, 3) unit, boxes (B, 6) -> (N, B) float32.
    """
    inv = 1.0 / np.where(np.abs(dirs) < 1e-9, 1e-9, dirs)  # (N, 3)
    lo = boxes[None, :, :3]   # (1, B, 3)
    hi = boxes[None, :, 3:]   # (1, B, 3)
    t1 = (lo - origins[:, None, :]) * inv[:, None, :]
    t2 = (hi - origins[:, None, :]) * inv[:, None, :]
    t_enter = np.max(np.minimum(t1, t2), axis=2)
    t_exit = np.min(np.maximum(t1, t2), axis=2)
    # require an outside->in hit (t_enter > 0): rays starting inside a box
    # (a mis-placed sensor) produce no surface return
    hit = (t_enter <= t_exit) & (t_enter > 1e-3)
    t = np.where(hit, t_enter, np.inf)
    return t.astype(np.float32)


def velodyne_scan(world: UrbanWorld, T_sensor: np.ndarray,
                  n_beams: int = 64, n_azimuth: int = 1024,
                  min_range: float = 2.5, max_range: float = 70.0,
                  elev_min_deg: float = -24.8, elev_max_deg: float = 2.0,
                  noise: float = 0.02, seed: int = 0,
                  sensor_height: float = 1.73) -> np.ndarray:
    """One full revolution of an HDL-64-style scanner at `T_sensor`
    (vehicle body pose; the sensor sits `sensor_height` above it, the KITTI
    mount height). Returns sensor-frame points (M, 3) float32."""
    rng = np.random.default_rng(seed)
    elev = np.deg2rad(np.linspace(elev_min_deg, elev_max_deg, n_beams))
    azim = np.linspace(-np.pi, np.pi, n_azimuth, endpoint=False)
    ce, se_ = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(azim), np.sin(azim)
    # (beams, azimuth, 3) sensor-frame directions
    dirs = np.stack([
        np.outer(ce, ca), np.outer(ce, sa),
        np.broadcast_to(se_[:, None], (n_beams, n_azimuth)),
    ], axis=-1).reshape(-1, 3).astype(np.float32)

    T = np.asarray(T_sensor, np.float64)
    R, t = T[:3, :3], T[:3, 3].copy()
    t[2] += sensor_height
    dirs_w = dirs @ R.T
    origins = np.broadcast_to(t, dirs_w.shape).astype(np.float64)

    # ground plane z = 0
    dz = dirs_w[:, 2]
    t_ground = np.where(dz < -1e-6, -t[2] / np.where(dz < -1e-6, dz, 1.0),
                        np.inf)
    # buildings
    t_boxes = _ray_box_t(origins.astype(np.float32),
                         dirs_w.astype(np.float32), world.boxes)
    t_hit = np.minimum(t_ground.astype(np.float32), np.min(t_boxes, axis=1))

    ok = (t_hit >= min_range) & (t_hit <= max_range)
    pts_w = origins[ok] + t_hit[ok, None].astype(np.float64) * dirs_w[ok]
    if noise > 0:
        pts_w = pts_w + rng.normal(0, noise, pts_w.shape)
    # back to the vehicle body frame (not the raised sensor frame)
    body = (pts_w - T[:3, 3]) @ R
    return body.astype(np.float32)
